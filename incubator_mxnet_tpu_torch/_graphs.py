"""Captured device programs: the port's counterpart of ``jax.jit`` with
``donate_argnums``.

The JAX package never dispatches its hot paths op by op: the serving
step, the prefill chunk, the speculative programs, ``generate``'s
prefill+scan and a hybridized block are each one compiled program with
static shapes.  Here each is a `Program`: a body over static device
buffers, captured once into a CUDA graph and replayed after that.

* The program owns static input buffers.  Host (numpy) inputs are staged
  into them through pinned host memory with ``non_blocking`` copies;
  tensor inputs are copied on the card.
* On CUDA the first call for a signature runs the body once on the
  pool's side stream (the warm-up, whose outputs are that call's
  result), then captures it with ``torch.cuda.graph(pool=...,
  capture_error_mode="thread_local")``: the serving engine captures on
  its scheduler thread while others call ``submit()``.  Every later call
  with the same signature replays the graph.  A capture that fails
  raises; nothing runs eagerly on the card in its place.  A
  ``replay_result`` program (a recorded forward, whose warm-up outputs
  carry an autograd graph and its activations) drops the warm-up's
  outputs before the capture, undoes what the warm-up wrote in place,
  and replays the graph for the call's result, so one copy of the
  activations lives at a time and the call writes its state once.
* A replay overwrites its outputs (JAX arrays are immutable, CUDA graph
  outputs are not): a caller clones what outlives the call.
* A body that draws seeds (`random.next_seed`, a dropout mask in train
  mode) reads them from the program's `random.SeedTable`: each run or
  replay draws them from the thread's key stream first, as the eager
  body would, and stages them with one copy, so every replay draws a
  fresh mask and ``random.seed`` replays the eager masks.
* On the CPU (the caller asked for it) and inside `eager()` the body runs
  eagerly on the same static buffers: the un-captured program, which is
  the reference a graph is held to bit for bit.
* Captures and replays are counted per program name, and each capture
  records the launches of the hand-written kernels its graph holds
  (`note_launch`): a kernel wrapper's ``launches`` counter ticks where
  the kernel runs, and a replay runs it without calling the wrapper,
  so `launches(fn)` adds replays x launches a replay.
* With telemetry enabled, each run (a replay, an eager body, a warm-up)
  is timed in `telemetry.perf` — on the card by a pair of CUDA events
  on its stream (or by the pair a graph captured while telemetry was
  enabled records around its work, which leaves out the replay's launch
  latency), by the host clock on the CPU — and the first body run of
  each program (its warm-up, or its first eager run) is counted there
  for FLOPs and bytes (`telemetry.perf.counting`).  Disabled, a run
  reads one flag.

The signature a caller passes (``sig``) names what the body reads
besides its inputs, such as the addresses of the weights it closes over:
a new signature recaptures.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from collections import Counter
from typing import Optional

import numpy as np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Program", "Pool", "eager", "in_body", "capturing",
           "note_launch", "launches",
           "captures", "replays", "replayed_launches", "reset_counts",
           "subscribe_captures", "unsubscribe_captures"]

# captures and replays per program name, and the kernel launches replays
# made (kernel wrapper -> count), since import or `reset_counts`
captures: Counter = Counter()
replays: Counter = Counter()
replayed_launches: Counter = Counter()

_local = threading.local()          # .tally (a capture's launches), .depth
_capture_lock = threading.Lock()    # one capture at a time in the process
_sinks: list = []
_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run every program's body eagerly, on every thread, while inside:
    the un-captured programs that the graphs are held to."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def in_body() -> bool:
    """Whether this thread is running a program's body (a warm-up, a
    capture or an eager run)."""
    return getattr(_local, "depth", 0) > 0


def capturing() -> bool:
    """Whether this thread is recording a program's body into a graph."""
    return getattr(_local, "tally", None) is not None


@contextlib.contextmanager
def _body_scope():
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1





def note_launch(fn) -> None:
    """Count one launch of ``fn``'s kernel: in ``fn.launches`` when the
    kernel runs now, in the capture's tally when it is being recorded
    into a graph (it runs at each replay instead)."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[fn] += 1
    else:
        fn.launches += 1


def launches(fn) -> int:
    """Launches of ``fn``'s kernel: direct ones and those inside graph
    replays."""
    return fn.launches + replayed_launches[fn]


def reset_counts() -> None:
    """Zero the capture, replay and replayed-launch counts."""
    captures.clear()
    replays.clear()
    replayed_launches.clear()


def _report_capture(name: str) -> None:
    """Count a capture of program ``name`` and tell the sinks."""
    captures[name] += 1
    for sink in list(_sinks):
        sink(name)


def subscribe_captures(sink) -> None:
    """Call ``sink(program_name)`` at every capture."""
    _sinks.append(sink)


def unsubscribe_captures(sink) -> None:
    try:
        _sinks.remove(sink)
    except ValueError:
        pass


class Pool:
    """The graph memory pool and the side stream that a family of
    programs captures into (one per `serving.PagedPrograms`, one per net
    for ``generate``/``beam_search``, one per hybridized block).  Its
    programs replay in turn on one stream, so they may share memory; the
    CUDA objects are made at the first capture."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._handle = None
        self._stream = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream


@contextlib.contextmanager
def _no_collection():
    """No cyclic garbage collection while a capture runs.  A program's
    body refers back to its owner (an engine's `PagedPrograms`, a
    ``generate`` program), so a dropped owner and its graphs are freed by
    the collector, which may run on the capturing thread at any Python
    allocation; destroying a graph there is illegal during a capture and
    invalidates it.  ``torch.cuda.graph`` collects just before it
    begins."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def put_back(tensors, fn):
    """``fn()``, then those of ``tensors`` that it wrote in place (their
    ``_version`` moved) put back as they were before it.  Returns
    ``fn``'s result and the list of tensors it wrote, which a caller
    watches alone from then on (the tensors a body writes besides its
    outputs: BatchNorm's running stats)."""
    with torch.no_grad():
        kept = [t.clone() for t in tensors]
    versions = [t._version for t in tensors]
    out = fn()
    moved = [i for i, (t, v) in enumerate(zip(tensors, versions))
             if t._version != v]
    written = [tensors[i] for i in moved]
    if written:
        with torch.no_grad():
            torch._foreach_copy_(written, [kept[i] for i in moved])
    return out, written


def _tensors(out):
    return [t for t in out if isinstance(t, torch.Tensor)]


class Program:
    """One static-shape device program: ``body(**static_inputs)`` returns
    a tuple of tensors.  ``run(sig, **inputs)`` stages the inputs and
    returns the outputs (the static ones after a replay: clone what
    outlives the call); ``last`` holds the latest run's outputs.

    ``static_out``: every call on CUDA returns the static outputs, also
    the call that captures (its warm-up's outputs are copied into them),
    so a caller may hold on to them as the program's output buffers (the
    recorded backward's gradients that the Trainer's update reads).

    ``replay_result``: None, or a callable giving the tensors besides
    its inputs and outputs that the body may write in place (BatchNorm's
    running stats).  Then the capturing call frees its warm-up's outputs
    before the capture, puts back what the warm-up wrote (`put_back`;
    the first capture watches every tensor the callable gives, a
    recapture only those the first found written), and returns the
    static outputs of a replay (a replay the counts see): the warm-up's
    activations never live beside the graph's, and the call writes the
    state once, as every replay does.

    ``seeds``: another program's `random.SeedTable`, which this one reads
    and never stages: its body draws the masks of that program's latest
    run (a rematerialising backward recomputing its forward)."""

    def __init__(self, name: str, body, pool: Pool,
                 static_out: bool = False, replay_result=None,
                 seeds: Optional[_random.SeedTable] = None):
        self.name = name
        self._body = body
        self._pool = pool
        self._static_out = static_out
        self._replay_result = replay_result
        self._written = None        # what the warm-up wrote in place
        self._static: Optional[dict] = None
        self._graph = None
        self._out = None
        self._sig = None
        self._stages_seeds = seeds is None
        self.seeds = _random.SeedTable(pool.device) if seeds is None \
            else seeds
        self.per_replay: dict = {}
        self.last = None
        # (flops, bytes) of one run, counted at the first body run while
        # telemetry is enabled (`_timed`); the timing events the graph
        # records (captured while telemetry is enabled) and its last
        # timed replay
        self.cost = None
        self._events = None
        self._last_run = None
        # held by a caller across a run and its use of the outputs when
        # other threads may run the same program
        self.lock = threading.Lock()

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def will_capture(self, sig) -> bool:
        """Whether `run` with ``sig`` would capture (run the body's
        warm-up, then record it)."""
        return (self._pool.device.type == "cuda" and not _eager_depth
                and (self._graph is None or sig != self._sig))

    @property
    def device(self) -> torch.device:
        return self._pool.device

    @property
    def pool(self) -> Pool:
        return self._pool

    @property
    def static_inputs(self) -> Optional[dict]:
        """The static input buffers by name (None before the first
        run)."""
        return self._static

    @property
    def captured_outputs(self):
        """The outputs of the captured body (its graph's static
        outputs), or None."""
        return self._out

    def _run_body(self):
        with _body_scope(), _random.seed_table(self.seeds):
            return self._body(**self._static)

    def _timed(self, fn, body: bool = True):
        """``fn()`` — a body run, or a replay when not ``body`` — noted in
        `telemetry.perf` while telemetry is enabled (a run inside another
        program's body is that program's): its time, and its FLOPs and
        bytes, counted at the program's first body run."""
        if not _tm_registry._enabled or in_body() or capturing():
            return fn()
        if not body and self._events is not None:
            # the graph records its own pair too, read before it replays
            # again
            _perf.retire(self._last_run)
            run = self._last_run = _perf.start_graph_run(
                self.name, self._pool.device, self._events)
        else:
            run = _perf.start_run(self.name, self._pool.device)
        if body and self.cost is None:
            with _perf.counting() as c:
                out = fn()
            self.cost = (c.flops, c.bytes)
            _perf._record_cost(
                self.name, c.flops, c.bytes,
                arg_bytes=sum(t.numel() * t.element_size()
                              for t in self._static.values()),
                out_bytes=sum(t.numel() * t.element_size()
                              for t in _tensors(out or ())))
        else:
            out = fn()
        _perf.finish_run(run, self.cost)
        return out

    @torch.no_grad()
    def _stage(self, inputs) -> None:
        # outside autograd: a static input the body marks as requiring a
        # gradient stays a leaf, detached from the caller's tensor
        dev = self._pool.device
        if self._static is None:
            self._static = {
                k: (torch.empty(v.shape, dtype=torch.from_numpy(
                    np.asarray(v)).dtype, device=dev)
                    if isinstance(v, np.ndarray)
                    else torch.empty(v.shape, dtype=v.dtype, device=dev))
                for k, v in inputs.items()}
        if inputs.keys() != self._static.keys():
            raise MXNetError(f"program {self.name!r} takes inputs "
                             f"{sorted(self._static)}, got {sorted(inputs)}")
        cuda = dev.type == "cuda"
        for k, v in inputs.items():
            dst = self._static[k]
            if tuple(v.shape) != tuple(dst.shape):
                raise MXNetError(
                    f"program {self.name!r}: input {k} has shape "
                    f"{tuple(v.shape)}, its static buffer {tuple(dst.shape)}")
            if isinstance(v, np.ndarray):
                src = torch.from_numpy(np.ascontiguousarray(v))
                if cuda:
                    dst.copy_(src.pin_memory(), non_blocking=True)
                else:
                    dst.copy_(src)
            else:
                dst.copy_(v)

    def run(self, sig=None, **inputs):
        """Stage ``inputs`` (numpy arrays or tensors of the first call's
        shapes) and run the program: eagerly on the CPU or inside
        `eager()`, else by replaying its graph (capturing it first when
        ``sig`` differs from the captured one)."""
        self._stage(inputs)
        if self._pool.device.type != "cuda" or _eager_depth:
            self._stage_seeds()
            self.last = self._timed(self._run_body)
            return self.last
        if self._graph is not None and sig == self._sig:
            self._stage_seeds()
            self._timed(self._replay, body=False)
            self.last = self._out
            return self._out
        self.last = self._capture(sig)
        return self.last

    def _stage_seeds(self) -> None:
        if self._stages_seeds:
            self.seeds.stage()

    def _replay(self) -> None:
        self._graph.replay()
        replays[self.name] += 1
        for fn, n in self.per_replay.items():
            replayed_launches[fn] += n

    def _capture(self, sig):
        with _capture_lock, _no_collection():
            self._graph = self._out = self._sig = None
            side = self._pool.stream()
            cur = torch.cuda.current_stream(self._pool.device)
            # this call's seeds (none before a body's first run, which
            # draws its own and counts them)
            self._stage_seeds()
            side.wait_stream(cur)
            # the warm-up: lazy initialisation (kernel libraries, cuBLAS
            # workspaces) on the capture stream, and this call's result;
            # or, for a `replay_result` program, nothing kept: its
            # outputs (and autograd graph) dropped, its writes put back
            with torch.cuda.stream(side):
                if self._replay_result is None:
                    out = self._timed(self._run_body)
                else:
                    out = ()
                    first = self._written is None
                    written = put_back(self._replay_result() if first
                                       else self._written,
                                       lambda: self._timed(
                                           self._run_body))[1]
                    if first:
                        self._written = written
            cur.wait_stream(side)
            for t in _tensors(out):
                t.record_stream(cur)
            graph = torch.cuda.CUDAGraph()
            tally = Counter()
            events = _perf.graph_events() if _tm_registry._enabled \
                else None
            _local.tally = tally
            try:
                with torch.cuda.graph(graph, pool=self._pool.handle(),
                                      stream=side,
                                      capture_error_mode="thread_local"):
                    if events is not None:
                        events[0].record()
                    static_out = self._run_body()
                    if events is not None:
                        events[1].record()
            except Exception as e:
                raise MXNetError(f"capturing program {self.name!r} failed: "
                                 f"{e}") from e
            finally:
                _local.tally = None
            self._graph, self._out, self._sig = graph, static_out, sig
            self.per_replay = dict(tally)
            self._events, self._last_run = events, None
        _report_capture(self.name)
        if self._replay_result is not None:
            self._timed(self._replay, body=False)
            return static_out
        if self._static_out:
            outs = _tensors(static_out)
            if outs:
                torch._foreach_copy_(outs, _tensors(out))
            return static_out
        return out


# last: the package's telemetry enables the capture feed of
# `retrace_guard`, which subscribes to this module
from .telemetry import perf as _perf  # noqa: E402
from .telemetry import registry as _tm_registry  # noqa: E402
