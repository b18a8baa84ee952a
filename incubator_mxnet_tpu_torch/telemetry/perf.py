"""Roofline/MFU attribution of the port's programs + device-memory
watermarks (the port of `incubator_mxnet_tpu/telemetry/perf.py`).

Both ride the registry's near-zero disabled path (every entry point
checks the module flag first and returns).

**What a program costs.**  The port has no XLA ``cost_analysis``: its
programs are `_graphs.Program` bodies of torch ops and hand-written
kernels.  `counting()` counts FLOPs and bytes on the host, from shapes,
while a body runs for real — the eager warm-up a `_graphs.Program`
makes before it captures its graph, or its first eager run on the CPU —
so a count adds no run and no sync:

* every aten op the body dispatches passes a ``TorchDispatchMode``:
  products and convolutions add their FLOPs (2·M·N·K a product, after
  ``torch.utils.flop_counter``'s formulas; 2 x the multiplies of a
  convolution whose input index falls inside the input, as XLA counts
  them — `_conv_flops` — and ``torch.utils.flop_counter``'s formulas for
  its backward); every op adds the bytes it reads and writes
  (`_op_bytes`);
* a hand-written kernel launched through ``ctypes`` is invisible to the
  dispatcher, so its wrapper adds its own analytic FLOPs and bytes
  (`add_kernel_cost`) where it launches — the counts behind the bound
  column of ``PERF.md``'s kernel table.

The count against XLA's: XLA counts every elementwise op, reduction and
transcendental as FLOPs; this count has products, convolutions and the
kernels' analytic FLOPs only (elementwise work is bytes here, which is
what bounds it).  XLA's bytes are per fused op after fusion; these are
per eager op, with no fusion and no cache: a view moves nothing, an
indexed read or write moves what it touches (`_op_bytes`), every other
op reads each input once and writes each output once.  The paged
attention kernel counts every block-table slot, because which ones are
live is data on the card.  XLA counts a ``while`` body once; here a
scope (`scope`) sums the count of every program run inside it, so a
decode of N tokens counts its N steps.

**Program time.**  A graph replay returns as soon as it is queued, so
host time around it is dispatch time, and an MFU computed from it can
read above 1.  On the card each run is timed by a pair of CUDA events
recorded on its stream around it (a replay or an eager body).  That
pair also counts any time the stream waits for the host to launch the
replay (on an idle stream, or one whose queued work ends before the
launch does), so a replay is timed by the pair its graph records at the
start and the end of its work (captured as event-record nodes) when that
pair is read before the graph replays again; the stream's pair times it
only when the graph was replayed again first.  The pairs are resolved lazily: `resolve()` — run at every later run, at ``telemetry.dump()``,
at ``/metrics`` and ``/varz`` — asks each pair ``Event.query()`` and
never waits.  On the CPU, which is synchronous, host time stands.  A
resolved run feeds ``program_device_seconds{program=}`` and, with its
count, ``program_mfu{program=}`` (FLOPs / seconds / peak),
``program_hbm_gbps{program=}`` and ``program_roofline_fraction{program=}``
(``max(flops/peak_flops, bytes/peak_bw)`` over the seconds).  The peaks
come from `PEAKS`, keyed by ``torch.cuda.get_device_name()``; on a
device it does not name (the CPU included) the MFU and roofline gauges
are left unset and ``/varz``'s ``perf`` section says so.

Program names: each `_graphs.Program` under its own name
(``serving_step``, ``decode_step``, ``fwd_record``, ``update`` ...), and
the calls that run them under the JAX package's names: a `scope` sums
the runs inside it (``decode_float``, ``serving_step_float``,
``trainer_step``).

**Device-memory watermarks.**  `sample_device_memory()` feeds
``device_bytes_in_use{device=}`` / ``device_peak_bytes{device=}`` from
the CUDA caching allocator's counters (``torch.cuda.memory_stats``:
``allocated_bytes.all.current`` / ``.peak``); on the CPU it returns
``{}`` (there is no allocator to read).  `start_poller()` runs the
sampler on a background thread.

THE NO-HOST-SYNC RULE applies throughout: host clocks, shapes and
dtypes, allocator counters and ``Event.query()`` only.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from . import registry as _registry_mod

__all__ = ["ProgramCost", "PEAKS", "counting", "add_kernel_cost",
           "capture", "start_run", "finish_run", "graph_events",
           "start_graph_run", "retire", "scope", "Scope",
           "open_scope", "current_scopes", "scopes_of",
           "resolve", "recent_timings", "programs", "roofline_table",
           "clear", "peaks", "varz_section", "sample_device_memory",
           "start_poller", "stop_poller"]

# device name (as torch.cuda.get_device_name gives it) -> dense bf16
# tensor-core FLOP/s and HBM bytes/s (NVIDIA's H100 SXM data sheet; the
# SXM card reports itself as "NVIDIA H100 80GB HBM3")
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "hbm": 3.35e12},
}


def _reg():
    from . import get_registry

    return get_registry()


def _gauge(name, labels=None):
    return _reg().gauge(name, labels)


class ProgramCost:
    """The count of one named program (FLOPs, bytes; its static input
    and output bytes) plus its latest timed run's attribution."""

    __slots__ = ("name", "flops", "bytes_accessed", "arg_bytes",
                 "out_bytes", "last_seconds", "last_mfu", "last_gbps",
                 "last_fraction")

    def __init__(self, name, flops=0.0, bytes_accessed=0.0, arg_bytes=0,
                 out_bytes=0):
        self.name = name
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        self.arg_bytes = int(arg_bytes)
        self.out_bytes = int(out_bytes)
        self.last_seconds = None
        self.last_mfu = None
        self.last_gbps = None
        self.last_fraction = None

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, flops per byte."""
        return self.flops / self.bytes_accessed if self.bytes_accessed \
            else math.inf

    @property
    def expected_bytes(self) -> int:
        """Static input + output bytes of one run."""
        return self.arg_bytes + self.out_bytes

    def bound_by(self) -> Optional[str]:
        """Roofline classification against the device's ridge point
        (None on a device without peaks)."""
        pk = peaks()
        if pk is None:
            return None
        return "compute" if self.intensity >= pk["flops"] / pk["hbm"] \
            else "memory"

    def as_dict(self) -> dict:
        return {
            "program": self.name,
            "flops": self.flops,
            "hbm_bytes": self.bytes_accessed,
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            "intensity": round(self.intensity, 3)
            if math.isfinite(self.intensity) else None,
            "bound_by": self.bound_by(),
            "seconds": self.last_seconds,
            "mfu": self.last_mfu,
            "hbm_gbps": self.last_gbps,
            "roofline_fraction": self.last_fraction,
        }


_programs: Dict[str, ProgramCost] = {}
_lock = threading.Lock()
_peaks_cache: Dict[str, Optional[dict]] = {}
# resolved runs for the merged profiler timeline (lock-free appends)
_timings: deque = deque(maxlen=4096)
# device-timed runs and closed scopes waiting for their events (a run
# pushed out of a full queue is dropped with NaN seconds, and so is
# every scope holding it)
_MAX_PENDING = 4096
_pending: deque = deque()
_pending_scopes: deque = deque(maxlen=1024)
_pending_lock = threading.Lock()
_tls = threading.local()            # .scopes: the thread's open scopes


# --------------------------------------------------------------------- #
# peaks
# --------------------------------------------------------------------- #
def peaks(device=None) -> Optional[Dict[str, float]]:
    """``{"flops", "hbm"}`` of the card (device 0 by default) from
    `PEAKS`, or None: the CPU, or a card the table does not name."""
    idx = 0 if device is None else (torch.device(device).index or 0)
    key = f"cuda:{idx}"
    if key not in _peaks_cache:
        pk = None
        if torch.cuda.is_available() and idx < torch.cuda.device_count():
            pk = PEAKS.get(torch.cuda.get_device_name(idx))
        _peaks_cache[key] = dict(pk) if pk else None
    return _peaks_cache[key]


def varz_section() -> dict:
    """``/varz``'s ``perf`` section: the device the program rates are
    taken against, its peaks, and why the MFU and roofline gauges are
    missing where they are."""
    if not torch.cuda.is_available():
        return {"device": "cpu", "peak_flops": None, "peak_hbm_bytes_per_s":
                None, "program_time": "host (the CPU is synchronous)",
                "note": "no peaks for the CPU: program_mfu and "
                        "program_roofline_fraction are not set"}
    name = torch.cuda.get_device_name(0)
    pk = peaks()
    out = {"device": name, "program_time": "CUDA events around each run",
           "peak_flops": pk and pk["flops"],
           "peak_hbm_bytes_per_s": pk and pk["hbm"]}
    if pk is None:
        out["note"] = (f"{name!r} is not in telemetry.perf.PEAKS: "
                       "program_mfu and program_roofline_fraction are "
                       "not set")
    return out


# --------------------------------------------------------------------- #
# counting FLOPs and bytes
# --------------------------------------------------------------------- #
class _Count:
    __slots__ = ("flops", "bytes")

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0


_n_counting = 0                     # counts open in the process


def _span_elems(t) -> int:
    """Elements a (possibly strided, broadcast) tensor occupies."""
    n = t.numel()
    if n == 0:
        return 0
    span = 1
    for s, st in zip(t.shape, t.stride()):
        if s > 1:
            if st < 0:
                return n
            span += (s - 1) * st
    return min(n, span)


def _tensors_of(x, out: list) -> None:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors_of(y, out)


def _nbytes(ts) -> int:
    seen, total = set(), 0
    for t in ts:
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
        if key in seen:
            continue
        seen.add(key)
        total += _span_elems(t) * t.element_size()
    return total


# reads of some rows of a table: what moves is the output and the index
_GATHERS = {"aten::embedding", "aten::index_select", "aten::index",
            "aten::gather", "aten::take"}
# writes of some rows in place: what moves is the values, read and
# written, and the index
_SCATTERS = {"aten::index_put_", "aten::_index_put_impl_",
             "aten::index_copy_", "aten::scatter_", "aten::scatter_add_",
             "aten::index_add_", "aten::masked_scatter_"}


def _op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves, counted unfused and uncached: a view or
    an allocation moves nothing; a gather its output (read, written)
    and index; an indexed in-place write its values (read, written)
    and index; ``copy_`` its source and destination; ``fill_`` and
    ``zero_`` their output; anything else each distinct input once and
    each output once."""
    schema = func._schema
    name = schema.name
    if name.startswith("aten::empty") or name in ("aten::detach",
                                                  "aten::lift_fresh"):
        return 0
    rets = schema.returns
    if rets and all(r.alias_info is not None and not r.alias_info.is_write
                    for r in rets):
        return 0                                # a view
    ins: list = []
    _tensors_of(list(args) + list(kwargs.values()), ins)
    outs: list = []
    _tensors_of(out, outs)
    if name in _GATHERS:
        return 2 * _nbytes(outs) + _nbytes(ins[1:])
    if name in _SCATTERS:
        rest = ins[1:]
        vals = rest[-1:] if rest else []
        return 2 * _nbytes(vals) + _nbytes(rest[:-1])
    if name == "aten::copy_":
        return _nbytes(ins[1:2]) + _nbytes(ins[:1])
    if name in ("aten::fill_", "aten::zero_"):
        return _nbytes(ins[:1])
    return _nbytes(ins) + _nbytes(outs)


def _taps(n_in, n_out, k, stride, pad, dil) -> int:
    """(output position, kernel tap) pairs of one dimension whose input
    index falls inside the input: what a convolution multiplies, the
    padding's zeros left out (as XLA counts)."""
    return sum(1 for o in range(n_out) for j in range(k)
               if 0 <= o * stride - pad + j * dil < n_in)


def _conv_flops(x, w, stride, padding, dilation, groups, out) -> float:
    """2 x the multiplies of a (non-transposed) convolution: batch x
    out-channels x in-channels a group x the in-bounds taps of each
    spatial dimension."""
    nd = w.dim() - 2
    taps = 1
    for d in range(nd):
        taps *= _taps(x.shape[2 + d], out.shape[2 + d], w.shape[2 + d],
                      stride[d % len(stride)], padding[d % len(padding)],
                      dilation[d % len(dilation)])
    return 2.0 * x.shape[0] * w.shape[0] * w.shape[1] * taps


def _op_flops(func, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry

    if func._overloadpacket in (torch.ops.aten.convolution,
                                torch.ops.aten._convolution) \
            and not args[6] and isinstance(args[4], (list, tuple)):
        x, w, _, stride, padding, dilation = args[:6]
        return _conv_flops(x, w, stride, padding, dilation, args[8], out)
    f = flop_registry.get(func._overloadpacket)
    if f is None:
        return 0.0
    return float(f(*args, **kwargs, out_val=out))


_mode_cls = None


def _count_mode():
    """A dispatch mode adding every op's FLOPs and bytes to the counts
    it holds (the class is made at first use: the dispatch machinery is
    not imported with the package)."""
    global _mode_cls
    if _mode_cls is None:
        from torch.utils._python_dispatch import TorchDispatchMode

        class _CountMode(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.counts: List[_Count] = []

            def __torch_dispatch__(self, func, types, args=(),
                                   kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if self.counts:
                    try:
                        f = _op_flops(func, args, kwargs, out)
                        b = _op_bytes(func, args, kwargs, out)
                    except Exception:
                        f = b = 0
                    for c in self.counts:
                        c.flops += f
                        c.bytes += b
                return out

        _mode_cls = _CountMode
    return _mode_cls


def _active_mode():
    """The count mode on this thread's dispatch stack (the autograd
    engine's worker threads inherit it from the thread that called
    backward), or None."""
    if _mode_cls is None:
        return None
    mode = getattr(_tls, "mode", None)
    if mode is not None:
        return mode
    try:
        from torch.utils._python_dispatch import \
            _get_current_dispatch_mode_stack

        for m in _get_current_dispatch_mode_stack():
            if isinstance(m, _mode_cls):
                return m
    except Exception:   # pragma: no cover — older dispatch internals
        pass
    return None


@contextlib.contextmanager
def counting():
    """Count the FLOPs and bytes of what runs inside on this thread (and
    in the backward it starts): yields a count with ``.flops`` and
    ``.bytes``.  Counts nest: an inner count also adds to the outer."""
    global _n_counting
    c = _Count()
    mode = getattr(_tls, "mode", None)
    if mode is not None:
        mode.counts.append(c)
        try:
            yield c
        finally:
            mode.counts.remove(c)
        return
    mode = _count_mode()()
    mode.counts.append(c)
    _tls.mode = mode
    _n_counting += 1
    try:
        with mode:
            yield c
    finally:
        _n_counting -= 1
        _tls.mode = None


def add_kernel_cost(flops: float, nbytes: float) -> None:
    """A hand-written kernel's analytic FLOPs and bytes, added by its
    wrapper where it launches (the dispatcher does not see a ``ctypes``
    launch).  One flag read while nothing counts."""
    if not _n_counting:
        return
    mode = _active_mode()
    if mode is not None:
        for c in mode.counts:
            c.flops += flops
            c.bytes += nbytes


def _record_cost(program: str, flops, nbytes, arg_bytes=0,
                 out_bytes=0) -> ProgramCost:
    pc = ProgramCost(program, flops=flops, bytes_accessed=nbytes,
                     arg_bytes=arg_bytes, out_bytes=out_bytes)
    with _lock:
        old = _programs.get(program)
        if old is not None:
            for k in ("last_seconds", "last_mfu", "last_gbps",
                      "last_fraction"):
                setattr(pc, k, getattr(old, k))
        _programs[program] = pc
    lab = {"program": program}
    _gauge("program_flops", lab).set(pc.flops)
    _gauge("program_hbm_bytes", lab).set(pc.bytes_accessed)
    _gauge("program_expected_bytes", lab).set(pc.expected_bytes)
    return pc


def capture(program: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once — the call the caller makes
    anyway — under `counting`, record its count as `programs()
    [program]` and the ``program_flops`` / ``program_hbm_bytes`` gauges,
    and return ``fn``'s result.  Disabled: just the call."""
    if not _registry_mod._enabled:
        return fn(*args, **kwargs)
    with counting() as c:
        out = fn(*args, **kwargs)
    _record_cost(program, c.flops, c.bytes)
    return out


# --------------------------------------------------------------------- #
# timed runs and scopes
# --------------------------------------------------------------------- #
class _Run:
    """One program run: its count and, once known, its seconds (from
    its stream's pair of events, or from its graph's own pair)."""

    __slots__ = ("program", "flops", "bytes", "t0", "e0", "e1", "graph",
                 "seconds")

    def __init__(self, program, t0, e0):
        self.program = program
        self.flops = self.bytes = None
        self.t0 = t0
        self.e0 = e0
        self.e1 = None
        self.graph = None
        self.seconds = None


class Scope:
    """The runs made on one thread while it is open, summed into one
    program record when they have all resolved: their FLOPs, bytes and
    device (or, on the CPU, host) seconds."""

    __slots__ = ("program", "runs", "open")

    _MAX_RUNS = 4096

    def __init__(self, program: str):
        self.program = program
        self.runs: List[_Run] = []
        self.open = True

    def _add(self, run: _Run) -> None:
        if len(self.runs) < self._MAX_RUNS:
            self.runs.append(run)

    def close(self) -> None:
        """Stop collecting; the record follows once every run's time is
        known (`resolve`)."""
        if not self.open:
            return
        self.open = False
        scopes = getattr(_tls, "scopes", None)
        if scopes and self in scopes:
            scopes.remove(self)
        if self.runs and len(self.runs) < self._MAX_RUNS:
            with _pending_lock:
                _pending_scopes.append(self)
            resolve()


def open_scope(program: str) -> Optional[Scope]:
    """Open a `Scope` on this thread (None while disabled)."""
    if not _registry_mod._enabled:
        return None
    sc = Scope(program)
    scopes = getattr(_tls, "scopes", None)
    if scopes is None:
        scopes = _tls.scopes = []
    scopes.append(sc)
    return sc


def current_scopes() -> tuple:
    """This thread's open scopes (a forward hands them to its backward,
    which the autograd engine may run on another thread)."""
    return tuple(getattr(_tls, "scopes", None) or ())


@contextlib.contextmanager
def scopes_of(scopes):
    """Let the runs inside also join ``scopes`` (`current_scopes` of the
    thread that recorded the forward whose backward runs here)."""
    prev = getattr(_tls, "scopes", None)
    _tls.scopes = list(prev or ()) + [sc for sc in scopes if sc.open
                                      and sc not in (prev or ())]
    try:
        yield
    finally:
        _tls.scopes = prev


@contextlib.contextmanager
def scope(program: str):
    """`open_scope` for the block inside, closed at its end."""
    sc = open_scope(program)
    try:
        yield sc
    finally:
        if sc is not None:
            sc.close()


def start_run(program: str, device) -> Optional[_Run]:
    """Mark the start of one run of ``program`` on ``device``: a CUDA
    event on the current stream on the card, the host clock elsewhere.
    None while disabled."""
    if not _registry_mod._enabled:
        return None
    t0 = time.perf_counter()
    e0 = None
    if torch.device(device).type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
    return _Run(program, t0, e0)


def finish_run(run: Optional[_Run], cost=None) -> None:
    """Mark the end of ``run`` (on the stream `start_run` recorded on);
    ``cost`` is its ``(flops, bytes)`` or None when uncounted.  The run
    joins this thread's open scopes and is noted when its time is
    known."""
    if run is None:
        return
    if run.e0 is None:
        run.seconds = time.perf_counter() - run.t0
    else:
        run.e1 = torch.cuda.Event(enable_timing=True)
        run.e1.record()
    _finish(run, cost)


def graph_events():
    """A pair of timing events for a graph to record at the start and
    the end of its work (captured as event-record nodes), or None where
    torch cannot capture one."""
    try:
        return tuple(torch.cuda.Event(enable_timing=True, external=True)
                     for _ in range(2))
    except TypeError:   # pragma: no cover — torch without external events
        return None


def start_graph_run(program: str, device, events) -> Optional[_Run]:
    """`start_run` for a replay of a graph that records ``events``
    (`graph_events`) at the start and the end of its work: the graph's
    own pair times the run if it is read before the graph replays again
    (`retire`); the stream's pair, which may hold the host's launch
    latency, only then."""
    run = start_run(program, device)
    if run is not None:
        run.graph = events
    return run


def retire(run: Optional[_Run]) -> None:
    """Before ``run``'s graph replays again: resolve it if it has
    completed; else its graph's events are about to be recorded again,
    and the stream's pair times it."""
    if run is None or run.seconds is not None:
        return
    resolve()
    run.graph = None


def _finish(run: _Run, cost) -> None:
    if cost is not None:
        run.flops, run.bytes = float(cost[0]), float(cost[1])
    for sc in getattr(_tls, "scopes", None) or ():
        sc._add(run)
    if run.seconds is not None:
        _note(run.program, run.seconds, run.flops, run.bytes, run.t0)
    else:
        with _pending_lock:
            if len(_pending) >= _MAX_PENDING:
                _pending.popleft().seconds = math.nan
            _pending.append(run)
    resolve()


def resolve() -> None:
    """Note every run whose end event has completed, oldest first, and
    every closed scope whose runs all have; never waits on the card."""
    done = []
    with _pending_lock:
        while _pending and _pending[0].e1.query():
            run = _pending.popleft()
            e0, e1 = run.graph if run.graph is not None \
                else (run.e0, run.e1)
            try:
                run.seconds = e0.elapsed_time(e1) / 1e3
            except RuntimeError:    # a pair the card could not time
                run.seconds = math.nan
                continue
            done.append(run)
    for run in done:
        _note(run.program, run.seconds, run.flops, run.bytes, run.t0)
    ready = []
    with _pending_lock:
        while _pending_scopes and all(r.seconds is not None
                                      for r in _pending_scopes[0].runs):
            ready.append(_pending_scopes.popleft())
    for sc in ready:
        secs = sum(r.seconds for r in sc.runs)
        if math.isnan(secs):
            continue
        flops = sum(r.flops or 0.0 for r in sc.runs)
        nbytes = sum(r.bytes or 0.0 for r in sc.runs)
        counted = any(r.flops is not None for r in sc.runs)
        _note(sc.program, secs, flops if counted else None, nbytes,
              sc.runs[0].t0)


def _note(program: str, seconds: float, flops, nbytes, t0: float) -> None:
    """One timed execution: the timeline event, the seconds histogram,
    and with a count the achieved-rate gauges (MFU and roofline only
    against known peaks)."""
    if not _registry_mod._enabled or not seconds > 0:      # NaN: dropped
        return
    _timings.append({"program": program, "t0": t0, "dur": seconds})
    lab = {"program": program}
    _reg().histogram("program_device_seconds", lab).observe(seconds)
    if flops is None:
        return
    with _lock:
        pc = _programs.get(program)
        if pc is None:
            pc = _programs[program] = ProgramCost(program)
    pc.flops, pc.bytes_accessed = float(flops), float(nbytes)
    _gauge("program_flops", lab).set(pc.flops)
    _gauge("program_hbm_bytes", lab).set(pc.bytes_accessed)
    gbps = pc.bytes_accessed / seconds / 1e9
    pc.last_seconds = seconds
    pc.last_gbps = gbps
    _gauge("program_hbm_gbps", lab).set(gbps)
    pk = peaks()
    if pk is None:
        return
    mfu = pc.flops / seconds / pk["flops"]
    frac = max(pc.flops / pk["flops"], pc.bytes_accessed / pk["hbm"]) \
        / seconds
    pc.last_mfu = mfu
    pc.last_fraction = frac
    _gauge("program_mfu", lab).set(mfu)
    _gauge("program_roofline_fraction", lab).set(frac)


def recent_timings(since: Optional[float] = None) -> List[dict]:
    """Recent resolved program runs (``{"program", "t0", "dur"}``,
    perf_counter seconds: the host launch time and the run's seconds),
    oldest first — the merged profiler timeline's program lane.
    ``since`` keeps only runs still in flight at/after that instant."""
    from .profiler import _snap_deque

    out = [dict(e) for e in _snap_deque(_timings)]
    if since is not None:
        out = [e for e in out if e["t0"] + e["dur"] >= since]
    return out


def programs() -> Dict[str, ProgramCost]:
    resolve()
    with _lock:
        return dict(_programs)


def roofline_table() -> List[dict]:
    """Per-program rows (name-sorted): flops, bytes, intensity, achieved
    MFU/GB/s/roofline fraction, bound-by."""
    resolve()
    with _lock:
        pcs = [_programs[k] for k in sorted(_programs)]
    return [pc.as_dict() for pc in pcs]


def clear() -> None:
    """Drop program records, pending runs and peak caches (tests)."""
    with _lock:
        _programs.clear()
    with _pending_lock:
        _pending.clear()
        _pending_scopes.clear()
    _timings.clear()
    _peaks_cache.clear()
    _tls.scopes = []
    with _mem_lock:
        _peak_bytes.clear()


# --------------------------------------------------------------------- #
# device-memory watermarks
# --------------------------------------------------------------------- #
_peak_bytes: Dict[str, int] = {}
_mem_lock = threading.Lock()
_poller = None


def sample_device_memory(devices=None) -> Dict[str, dict]:
    """One watermark sample per card, feeding the
    ``device_bytes_in_use{device=}`` / ``device_peak_bytes{device=}``
    gauges from the CUDA caching allocator's counters.  Returns
    ``{device: {"bytes_in_use", "peak_bytes", "source"}}``; empty when
    telemetry is disabled and on the CPU (no allocator to read)."""
    if not _registry_mod._enabled or not torch.cuda.is_available():
        return {}
    idxs = [torch.device(d).index or 0 for d in devices] \
        if devices is not None else range(torch.cuda.device_count())
    out: Dict[str, dict] = {}
    for i in idxs:
        stats = torch.cuda.memory_stats(i)
        cur = int(stats.get("allocated_bytes.all.current", 0))
        out[f"cuda:{i}"] = {
            "bytes_in_use": cur,
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", cur)),
            "source": "memory_stats"}
    with _mem_lock:
        for k, rec in out.items():
            peak = max(_peak_bytes.get(k, 0), rec["peak_bytes"],
                       rec["bytes_in_use"])
            _peak_bytes[k] = peak
            rec["peak_bytes"] = peak
    for k, rec in out.items():
        lab = {"device": k}
        _gauge("device_bytes_in_use", lab).set(rec["bytes_in_use"])
        _gauge("device_peak_bytes", lab).set(rec["peak_bytes"])
    return out


class _Poller:
    def __init__(self, interval: float):
        self.interval = max(0.05, float(interval))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="mxt-mem-watermark",
                                        daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                sample_device_memory()
                resolve()
            except Exception:
                pass  # a dying device must not kill the poller thread

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def start_poller(interval: float = 1.0) -> bool:
    """Start the background memory-watermark poller (idempotent).
    Returns False (and does nothing) while telemetry is disabled."""
    global _poller
    if not _registry_mod._enabled:
        return False
    if _poller is not None:
        return True
    _poller = _Poller(interval)
    _poller.start()
    return True


def stop_poller() -> None:
    global _poller
    if _poller is not None:
        _poller.stop()
        _poller = None
