"""Continuous-batching serving engine with overload safety (PyTorch/CUDA
port of the scheduler core of `incubator_mxnet_tpu/serving/engine.py`,
float and int8 KV pools, float and int8 weights, speculative decoding).

`ServingEngine` runs an iteration-level (Orca-style) scheduler on a
background thread: each iteration retires finished sequences, evicts
timed-out or cancelled ones, admits queued requests, runs ONE
fixed-width prefill chunk for the oldest admitted-but-unprefilled
request, then ONE batched decode step for every live lane — so a long
prompt costs each resident sequence at most one chunk of extra latency
per token.  The KV cache is a paged pool (`kv_pool`, `programs`):
admission and eviction move block-table entries, never tensor shapes.

Admission is copy-on-write prefix-cached: the `BlockPool`
content-addresses full KV blocks by prefix-token hash, so a request
whose prompt shares a block-aligned prefix with earlier traffic binds
those blocks read-only and prefills only its uncached tail; its greedy
output is bit-identical to a cold prefill.

Speculative decoding (``speculate_k > 0``): each iteration a draft model
proposes k tokens per lane on its own pool, and ONE target forward
verifies every lane's window of k+1 positions; a lane emits its
accepted drafts plus one token of the target's (the correction at the
first rejection, or a bonus token).  Greedy output is the target's
argmax whatever the draft proposes, and sampled output keeps the
target's distribution (exact rejection sampling).  The draft pool
shares the target's block tables and block ids, so one admission
covers both, a prefix-cache hit finds the draft's K/V too, and
rollback is host-side position arithmetic.

The robustness envelope:

* **Bounded admission queue** — `submit(block=False)` (default) SHEDS
  when the queue is full (`RequestShed("queue_full")`); `block=True`
  waits with backpressure, observing close().
* **SLO-aware shedding** — with a ``ttft_budget``, a request whose
  estimated TTFT (queue wait so far + EWMA prefill time) already
  exceeds the budget is shed at admission instead of admitted late.
* **Deadlines** — a request past its deadline is shed while queued and
  EVICTED mid-batch while running; eviction frees its blocks and leaves
  every co-batched sequence bit-identical to an unperturbed run
  (docs/serving.md, "Why eviction is exact").
* **Cancellation** — `Request.cancel()` is non-blocking and safe from
  any thread; `Request.stream()` cancels in a ``finally`` so a caller
  abandoning the generator releases the KV blocks.
* **Clean shutdown** — `close()` stops and JOINS the scheduler thread;
  scheduler errors are parked and re-raised on the caller, and a failed
  engine refuses new work instead of hanging it.

Thread-safety: ONE lock (`self._lock`, shared by the `self._work`
condition and every request's condition) guards the queue, slots,
stats and pool accounting.  The scheduler thread is the only user of
the device pools, so device calls run outside the lock: each chunk and
step is stage (locked) → device call (unlocked) → commit (re-locked,
with a slot-identity check).

The JAX engine's telemetry, SLO tracker, HTTP endpoints, flight
recorder, stall profiler and ``varz_config`` are not part of this port
yet.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from ..ops.paged_attention import kernel_shape_problem
from .kv_pool import SCRATCH_BLOCK, BlockPool
from .programs import PagedPrograms

__all__ = ["ServingError", "RequestShed", "RequestTimedOut",
           "RequestCancelled", "RequestFailed", "Request", "ServingEngine",
           "default_engine"]

_POLL_S = 0.002
_MAX_QUEUE = 16
# prefill-chunk width in tokens: one chunk of at most this many prompt
# positions runs between consecutive decode steps
_PREFILL_CHUNK = 32

_request_ids = itertools.count(1)

# terminal request statuses (everything else is live)
_TERMINAL = ("done", "shed", "evicted", "cancelled", "failed")


class ServingError(RuntimeError):
    """Base class for per-request serving failures."""


class RequestShed(ServingError):
    """Rejected by admission control (bounded queue / SLO estimate /
    queued-past-deadline); carries ``.reason``."""

    def __init__(self, reason: str):
        super().__init__(f"request shed ({reason})")
        self.reason = reason


class RequestTimedOut(ServingError):
    """Evicted mid-batch: the per-request deadline passed."""


class RequestCancelled(ServingError):
    """Cancelled by the caller (or by engine shutdown)."""


class RequestFailed(ServingError):
    """The scheduler hit an internal error; the cause is chained."""


class Request:
    """A submitted generation request — a future over its token stream.

    ``tokens`` grows as the engine emits (generated tokens only, prompt
    excluded); `result()` blocks for completion, `stream()` iterates
    tokens as they land and CANCELS on early exit.  Timing fields
    (``t_submit``/``t_first``/``t_done``, ``time.monotonic`` seconds)
    are recorded for every terminal status.  ``cached_tokens`` is the
    prompt length served from the prefix cache at admission.
    """

    def __init__(self, engine: "ServingEngine", prompt: np.ndarray,
                 max_new_tokens: int, deadline: Optional[float], seed: int):
        self._engine = engine
        self._cond = threading.Condition(engine._lock)
        self.rid = next(_request_ids)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline            # absolute monotonic, or None
        self.seed = int(seed)
        self.status = "new"
        self.tokens: list = []
        self.t_tokens: list = []            # monotonic stamp per token
        self.error: Optional[BaseException] = None
        self.block_ids: tuple = ()
        self.cached_tokens = 0
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.ttft: Optional[float] = None   # derived at _finish
        self.tpot: Optional[float] = None   # mean s/token past the first
        self.spec_proposed = 0              # draft tokens offered for us
        self.spec_accepted = 0              # ... accepted by the target
        self._cancel = False

    # -- engine side (engine lock held) ------------------------------- #
    def _deliver(self, tok: int, now: float) -> None:
        if self.t_first is None:
            self.t_first = now
        self.tokens.append(tok)
        self.t_tokens.append(now)
        self._cond.notify_all()

    def _finish(self, status: str, error: Optional[BaseException] = None):
        self.status = status
        self.error = error
        self.t_done = time.monotonic()
        if isinstance(error, RequestShed):
            self.finish_reason = error.reason
        elif isinstance(error, RequestTimedOut):
            self.finish_reason = "timeout"
        elif error is not None:
            self.finish_reason = status
        if self.t_first is not None:
            self.ttft = self.t_first - self.t_submit
            if len(self.tokens) > 1:
                self.tpot = (self.t_done - self.t_first) \
                    / (len(self.tokens) - 1)
        self._cond.notify_all()

    # -- caller side --------------------------------------------------- #
    @property
    def finished(self) -> bool:
        return self.status in _TERMINAL

    @property
    def spec_accept_rate(self) -> float:
        """This request's draft-token acceptance rate (0.0 when it
        never ran under speculation)."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    def cancel(self) -> None:
        """Request cancellation (non-blocking, any thread, idempotent).
        A queued request is discarded; a running one is evicted at the
        next scheduler tick, freeing its KV blocks."""
        self._cancel = True
        eng = self._engine
        with eng._work:
            eng._work.notify_all()

    def result(self, timeout: Optional[float] = None) -> list:
        """Block until terminal; the generated token list, or raises
        the request's `ServingError` (shed/evicted/cancelled/failed)."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self.status not in _TERMINAL:
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"request not finished within {timeout}s "
                        f"(status={self.status})")
                self._cond.wait(_POLL_S if left is None
                                else min(_POLL_S, left))
            if self.error is not None:
                raise self.error
            return list(self.tokens)

    def stream(self):
        """Yield generated tokens as the engine emits them.  Exhausts
        on completion; raises the request's error on shed/evict/fail.
        Abandoning the generator (break / close / GC) cancels the
        request so its KV blocks return to the pool."""
        idx = 0
        try:
            while True:
                tok = None
                with self._cond:
                    while idx >= len(self.tokens) \
                            and self.status not in _TERMINAL:
                        self._cond.wait(_POLL_S)
                    if idx < len(self.tokens):
                        tok = self.tokens[idx]
                        idx += 1
                    elif self.error is not None:
                        raise self.error
                    else:
                        return
                yield tok
        finally:
            if not self.finished:
                self.cancel()


class _Slot:
    """Host bookkeeping of one occupied batch lane."""

    __slots__ = ("req", "blocks")

    def __init__(self, req: Request, blocks: list):
        self.req = req
        self.blocks = blocks


class _PrefillJob:
    """An admitted request's remaining prefill work: lane + blocks are
    already claimed (cache-hit prefix blocks bound read-only), the
    prompt tail past ``next_pos`` still needs chunking through the
    device.  The scheduler runs ONE chunk of ONE job per iteration,
    interleaved with decode steps."""

    __slots__ = ("lane", "req", "row", "seed", "prompt", "P",
                 "cached_len", "next_pos", "t_work")

    def __init__(self, lane, req, row, seed, prompt, P, cached_len):
        self.lane = lane
        self.req = req
        self.row = row
        self.seed = seed
        self.prompt = prompt
        self.P = P
        self.cached_len = cached_len
        self.next_pos = cached_len          # first unprefilled position
        self.t_work = 0.0                   # seconds spent so far


def _check_kernel_shapes(net, block_size: int, what: str = "net") -> None:
    """Raise ValueError when ``net`` lives on CUDA and the paged-attention
    kernel refuses its head dim or ``block_size``: an engine that would
    fail at its first scheduler step is refused when it is built.  The
    CPU path (the plain version) serves any shape."""
    if net.embed.weight.device.type != "cuda":
        return
    head_dim = net._units // net._layers[0].attn._num_heads
    problem = kernel_shape_problem(head_dim, block_size)
    if problem is not None:
        raise ValueError(f"ServingEngine on CUDA: the paged-attention "
                         f"kernel refuses this {what} and block size: "
                         f"{problem}")


class ServingEngine:
    """Continuous-batching decode over a `models.TransformerLM`, on the
    net's device.

    Parameters (all static — changing them means a new engine):

    max_batch       decode lanes run per step (batch width).
    block_size      KV block width in positions (a power of two; on
                    CUDA also <= 64, and the net's head dim one of
                    16, 32, 64, 128: the paged-attention kernel's
                    shapes, checked here).
    max_seq_len     cap on prompt+generated per request; defaults to
                    ``net._max_len`` rounded down to a block multiple.
    num_blocks      pool size; default fits ``max_batch`` full-length
                    sequences plus the scratch block.
    max_queue       admission queue bound (default 16).
    temperature/top_k/eos_id   sampling config, as in `lm_generate`.
    ttft_budget     SLO seconds; estimated-late requests are shed.
    default_deadline   per-request deadline seconds (overridable per
                    submit).
    prefill_chunk   prefill-chunk width in tokens (default 32, clamped
                    to ``max_seq_len``): each scheduler iteration runs
                    at most ONE chunk before the next decode step.
    quantized       weight path, as in `lm_generate`: None follows
                    `quantize_for_decode` (int8 weights iff the net
                    carries its state), True requires it, False forces
                    float weights.
    kv_dtype        None (pages in the model dtype) or "int8": int8
                    pages with an f32 scale per (block, head, slot),
                    quantized at page-write time and dequantized inside
                    the paged-attention kernel (1.88x the sequences per
                    pool byte at bf16, D=64).
    speculate_k     draft tokens proposed per lane per iteration (0:
                    speculation off); must be < ``max_seq_len``.
    draft_net       the draft `TransformerLM` (same vocab, ``max_len``
                    >= ``max_seq_len``, same device); None self-drafts
                    through the target's int8 weight path, which needs
                    a float target marked by `quantize_for_decode`.
    spec_greedy     accept by argmax prefix match even when sampling
                    (forced at temperature <= 0).
    poll_interval   scheduler idle/wait tick (default 2 ms).
    fault_hook      callable(phase: str) invoked before each
                    "prefill"/"draft"/"step" device call — the
                    fault-injection seam tests use (sleep = slow step,
                    raise = scheduler failure).
    """

    def __init__(self, net, *, max_batch: int = 4, block_size: int = 16,
                 max_seq_len: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: int = -1, ttft_budget: Optional[float] = None,
                 default_deadline: Optional[float] = None,
                 prefill_chunk: Optional[int] = None,
                 quantized=None, kv_dtype: Optional[str] = None,
                 speculate_k: int = 0, draft_net=None,
                 spec_greedy: bool = False,
                 poll_interval: Optional[float] = None, fault_hook=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if block_size < 1 or (block_size & (block_size - 1)):
            raise ValueError(
                f"block_size must be a power of two, got {block_size}")
        _check_kernel_shapes(net, block_size)
        msl = int(max_seq_len if max_seq_len is not None else net._max_len)
        msl = (msl // block_size) * block_size
        if msl < block_size:
            raise ValueError(
                f"max_seq_len {max_seq_len} < one block ({block_size})")
        if msl > net._max_len:
            raise ValueError(
                f"max_seq_len {msl} exceeds net.max_len {net._max_len}")
        self._net = net
        self._B = int(max_batch)
        self._bs = int(block_size)
        self._msl = msl
        self._nbps = msl // block_size
        self._num_blocks = int(num_blocks if num_blocks is not None
                               else self._B * self._nbps + 1)
        self._max_queue = int(max_queue if max_queue is not None
                              else _MAX_QUEUE)
        self._eos = int(eos_id)
        self._ttft_budget = ttft_budget
        self._default_deadline = default_deadline
        self._poll = float(poll_interval if poll_interval is not None
                           else _POLL_S)
        self._fault_hook = fault_hook
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self._chunk = max(1, min(int(prefill_chunk if prefill_chunk
                                     is not None else _PREFILL_CHUNK), msl))
        self._spec_k = int(speculate_k)
        self._spec = self._spec_k > 0
        if self._spec_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if self._spec and self._spec_k >= msl:
            raise ValueError(
                f"speculate_k {self._spec_k} >= max_seq_len {msl}")
        if self._spec and draft_net is not None:
            dv, tv = (draft_net.embed.weight.shape[0],
                      net.embed.weight.shape[0])
            if dv != tv:
                raise ValueError(f"draft_net vocab {dv} != target vocab {tv}")
            if draft_net._max_len < msl:
                raise ValueError(f"draft_net.max_len {draft_net._max_len} "
                                 f"< max_seq_len {msl}")
            dd, td = draft_net.embed.weight.device, net.embed.weight.device
            if dd != td:
                raise ValueError(f"draft_net is on {dd}, the target on {td}")
            _check_kernel_shapes(draft_net, block_size, "draft net")
        self._programs = PagedPrograms(
            net, max_batch=self._B, block_size=self._bs,
            blocks_per_seq=self._nbps, num_blocks=self._num_blocks,
            temperature=temperature, top_k=top_k,
            prefill_chunk=self._chunk, quantized=quantized,
            kv_dtype=kv_dtype, speculate_k=self._spec_k,
            draft_net=draft_net, spec_greedy=spec_greedy)
        self._pool = BlockPool(self._num_blocks, self._bs)

        # per-lane step inputs (scheduler thread only; snapshots are
        # handed to the device programs)
        B, nbps = self._B, self._nbps
        self._tables = np.full((B, nbps), SCRATCH_BLOCK, np.int32)
        self._toks = np.zeros((B,), np.int32)
        self._pos = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        self._seeds = np.zeros((B,), np.int64)
        self._slots: list = [None] * B

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: deque = deque()
        # admitted-but-unprefilled work, oldest first
        self._prefill_jobs: deque = deque()
        self._stop = threading.Event()
        self._closed = False
        self._err_lock = threading.Lock()
        self._pending_err: Optional[BaseException] = None
        self._prefill_ewma: Optional[float] = None
        self._stats = {"admitted": 0, "done": 0, "steps": 0,
                       "prefix_hits": 0, "prefix_misses": 0,
                       "cached_tokens": 0,
                       "shed": OrderedDict(), "evicted": OrderedDict(),
                       "spec_steps": 0, "spec_proposed": 0,
                       "spec_accepted": 0, "spec_ewma": None,
                       "spec_rollback": OrderedDict()}
        self._thread = threading.Thread(
            target=self._scheduler, daemon=True,
            name="mxt-serving-scheduler")
        self._thread.start()

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def max_seq_len(self) -> int:
        return self._msl

    @property
    def kv_dtype(self) -> Optional[str]:
        """None (model dtype) or "int8"."""
        return self._programs.kv_dtype

    @property
    def path(self) -> str:
        """The weight path: "float" or "int8"."""
        return self._programs.path

    @property
    def speculate_k(self) -> int:
        """Draft tokens proposed per lane per iteration (0: off)."""
        return self._spec_k

    @property
    def kv_pool_bytes(self) -> int:
        """Device bytes of the whole KV pool (pages and int8 scales, all
        layers, the draft's pages included)."""
        return self._programs.kv_pool_bytes

    @property
    def kv_block_bytes(self) -> int:
        """Pool bytes one block costs across all layers (K + V +
        scales); ``kv_pool_bytes == num_blocks * kv_block_bytes``."""
        return self.kv_pool_bytes // self._num_blocks

    @property
    def kv_bytes_per_token(self) -> int:
        """Pool bytes one token position costs across all layers."""
        return self.kv_block_bytes // self._bs

    def set_fault_hook(self, hook) -> None:
        with self._lock:
            self._fault_hook = hook

    def set_ttft_budget(self, seconds: Optional[float]) -> None:
        with self._lock:
            self._ttft_budget = seconds

    def submit(self, prompt, max_new_tokens: int, *,
               deadline: Optional[float] = None, seed: int = 0,
               block: bool = False,
               timeout: Optional[float] = None) -> Request:
        """Enqueue a generation request; returns its `Request` handle
        immediately (inspect ``.status`` / call ``.result()``).

        ``deadline`` is seconds from now (default the engine's
        ``default_deadline``); a queue-full engine SHEDS the request
        (``block=False``, the open-loop default) or waits for space up
        to ``timeout`` (``block=True``) — waiting observes `close()`.
        """
        prompt = self._as_prompt(prompt)
        P = prompt.shape[0]
        N = int(max_new_tokens)
        if N < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {N}")
        if P < 1:
            raise ValueError("prompt must be non-empty")
        if P + N > self._msl:
            raise ValueError(
                f"prompt+new = {P + N} exceeds max_seq_len {self._msl}")
        if self._blocks_needed(P, N) > self._num_blocks - 1:
            raise ValueError(
                f"request needs {self._blocks_needed(P, N)} KV blocks "
                f"but the pool only has {self._num_blocks - 1} — it "
                "could never be admitted")
        if deadline is None:
            deadline = self._default_deadline
        abs_deadline = None if deadline is None \
            else time.monotonic() + float(deadline)
        req = Request(self, prompt, N, abs_deadline, seed)
        end = None if timeout is None else time.monotonic() + timeout
        with self._work:
            self._check_alive()
            while len(self._queue) >= self._max_queue:
                if not block:
                    self._shed_locked(req, "queue_full")
                    return req
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    self._shed_locked(req, "queue_full")
                    return req
                self._work.wait(self._poll if left is None
                                else min(self._poll, left))
                self._check_alive()
            req.status = "queued"
            self._queue.append(req)
            self._work.notify_all()
        return req

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until the queue is empty and every lane idle; True on
        success, False on timeout (work still in flight)."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._work:
            while self._queue or any(s is not None for s in self._slots):
                if self._has_pending_err() or self._closed:
                    return not (self._queue
                                or any(s is not None for s in self._slots))
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._work.wait(self._poll if left is None
                                else min(self._poll, left))
            return True

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop and JOIN the scheduler thread, abort any unfinished
        requests (their handles see `RequestCancelled`), release all
        blocks, and re-raise a parked scheduler error (idempotent)."""
        with self._work:
            already = self._closed
            self._closed = True
            self._stop.set()
            self._work.notify_all()
        if not already:
            self._thread.join(timeout)
            with self._work:
                self._abort_all_locked(
                    RequestCancelled("serving engine closed"))
                self._work.notify_all()
        with self._err_lock:
            err, self._pending_err = self._pending_err, None
        if err is not None:
            raise RequestFailed("serving scheduler failed") from err

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """Snapshot of the engine's counters (host-side, lock-held)."""
        with self._lock:
            out = {
                "admitted": self._stats["admitted"],
                "done": self._stats["done"],
                "steps": self._stats["steps"],
                "shed": dict(self._stats["shed"]),
                "evicted": dict(self._stats["evicted"]),
                "queue_depth": len(self._queue),
                "active": int(self._active.sum()),
                "blocks_free": self._pool.num_free,
                "blocks_total": self._num_blocks - 1,
                "prefix_cache": {
                    "hits": self._stats["prefix_hits"],
                    "misses": self._stats["prefix_misses"],
                    "cached_tokens": self._stats["cached_tokens"],
                    **self._pool.prefix_stats()},
                "prefill_chunk": {
                    "chunk": self._chunk,
                    "jobs": len(self._prefill_jobs),
                    "pending_chunks": self._pending_chunks_locked()},
                "path": self.path,
                "kv_dtype": self.kv_dtype or "model",
            }
            if self._spec:
                prop = self._stats["spec_proposed"]
                out["speculate"] = {
                    "k": self._spec_k,
                    "draft": self._programs.draft_label,
                    "greedy": self._programs.spec_greedy,
                    "steps": self._stats["spec_steps"],
                    "proposed": prop,
                    "accepted": self._stats["spec_accepted"],
                    "accept_rate": (self._stats["spec_accepted"] / prop
                                    if prop else None),
                    "accept_rate_ewma": self._stats["spec_ewma"],
                    "rollback": dict(self._stats["spec_rollback"]),
                }
            return out

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    @staticmethod
    def _as_prompt(prompt) -> np.ndarray:
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        arr = np.asarray(prompt, np.int32)
        if arr.ndim == 2 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.ndim != 1:
            raise ValueError(
                f"prompt must be 1-D (or (1, P)), got shape {arr.shape}")
        return arr

    def _has_pending_err(self) -> bool:
        with self._err_lock:
            return self._pending_err is not None

    def _check_alive(self) -> None:
        with self._err_lock:
            err = self._pending_err
        if err is not None:
            raise RequestFailed("serving scheduler failed") from err
        if self._closed:
            raise RuntimeError("serving engine is closed")

    def _blocks_needed(self, P: int, N: int) -> int:
        horizon = P + N
        if self._spec:
            # the window writes up to k positions past the last committed
            # one (at most P+N-2: the final token needs no write), so
            # reserve blocks up to min(P+N-2+k, msl-1): rejected
            # positions land in the lane's OWN pages, never a neighbour's
            horizon = min(P + N - 1 + self._spec_k, self._msl)
        return -(-horizon // self._bs)

    @staticmethod
    def _count(table: OrderedDict, reason: str) -> None:
        table[reason] = table.get(reason, 0) + 1

    def _shed_locked(self, req: Request, reason: str) -> None:
        req._finish("shed", RequestShed(reason))
        self._count(self._stats["shed"], reason)

    def _abort_all_locked(self, error: BaseException,
                          status: str = "cancelled") -> None:
        self._prefill_jobs.clear()
        while self._queue:
            self._queue.popleft()._finish(status, error)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            self._release_lane_locked(i)
            slot.req._finish(status, error)

    def _release_lane_locked(self, i: int) -> None:
        slot = self._slots[i]
        self._pool.free(slot.blocks)        # decref: shared prefix
        self._slots[i] = None               # blocks survive in-cache
        self._tables[i, :] = SCRATCH_BLOCK
        self._active[i] = False
        self._toks[i] = 0
        self._pos[i] = 0

    def _evict_locked(self, i: int, reason: str,
                      error: BaseException) -> None:
        req = self._slots[i].req
        self._release_lane_locked(i)
        req._finish("cancelled" if reason == "cancel" else "evicted",
                    error)
        self._count(self._stats["evicted"], reason)

    # -- scheduler thread ---------------------------------------------- #
    def _scheduler(self) -> None:
        try:
            self._loop()
        except BaseException as e:
            with self._err_lock:
                self._pending_err = e
            failure = RequestFailed("serving scheduler failed")
            failure.__cause__ = e
            with self._work:
                self._abort_all_locked(failure, status="failed")
                self._work.notify_all()

    def _loop(self) -> None:
        # iteration: reap → admit everything that fits (lanes + blocks
        # claimed, prefix blocks bound) → run at most ONE prefill chunk
        # → run ONE decode step over live lanes
        while True:
            with self._work:
                if self._stop.is_set():
                    return
                now = time.monotonic()
                self._reap_locked(now)
                while self._admit_locked(now):
                    pass
                staged = self._stage_chunk_locked()
                live = [(i, s.req) for i, s in enumerate(self._slots)
                        if s is not None and self._active[i]]
                snap = (self._tables.copy(), self._toks.copy(),
                        self._pos.copy(), self._active.copy(),
                        self._seeds.copy()) if live else None
                hook = self._fault_hook
                if staged is None and not live:
                    if not self._queue:
                        self._work.wait(self._poll)
                    continue
            if staged is not None:
                self._run_chunk(staged, hook)
            if live:
                (self._spec_step if self._spec
                 else self._decode_step)(snap, live, hook)

    def _reap_locked(self, now: float) -> None:
        # queued requests: cancellation and deadlines apply while waiting
        if self._queue:
            keep = deque()
            for req in self._queue:
                if req._cancel:
                    req._finish("cancelled", RequestCancelled("cancelled"))
                elif req.deadline is not None and now > req.deadline:
                    self._shed_locked(req, "deadline")
                else:
                    keep.append(req)
            if len(keep) != len(self._queue):
                # mutate in place: the deque identity is shared with
                # every lock-holding reader (submit/stats/drain)
                self._queue.clear()
                self._queue.extend(keep)
                self._work.notify_all()     # queue space freed
        # running lanes: evict mid-batch (blocks freed, neighbours
        # untouched — see docs/serving.md for why this is exact)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.req._cancel:
                self._evict_locked(i, "cancel",
                                   RequestCancelled("cancelled"))
            elif slot.req.deadline is not None \
                    and now > slot.req.deadline:
                self._evict_locked(
                    i, "timeout",
                    RequestTimedOut(f"deadline exceeded after "
                                    f"{len(slot.req.tokens)} token(s)"))

    def _admit_locked(self, now: float) -> bool:
        """Admit the queue head: claim a lane, look the prompt up in the
        prefix cache, bind the cache-hit blocks copy-on-write, and alloc
        private blocks for the tail — all under the lock.  The remaining
        prefill work is queued as a `_PrefillJob`.  Returns False when
        nothing is admissible (empty queue, batch full, pool full)."""
        while self._queue:
            req = self._queue[0]
            if self._ttft_budget is not None \
                    and self._prefill_ewma is not None:
                est = (now - req.t_submit) + self._prefill_ewma
                if est > self._ttft_budget:
                    self._queue.popleft()
                    self._shed_locked(req, "slo")
                    self._work.notify_all()
                    continue
            try:
                lane = self._slots.index(None)
            except ValueError:
                return False                # batch full
            P = req.prompt.shape[0]
            needed = self._blocks_needed(P, req.max_new_tokens)
            # prefix-cache lookup + COW bind: bound blocks are never
            # written by this request (chunks start at cached_len,
            # decode writes at >= P), so sharing needs no copy
            hits, cached_len = self._pool.lookup(req.prompt)
            self._pool.bind(hits)
            fresh = self._pool.alloc(needed - len(hits))
            if fresh is None:
                self._pool.unbind(hits)     # roll back: FCFS head waits
                return False
            blocks = list(hits) + fresh
            # register the lane BEFORE any (unlocked) chunk runs: if a
            # chunk or a fault hook raises, the failure path finds the
            # request in its slot and finishes it
            self._queue.popleft()
            self._slots[lane] = _Slot(req, blocks)
            req.block_ids = tuple(blocks)
            req.cached_tokens = cached_len
            row = np.full((self._nbps,), SCRATCH_BLOCK, np.int32)
            row[:len(blocks)] = blocks
            self._stats["prefix_hits" if cached_len else
                        "prefix_misses"] += 1
            self._stats["cached_tokens"] += cached_len
            self._prefill_jobs.append(_PrefillJob(
                lane, req, row, req.seed, req.prompt, P, cached_len))
            self._work.notify_all()         # queue space freed
            return True
        return False

    def _stage_chunk_locked(self):
        """Pick the next prefill chunk to run: the oldest job whose lane
        still belongs to it (evicted/cancelled jobs are dropped here —
        their blocks were already freed by `_evict_locked`).  Returns
        ``(job, toks, start, n)`` or None."""
        while self._prefill_jobs:
            job = self._prefill_jobs[0]
            slot = self._slots[job.lane]
            if slot is None or slot.req is not job.req:
                self._prefill_jobs.popleft()
                continue
            start = job.next_pos
            n = min(self._chunk, job.P - start)
            toks = np.zeros((self._chunk,), np.int32)
            toks[:n] = job.prompt[start:start + n]
            return (job, toks, start, n)
        return None

    def _run_chunk(self, staged, hook) -> None:
        """Run one staged prefill chunk — device call OUTSIDE the lock,
        so submit()/cancel()/stats() never stall behind prefill compute.
        Re-locks to commit, with a slot identity check in case the
        request was evicted meanwhile; the FINAL chunk's commit delivers
        the first token and activates the lane."""
        job, toks, start, n = staged
        req = job.req
        if hook is not None:
            hook("prefill")                 # fault seam: once per chunk
        final = start + n >= job.P
        t0 = time.perf_counter()
        tok = self._programs.prefill_chunk(job.row, toks, start, job.P,
                                           job.seed, final)
        if self._spec:
            # the draft's pool takes the same chunk: its first proposal
            # attends to the whole prompt
            self._programs.draft_prefill_chunk(job.row, toks, start, job.P)
        dt = time.perf_counter() - t0
        now = time.monotonic()
        with self._work:
            job.t_work += dt
            slot = self._slots[job.lane]
            if slot is None or slot.req is not req:
                self._drop_job_locked(job)
                return                      # evicted while chunking
            job.next_pos = start + n
            if not final:
                return
            self._drop_job_locked(job)
            # EWMA over the request's WHOLE prefill (all chunks)
            self._prefill_ewma = job.t_work \
                if self._prefill_ewma is None \
                else 0.8 * self._prefill_ewma + 0.2 * job.t_work
            req.status = "running"
            req._deliver(tok, now)
            self._stats["admitted"] += 1
            # publish the prompt's full blocks into the prefix cache now
            # their content is final (COW: nothing writes positions < P
            # past this point)
            self._pool.register(job.prompt, job.row)
            if tok == self._eos or len(req.tokens) >= req.max_new_tokens:
                self._retire_locked(job.lane)
                return
            self._tables[job.lane, :] = job.row
            self._toks[job.lane] = tok
            self._pos[job.lane] = job.P
            self._active[job.lane] = True
            self._seeds[job.lane] = job.seed

    def _drop_job_locked(self, job: _PrefillJob) -> None:
        try:
            self._prefill_jobs.remove(job)
        except ValueError:
            pass

    def _pending_chunks_locked(self) -> int:
        """Chunks still to run across live prefill jobs."""
        ch = self._chunk
        return sum(-(-(j.P - j.next_pos) // ch)
                   for j in self._prefill_jobs
                   if (self._slots[j.lane] is not None
                       and self._slots[j.lane].req is j.req))

    def _retire_locked(self, lane: int) -> None:
        req = self._slots[lane].req
        self._release_lane_locked(lane)
        req._finish("done")
        self._stats["done"] += 1
        self._work.notify_all()             # drain()ers and submitters

    def _decode_step(self, snap, live, hook) -> None:
        """One batched decode step — device call OUTSIDE the lock, so
        submit()/cancel() never block on compute (a fault hook's
        injected sleep included)."""
        if hook is not None:
            hook("step")
        nxt = self._programs.step(*snap)    # syncs: tokens consumed now
        now = time.monotonic()
        with self._work:
            self._stats["steps"] += 1
            for lane, req in live:
                slot = self._slots[lane]
                if slot is None or slot.req is not req:
                    continue                # evicted while stepping
                tok = int(nxt[lane])
                req._deliver(tok, now)
                self._pos[lane] += 1
                self._toks[lane] = tok
                if tok == self._eos \
                        or len(req.tokens) >= req.max_new_tokens:
                    self._retire_locked(lane)

    def _spec_step(self, snap, live, hook) -> None:
        """One speculate-then-verify iteration, `_decode_step`'s shape:
        the draft proposes k tokens per lane on its own pool (they stay
        on the card and feed the verify), the verify emits ``out[:,
        :alen+1]`` per lane — both outside the lock — and the commit,
        re-locked, truncates each lane at eviction (slot identity), eos
        and ``max_new_tokens``.  Rollback is host-side position
        arithmetic only (see `PagedPrograms.spec_verify`)."""
        k = self._spec_k
        if hook is not None:
            hook("draft")
        d_toks, q = self._programs.draft_step(*snap)
        if hook is not None:
            hook("step")
        out, alen = self._programs.spec_verify(*snap, d_toks, q)
        now = time.monotonic()
        with self._work:
            self._stats["steps"] += 1
            self._stats["spec_steps"] += 1
            rollback = self._stats["spec_rollback"]
            proposed = accepted = 0
            for lane, req in live:
                slot = self._slots[lane]
                if slot is None or slot.req is not req:
                    continue                # evicted while speculating
                a = int(alen[lane])
                proposed += k
                accepted += a
                req.spec_proposed += k
                req.spec_accepted += a
                if a < k:
                    self._count(rollback, "rejected")
                delivered, stop = 0, None
                for j in range(a + 1):      # accepted run + correction/bonus
                    tok = int(out[lane, j])
                    req._deliver(tok, now)
                    delivered += 1
                    if tok == self._eos:
                        stop = "eos"
                        break
                    if len(req.tokens) >= req.max_new_tokens:
                        stop = "max_tokens"
                        break
                if stop is not None and delivered < a + 1:
                    self._count(rollback, stop)
                self._pos[lane] += delivered
                self._toks[lane] = int(out[lane, delivered - 1])
                if not BlockPool.covers(len(slot.blocks), self._bs,
                                        int(self._pos[lane]) - 1):
                    raise RuntimeError(
                        f"speculative commit outran lane {lane}'s "
                        f"reservation: pos {int(self._pos[lane])} vs "
                        f"{len(slot.blocks)} blocks of {self._bs}")
                if stop is not None:
                    self._retire_locked(lane)
            if proposed:
                rate = accepted / proposed
                self._stats["spec_proposed"] += proposed
                self._stats["spec_accepted"] += accepted
                ewma = self._stats["spec_ewma"]
                self._stats["spec_ewma"] = rate if ewma is None \
                    else 0.9 * ewma + 0.1 * rate


def default_engine(net, **kw) -> ServingEngine:
    """The net's shared serving engine, built on first use and cached
    on the net (``net._serving_engine``).  Passing config kwargs that
    differ from the cached engine's closes it and builds a fresh one;
    equal (or no) kwargs reuse it."""
    eng = getattr(net, "_serving_engine", None)
    if eng is not None and not eng.closed:
        if not kw or kw == eng._ctor_kw:
            return eng
        try:
            eng.close()
        except ServingError:
            pass
    eng = ServingEngine(net, **kw)
    eng._ctor_kw = dict(kw)
    net._serving_engine = eng
    return eng
