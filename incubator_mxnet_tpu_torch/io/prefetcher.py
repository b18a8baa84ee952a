"""Async host-to-card input pipeline of the PyTorch/CUDA port
(counterpart of `incubator_mxnet_tpu/io/prefetcher.py`): double-buffered
fetch, staging and copy, so that batch N+1's host work and its copy to
the card overlap batch N's compute.

Three pipelined host stages, as in the JAX package:

1. **fetch** — a background thread pulls batches from the source
   (dataset fetch / batchify / decode);
2. **staging** — a bounded queue decouples fetch jitter from transfer;
3. **transfer** — a second thread starts each batch's copy to the card.

``jax.device_put`` only enqueues a copy; the port builds that itself
(`_Stager`):

* each host leaf (numpy array or CPU tensor) is copied into a pinned
  host buffer taken from a ring per (shape, dtype) of ``depth + 1``
  buffers; a buffer is reused only after the copy that last read it
  has completed (its event), so the fetch side never overwrites bytes
  still in flight;
* the copy to the card is ``copy_(non_blocking=True)`` on the stager's
  own copy stream, with an event recorded after it;
* when the consumer takes the batch (`_ready`), its current stream
  waits on that event and the card tensor is marked used by that
  stream (``record_stream``), so the caching allocator does not hand
  its memory out again while the consumer's work still reads it.

The consumer receives card tensors without ever blocking on a copy.
On the CPU (``device="cpu"``) each leaf is copied into a fresh CPU
tensor: nothing is pinned and no stream exists.  The ready queue is
``depth`` deep (default 2), so the pipeline runs at ``max(fetch,
transfer, compute)`` and holds at most ``2·depth`` batches.

Telemetry (when enabled):

* ``data_wait_seconds``     histogram — time the consumer blocked
  waiting for the next batch (the input-boundness signal);
* ``prefetch_queue_depth``  gauge — ready batches after each get;
* ``h2d_bytes_total``       counter — bytes submitted host→card.

Consumers: ``gluon.data.DataLoader(prefetch_to_device=...)``,
``io.PrefetchingIter(prefetch_to_device=True)`` and
``io.ImageRecordIter``'s emitted batches.  Mesh-sharded placement
(``mesh=``, `batch_sharding`) is not ported and raises `MXNetError`.
"""
from __future__ import annotations

import copy
import queue as _queue
import threading
import time
from typing import Iterable, Optional

import numpy as onp
import torch

from .. import telemetry
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["DevicePrefetcher", "to_device", "batch_sharding"]

# sentinel marking the end of an epoch inside the stage/ready queues
_END = object()

# how long a blocked queue put/get sleeps between stop-flag checks; the
# granularity of worker shutdown, not of steady-state throughput (a
# non-full/non-empty queue never waits)
_POLL_S = 0.05


class _Failure:
    """An exception crossing a queue; re-raised on the consumer thread."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc

    def reraise(self):
        raise self.exc


def _no_mesh(mesh) -> None:
    if mesh is not None and mesh is not False:
        raise MXNetError("mesh-sharded staging is not ported: the port's "
                         "input pipeline places batches on one device")


def batch_sharding(mesh, ndim: int, axis_name: str = "data",
                   batch_axis: int = 0):
    """The JAX package's batch-dim placement on a mesh; not ported."""
    raise MXNetError("batch_sharding is not ported: the port has no "
                     "device mesh")


class _Pending:
    """A card tensor whose copy is in flight on a copy stream."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor, event):
        self.tensor = tensor
        self.event = event


class _Stager:
    """Copies host leaves to ``device``: through pinned rings and a
    copy stream of its own on CUDA (see the module docstring), into
    fresh tensors on the CPU.  One thread uses a stager at a time."""

    def __init__(self, device, depth: int = 1):
        self.device = torch.device(device)
        self.slots = max(1, int(depth)) + 1
        self._rings: dict = {}      # (shape, dtype) -> [[pinned, event]]
        self._next: dict = {}       # (shape, dtype) -> the next slot
        self._stream = None

    def put(self, host: torch.Tensor):
        """``host`` (a contiguous CPU tensor) on the stager's device: a
        tensor on the CPU, a `_Pending` on CUDA."""
        if self.device.type != "cuda":
            return host.clone()
        key = (tuple(host.shape), host.dtype)
        ring = self._rings.setdefault(key, [])
        i = self._next.get(key, 0)
        self._next[key] = (i + 1) % self.slots
        if i == len(ring):
            ring.append([torch.empty(host.shape, dtype=host.dtype,
                                     pin_memory=True), None])
        slot = ring[i]
        if slot[1] is not None:
            slot[1].synchronize()   # the copy that last read it is done
        slot[0].copy_(host)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            out.copy_(slot[0], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        slot[1] = ev
        return _Pending(out, ev)


def _host_leaf(x) -> Optional[torch.Tensor]:
    """A contiguous CPU tensor of an array leaf, or None for anything
    else (card tensors and non-array leaves)."""
    if isinstance(x, onp.ndarray):
        return torch.from_numpy(onp.ascontiguousarray(x))
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        return x.detach().contiguous()
    return None


def _map(batch, fn):
    """``fn`` on every leaf of ``batch``: containers (tuple/list/dict)
    and ``DataBatch``-shaped objects keep their shape (a shallow copy
    with ``data``/``label`` mapped, pad/index/provide_* untouched)."""
    if isinstance(batch, (tuple, list)):
        out = [_map(b, fn) for b in batch]
        return type(batch)(out) if isinstance(batch, tuple) else out
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    if hasattr(batch, "data") and hasattr(batch, "label") \
            and hasattr(batch, "pad"):
        nb = copy.copy(batch)
        nb.data = _map(batch.data, fn)
        if batch.label is not None:
            nb.label = _map(batch.label, fn)
        return nb
    return fn(batch)


def _stage(batch, stager: _Stager):
    """Start the copy of every array leaf of ``batch`` (`_Pending`
    leaves on CUDA); card tensors move with ``.to`` when they are on
    another device, other leaves pass through."""
    def leaf(x):
        host = _host_leaf(x)
        if host is None:
            if isinstance(x, torch.Tensor) and x.device != stager.device:
                return x.to(stager.device)
            return x
        if telemetry.enabled():
            telemetry.counter("h2d_bytes_total").inc(
                telemetry.nbytes_of(host))
        return stager.put(host)

    return _map(batch, leaf)


def _ready(batch):
    """Hand ``batch``'s pending leaves to the calling thread's current
    stream: it waits on each copy's event, and the card tensor is
    recorded as used by it."""
    def leaf(x):
        if not isinstance(x, _Pending):
            return x
        s = torch.cuda.current_stream(x.tensor.device)
        s.wait_event(x.event)
        x.tensor.record_stream(s)
        return x.tensor

    return _map(batch, leaf)


def to_device(batch, mesh=None, axis_name: str = "data", batch_axis: int = 0,
              device=None):
    """Structure-preserving host→card transfer of one batch, on
    ``device`` (default ``cuda``).

    Array leaves (numpy arrays, CPU tensors) become tensors on the
    device, ready for the calling thread's current stream (the copy
    itself runs on a copy stream; the caller does not wait for it);
    containers (tuple/list/dict) and ``DataBatch``-shaped objects keep
    their shape; everything else passes through.  ``mesh`` is not
    ported (`MXNetError`).  Each call stages through buffers of its own
    (PyTorch's pinned allocator keeps one until its copy is done); a
    repeated feed keeps a `_Stager` instead, as the iterators do."""
    _no_mesh(mesh)
    return _ready(_stage(batch, _Stager(resolve_device(device))))


def _abortable_put(q: _queue.Queue, item, stop: threading.Event) -> bool:
    """Blocking put that observes `stop` — a worker parked on a full
    queue can always be shut down (the PrefetchingIter.reset race)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except _queue.Full:
            continue
    return False


def _abortable_get(q: _queue.Queue, stop: threading.Event):
    """Blocking get that observes `stop`; returns _END once stopped."""
    while not stop.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except _queue.Empty:
            continue
    return _END


def _drain(q: _queue.Queue) -> None:
    while True:
        try:
            q.get_nowait()
        except _queue.Empty:
            return


def _observe_wait(t0: float, depth: int) -> None:
    telemetry.histogram("data_wait_seconds").observe(
        time.perf_counter() - t0)
    telemetry.gauge("prefetch_queue_depth").set(depth)


class _Epoch:
    """One epoch's private queues + threads.

    Per-epoch state is the shutdown guarantee: a worker from a previous
    epoch can only ever touch ITS OWN queues, so even a slow-to-die
    thread cannot pollute the next epoch (it is also guaranteed to die:
    every blocking queue op observes this epoch's stop flag)."""

    def __init__(self, it, depth: int, transfer):
        # an iterator that copies its own batches to the card
        # (`io.ImageRecordIter`) is read staged: `get` readies them on
        # the consumer's thread and stream, never on the fetch thread
        staged = getattr(it, "_next_staged", None)
        self._pull = staged if staged is not None else it.__next__
        self._transfer = transfer
        self.stop = threading.Event()
        self.stage_q: _queue.Queue = _queue.Queue(maxsize=depth)
        self.ready_q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._threads = [
            threading.Thread(target=self._fetch_loop, daemon=True,
                             name="mxtpu-prefetch-fetch"),
            threading.Thread(target=self._xfer_loop, daemon=True,
                             name="mxtpu-prefetch-xfer"),
        ]
        for t in self._threads:
            t.start()

    # -- stage 1: host fetch/batchify ---------------------------------- #
    def _fetch_loop(self):
        while not self.stop.is_set():
            try:
                batch = self._pull()
            except StopIteration:
                _abortable_put(self.stage_q, _END, self.stop)
                return
            except BaseException as e:  # surfaced on the consumer thread
                _abortable_put(self.stage_q, _Failure(e), self.stop)
                return
            if not _abortable_put(self.stage_q, batch, self.stop):
                return

    # -- stage 3: the copy's start (stage 2 is the queue between) ------ #
    def _xfer_loop(self):
        while not self.stop.is_set():
            item = _abortable_get(self.stage_q, self.stop)
            if item is _END or isinstance(item, _Failure):
                _abortable_put(self.ready_q, item, self.stop)
                return
            try:
                item = self._transfer(item)
            except BaseException as e:
                _abortable_put(self.ready_q, _Failure(e), self.stop)
                return
            if not _abortable_put(self.ready_q, item, self.stop):
                return

    def get(self):
        """Next ready batch, handed to the calling thread's stream
        (raises StopIteration at epoch end)."""
        want_tel = telemetry.enabled()
        t0 = time.perf_counter() if want_tel else 0.0
        while True:
            try:
                item = self.ready_q.get(timeout=1.0)
                break
            except _queue.Empty:
                if not any(t.is_alive() for t in self._threads):
                    item = _END  # workers died without a sentinel
                    break
        if want_tel:
            _observe_wait(t0, self.ready_q.qsize())
        if item is _END:
            raise StopIteration
        if isinstance(item, _Failure):
            item.reraise()
        return _ready(item)

    def shutdown(self, join_timeout: float = 5.0):
        self.stop.set()
        # unblock workers parked on a full queue, then reap them
        _drain(self.stage_q)
        _drain(self.ready_q)
        for t in self._threads:
            t.join(timeout=join_timeout)


class DevicePrefetcher:
    """Iterate ``source`` with fetch/transfer/compute fully overlapped.

    ``source`` is any iterable of batches (a generator, a
    ``DataLoader``'s host iterator, a ``DataIter``); each ``iter()`` of
    this object starts a fresh epoch over ``iter(source)``.  Batches
    come back structure-preserved with every array leaf a tensor on
    ``device`` (default ``cuda``; see `to_device`).  ``depth`` is the
    ready-queue capacity (k-deep double buffering); the stager keeps
    ``depth + 1`` pinned buffers per leaf shape.  ``mesh`` other than
    None or False raises `MXNetError` (not ported)."""

    def __init__(self, source: Iterable, depth: int = 2, mesh=None,
                 axis_name: str = "data", batch_axis: int = 0,
                 device=None):
        _no_mesh(mesh)
        self._source = source
        self._depth = max(1, int(depth))
        self._stager = _Stager(resolve_device(device), self._depth)
        self._epoch: Optional[_Epoch] = None

    @property
    def device(self) -> torch.device:
        return self._stager.device

    def __iter__(self):
        self.close()  # at most one live epoch per prefetcher
        stager = self._stager
        ep = _Epoch(iter(self._source), self._depth,
                    lambda batch: _stage(batch, stager))
        self._epoch = ep
        try:
            while True:
                try:
                    yield ep.get()
                except StopIteration:
                    return
        finally:
            ep.shutdown()
            if self._epoch is ep:
                self._epoch = None

    def close(self):
        """Stop the in-flight epoch's workers (idempotent)."""
        ep, self._epoch = self._epoch, None
        if ep is not None:
            ep.shutdown()

    def __len__(self):
        return len(self._source)  # type: ignore[arg-type]
