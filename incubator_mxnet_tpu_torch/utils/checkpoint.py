"""Preemption-safe train-state checkpoints of the PyTorch/CUDA port
(counterpart of `incubator_mxnet_tpu/utils/checkpoint.py`, whose step
directories it writes and reads).

A checkpoint is the whole train state: the parameters by structural
name, the optimizer states and update counts, the random stream, the
data iterator's position and the caller's extras.  Each step is a
directory ``ckpt-{step:010d}`` written under a temporary name and
renamed into place, with a bounded retention window (``keep``).

**Async protocol.** ``save()`` fetches nothing from the card on the
caller's thread.  It copies every parameter and state tensor into fresh
snapshot buffers with one ``torch._foreach_copy_`` on the current stream
(one per device), records a CUDA event after it, and hands the snapshot
to a background worker.  The copy is ordered after the step that
produced the state and before the next step's update (which replays on
the same stream), so training may go on at once.  The worker waits on
the event, fetches the snapshot one tensor at a time on a stream of its
own (never the whole tree into one host buffer), checksums and commits.
The caller's stall is the copy's dispatch and the hand-off to a bounded
queue: a full queue blocks ``save()``.  A save that fails raises on the
next ``save()``, ``wait()`` or ``close()``.

**Integrity manifest (format 2).** ``manifest-proc0.json`` holds
whole-file and per-leaf CRC32s and is written last inside the temporary
directory, then the files are fsynced and renamed, the manifest last,
then ``meta.json``.  ``restore()`` validates the checksums; a corrupt,
truncated or partly renamed step is skipped with a warning and the
previous complete step restores.  Format-1 directories (no manifest,
such as the committed golden fixture) still restore.

**Layout.** ``arrays-proc0`` is a ``.params`` file (the codec of
`utils.serialization`) with ``param:<structural name>`` keys;
``state-proc0.pkl`` pickles ``{"step", "trainer": {"num_update",
"index_update_count", "states"}, "rng", "torch_rng", "iterator_state",
"extra"}``, the states as numpy trees keyed by parameter index
(`gluon.Trainer.host_states`).  Parameters restore in place through
`Parameter.set_data`, states in place through
`gluon.Trainer.restore_states`: a captured update keeps reading the same
addresses.

**The random stream.** The JAX package keeps a threefry ``(key,
counter)`` pair under ``rng``, which no torch stream can replay.  The
port keeps its generator's state under ``torch_rng`` and writes a
well-formed ``rng`` pair derived from it (`random.jax_pair`), so the JAX
package restores a port bundle; restoring a bundle without
``torch_rng`` seeds the port's stream from the pair
(`random.jax_pair_seed`).  Dropout masks after a cross-package resume
therefore do not match the other package's, whose stream differs anyway.

**Telemetry** (enabled; the JAX package's names):
``checkpoint_step_stall_seconds`` (the caller's time in ``save()``),
``checkpoint_queue_depth``, ``checkpoint_write_seconds`` and
``checkpoint_bytes_total`` (each committed write),
``checkpoint_write_retries_total`` and
``checkpoint_restore_skipped_total``; the snapshot's copy is counted
once as the ``checkpoint_snapshot`` record of `telemetry.perf`.

Not ported yet: the multi-process shards and the ZeRO-sharded state;
this manager writes and reads process 0's shard only.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import queue
import shutil
import threading
import time
import warnings
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import random as _random
from .. import telemetry
from ..optimizer.optimizer import state_to_host
from . import serialization

__all__ = ["CheckpointManager", "CheckpointCorrupt"]

FORMAT = 2  # manifest-bearing step dirs; format 1 (no manifest) loads
_PROC = 0   # the only process shard this port writes


class CheckpointCorrupt(RuntimeError):
    """A step dir failed integrity validation (truncated / checksum
    mismatch / missing manifest in a format-2 dir)."""


def _leaf_bytes(t) -> bytes:
    """The bytes a leaf's CRC is taken over: the array's C-order bytes,
    bf16 as its 16-bit patterns (what the ``.params`` codec writes)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes()
        return t.numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _fsync_path(path: str) -> None:
    """fsync a file or directory so the atomic-rename commit is durable
    across power loss, not just a process crash."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _tensors(tree, out: list) -> None:
    """Every tensor of a tree of dicts, tuples and tensors, in order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensors(v, out)


def _rebuild(tree, it):
    """``tree`` with each tensor replaced by the next of ``it``."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


@torch.no_grad()
def _snapshot(tree):
    """(copy of ``tree``, CUDA events): every tensor copied into a fresh
    buffer with one ``torch._foreach_copy_`` per device on the current
    stream; on a CUDA device an event recorded after the copy."""
    leaves: List[torch.Tensor] = []
    _tensors(tree, leaves)
    copies: List[Optional[torch.Tensor]] = [None] * len(leaves)
    by_dev: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(leaves):
        by_dev.setdefault(t.device, []).append(i)
    events = []
    for dev, idx in by_dev.items():
        src = [leaves[i].detach() for i in idx]
        dst = [torch.empty_like(s, memory_format=torch.contiguous_format)
               for s in src]
        torch._foreach_copy_(dst, src)
        for i, d in zip(idx, dst):
            copies[i] = d
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
    return _rebuild(tree, iter(copies)), events


class CheckpointManager:
    """Save and restore train state under ``directory``: ``keep`` most
    recent complete steps (0 keeps all), writes in a background worker
    when ``async_save`` behind a queue of ``queue_depth``, each write
    retried ``retries`` times on an `OSError` with a backoff that starts
    at ``retry_backoff`` seconds and doubles.  ``last_write`` holds the
    latest committed write's step, seconds (fetch and write) and bytes."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 queue_depth: int = 2, retries: int = 3,
                 retry_backoff: float = 0.1):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.retries = int(retries)
        self.retry_backoff = float(retry_backoff)
        os.makedirs(directory, exist_ok=True)
        # bounded: if writes fall behind the step loop, save() blocks on
        # put() (honest back-pressure)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        self._worker: Optional[threading.Thread] = None
        self._fetch_stream = None   # the worker's CUDA stream
        # guards _error: written by the worker thread, read/cleared by
        # callers on the next save()/wait()/close()
        self._err_lock = threading.Lock()
        self._error = None
        # guards _inflight: steps whose write has not committed yet —
        # added by save() (caller thread), discarded by the worker;
        # _prune (worker thread) must never delete an in-flight step
        self._inflight_lock = threading.Lock()
        self._inflight: set = set()
        self.last_write: Optional[dict] = None
        self._cleanup_stale_tmp()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step:010d}")

    def _cleanup_stale_tmp(self):
        """Drop this process's tmp dirs left by a crashed predecessor —
        their step never committed (no manifest), so the bytes are
        dead."""
        suffix = f".tmp-{_PROC}"
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if name.startswith("ckpt-") and name.endswith(suffix):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- save ----------------------------------------------------------- #
    def save(self, step: int, net=None, trainer=None, iterator_state=None,
             extra=None) -> None:
        """Snapshot the state on its device (one copy; training may go on
        at once), then fetch and write it in the background worker
        (``async_save``) or here.  ``net`` and ``trainer`` may be None.
        The caller-visible stall is ``checkpoint_step_stall_seconds``."""
        t0 = time.perf_counter()
        self._raise_pending_error()
        work: Dict[str, Any] = {"step": int(step)}
        to_snap: Dict[str, Any] = {}
        if trainer is not None:
            to_snap["states"] = trainer.device_states()
            opt = trainer.optimizer
            work["trainer_host"] = {
                "num_update": opt.num_update,
                "index_update_count": dict(opt._index_update_count)}
        if net is not None:
            to_snap["params"] = dict(net._collect_params_with_prefix())
        if telemetry.enabled() \
                and "checkpoint_snapshot" not in telemetry.perf.programs():
            # the copy's bytes, counted once
            work["snap"], work["events"] = telemetry.perf.capture(
                "checkpoint_snapshot", _snapshot, to_snap)
        else:
            work["snap"], work["events"] = _snapshot(to_snap)
        # the stream's state is a few kilobytes: taken here, at the step
        state = _random.get_state()
        work["torch_rng"] = state.numpy()
        work["rng"] = _random.jax_pair(state)
        work["iterator_state"] = iterator_state
        work["extra"] = extra
        with self._inflight_lock:
            self._inflight.add(int(step))
        if self.async_save:
            self._ensure_worker()
            self._queue.put(work)
        else:
            self._run_write(work)
            self._raise_pending_error()
        if telemetry.enabled():
            telemetry.histogram("checkpoint_step_stall_seconds") \
                .observe(time.perf_counter() - t0)
            telemetry.gauge("checkpoint_queue_depth") \
                .set(self._queue.qsize())

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            try:
                self._run_write(item)
            finally:
                self._queue.task_done()

    def _run_write(self, work):
        """Fetch the snapshot and commit it, retrying transient
        filesystem errors with backoff.  Any error is parked for the
        caller (never raised on the worker thread)."""
        step = work["step"]
        t0 = time.perf_counter()
        try:
            arrays, blob = self._materialize(work)
            delay = self.retry_backoff
            for attempt in range(self.retries + 1):
                try:
                    written = self._write(step, arrays, blob)
                    break
                except OSError:
                    # transient write failure (full or flaky disk): clean
                    # the tmp dir and retry with backoff
                    shutil.rmtree(self._step_dir(step) + f".tmp-{_PROC}",
                                  ignore_errors=True)
                    if attempt >= self.retries:
                        raise
                    if telemetry.enabled():
                        telemetry.counter(
                            "checkpoint_write_retries_total").inc()
                    time.sleep(delay)
                    delay *= 2
            self.last_write = {"step": step, "bytes": written,
                               "seconds": time.perf_counter() - t0}
            if telemetry.enabled():
                telemetry.histogram("checkpoint_write_seconds") \
                    .observe(self.last_write["seconds"])
                telemetry.counter("checkpoint_bytes_total").inc(written)
        except Exception as e:  # surfaced on the next save()/wait()/close()
            with self._err_lock:
                self._error = e
        finally:
            with self._inflight_lock:
                self._inflight.discard(step)

    def _materialize(self, work):
        """Snapshot -> (arrays, blob) on the host, one tensor at a time,
        after the snapshot's copy has run on the card."""
        for ev in work.pop("events"):
            ev.synchronize()
        snap = work.pop("snap")
        ctx = self._fetch_context(snap)
        with ctx:
            arrays = {f"param:{name}": t.cpu()
                      for name, t in (snap.get("params") or {}).items()}
            blob: Dict[str, Any] = {"step": work["step"]}
            if "trainer_host" in work:
                blob["trainer"] = dict(work["trainer_host"])
                blob["trainer"]["states"] = {
                    k: state_to_host(st)
                    for k, st in snap["states"].items()}
        blob["rng"] = work["rng"]
        blob["torch_rng"] = work["torch_rng"]
        blob["iterator_state"] = work["iterator_state"]
        blob["extra"] = work["extra"]
        return arrays, blob

    def _fetch_context(self, snap):
        """Fetch on a stream of the worker's own (the training stream
        stays free); the snapshot's copy has already finished."""
        leaves: List[torch.Tensor] = []
        _tensors(snap, leaves)
        dev = next((t.device for t in leaves if t.device.type == "cuda"),
                   None)
        if dev is None:
            return contextlib.nullcontext()
        if self._fetch_stream is None:
            self._fetch_stream = torch.cuda.Stream(dev)
        return torch.cuda.stream(self._fetch_stream)

    def _write(self, step: int, arrays, blob) -> int:
        """Commit one step: files into a tmp dir, the integrity manifest
        last, fsync, then atomic renames into the final dir (the manifest
        last) and ``meta.json``; then prune.  Returns bytes written."""
        final = self._step_dir(step)
        tmp = final + f".tmp-{_PROC}"
        os.makedirs(tmp, exist_ok=True)
        arrays_name = f"arrays-proc{_PROC}"
        state_name = f"state-proc{_PROC}.pkl"
        serialization.save_ndarrays(os.path.join(tmp, arrays_name), arrays)
        with open(os.path.join(tmp, state_name), "wb") as f:
            pickle.dump(blob, f)
        leaves = {}
        for k, v in arrays.items():
            b = _leaf_bytes(v)
            leaves[k] = {"crc32": zlib.crc32(b), "bytes": len(b),
                         "shape": list(v.shape), "dtype": _dtype_name(v)}
        manifest = {
            "format": FORMAT, "step": int(step), "proc": _PROC,
            "files": {
                arrays_name: {
                    "bytes": os.path.getsize(os.path.join(tmp, arrays_name)),
                    "crc32": _file_crc(os.path.join(tmp, arrays_name)),
                    "leaves": leaves,
                },
                state_name: {
                    "bytes": os.path.getsize(os.path.join(tmp, state_name)),
                    "crc32": _file_crc(os.path.join(tmp, state_name)),
                },
            },
        }
        # written last: its presence certifies every byte of the step
        with open(os.path.join(tmp, f"manifest-proc{_PROC}.json"), "w") as f:
            json.dump(manifest, f)
        written = sum(v["bytes"] for v in manifest["files"].values())
        # durability before visibility
        for fn in os.listdir(tmp):
            _fsync_path(os.path.join(tmp, fn))
        os.makedirs(final, exist_ok=True)
        names = sorted(os.listdir(tmp),
                       key=lambda n: n.startswith("manifest-"))
        for fn in names:
            os.replace(os.path.join(tmp, fn), os.path.join(final, fn))
        shutil.rmtree(tmp, ignore_errors=True)
        meta = {"step": int(step), "nproc": 1, "format": FORMAT}
        mtmp = os.path.join(final, ".meta.tmp")
        with open(mtmp, "w") as f:
            json.dump(meta, f)
        os.replace(mtmp, os.path.join(final, "meta.json"))
        _fsync_path(final)
        self._prune()
        return written

    def _prune(self):
        """Retention by committed steps only; a step whose write is still
        in flight is never deleted."""
        if not self.keep:
            return
        with self._inflight_lock:
            inflight = set(self._inflight)
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            if s in inflight:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def wait(self):
        """Drain pending async writes (the worker stays up for more
        saves — use close() at end of life)."""
        if self._worker is not None and self._worker.is_alive():
            self._queue.join()
        self._raise_pending_error()

    def close(self, timeout: Optional[float] = None):
        """Flush pending saves, then stop and join the worker thread.
        Idempotent; save() after close() restarts the worker."""
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)          # stop sentinel — see _drain
            self._worker.join(timeout)
        self._worker = None
        self._raise_pending_error()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def _raise_pending_error(self):
        with self._err_lock:
            e, self._error = self._error, None
        if e is not None:
            raise e

    # -- inspection / validation ---------------------------------------- #
    def _meta(self, step: int) -> Optional[dict]:
        try:
            with open(os.path.join(self._step_dir(step), "meta.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _manifest(self, step: int, proc: int) -> Optional[dict]:
        path = os.path.join(self._step_dir(step), f"manifest-proc{proc}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _is_complete(self, step: int) -> bool:
        """A step counts only when its ``meta.json`` and every process
        shard it records exist; a format-2 shard also needs its manifest
        with every listed file at the recorded size."""
        d = self._step_dir(step)
        meta = self._meta(step)
        if meta is None:
            return False
        fmt = meta.get("format", 1)
        for k in range(meta.get("nproc", 1)):
            if not (os.path.exists(os.path.join(d, f"state-proc{k}.pkl"))
                    and os.path.exists(os.path.join(d, f"arrays-proc{k}"))):
                return False
            if fmt >= 2:
                man = self._manifest(step, k)
                if man is None:
                    return False
                for fn, rec in man.get("files", {}).items():
                    try:
                        if os.path.getsize(os.path.join(d, fn)) \
                                != rec["bytes"]:
                            return False
                    except OSError:
                        return False
        return True

    def _raw_steps(self) -> List[int]:
        """Every ckpt-* step dir on disk, complete or not (tmp dirs
        excluded)."""
        steps = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return steps
        for name in names:
            if name.startswith("ckpt-") and ".tmp" not in name:
                try:
                    steps.append(int(name.split("-")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def all_steps(self) -> List[int]:
        return [s for s in self._raw_steps() if self._is_complete(s)]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def validate(self, step: int) -> None:
        """Full integrity check of ``step``'s shard: manifest present
        (format 2), whole-file checksums match.  Raises
        `CheckpointCorrupt`; format-1 dirs pass vacuously."""
        d = self._step_dir(step)
        meta = self._meta(step)
        if meta is None:
            raise CheckpointCorrupt(f"step {step}: no meta.json")
        fmt = meta.get("format", 1)
        man = self._manifest(step, _PROC)
        if man is None:
            if fmt >= 2:
                raise CheckpointCorrupt(
                    f"step {step}: manifest-proc{_PROC}.json missing from a "
                    f"format-{fmt} checkpoint")
            return
        for fn, rec in man.get("files", {}).items():
            path = os.path.join(d, fn)
            try:
                size = os.path.getsize(path)
            except OSError:
                raise CheckpointCorrupt(f"step {step}: {fn} missing")
            if size != rec["bytes"]:
                raise CheckpointCorrupt(
                    f"step {step}: {fn} truncated ({size} != {rec['bytes']} "
                    f"bytes)")
            if _file_crc(path) != rec["crc32"]:
                raise CheckpointCorrupt(
                    f"step {step}: {fn} checksum mismatch")

    # -- restore -------------------------------------------------------- #
    def _load_step(self, step: int, validate: bool):
        """Load (and optionally checksum) one step; raises on any
        corruption."""
        if not self._is_complete(step):
            raise CheckpointCorrupt(f"step {step}: incomplete step dir")
        if validate:
            self.validate(step)
        d = self._step_dir(step)
        loaded = serialization.load_ndarrays(
            os.path.join(d, f"arrays-proc{_PROC}"))
        if isinstance(loaded, list):
            loaded = {}
        man = self._manifest(step, _PROC)
        if validate and man is not None:
            leaves = man["files"].get(f"arrays-proc{_PROC}", {}) \
                .get("leaves", {})
            for name, rec in leaves.items():
                if name not in loaded:
                    raise CheckpointCorrupt(
                        f"step {step}: array leaf {name!r} missing")
                if zlib.crc32(_leaf_bytes(loaded[name])) != rec["crc32"]:
                    raise CheckpointCorrupt(
                        f"step {step}: array leaf {name!r} checksum "
                        f"mismatch")
        with open(os.path.join(d, f"state-proc{_PROC}.pkl"), "rb") as f:
            blob = pickle.load(f)
        return loaded, blob

    def restore(self, step: Optional[int] = None, net=None, trainer=None,
                validate: bool = True) -> Dict:
        """Load a step into ``net`` and ``trainer`` (in place) and the
        thread's random stream; returns ``{step, iterator_state,
        extra}``.  Without ``step`` the newest complete step restores,
        and a corrupt or incomplete one is skipped with a warning (the
        previous complete step restores instead); a pinned ``step`` that
        fails validation raises."""
        avail = self.all_steps()
        if step is not None:
            loaded, blob = self._load_step(step, validate)
            chosen = step
        else:
            if not avail:
                for s in self._raw_steps():
                    warnings.warn(
                        f"checkpoint step {s} in {self.directory} is "
                        f"incomplete (interrupted write?) — ignored",
                        RuntimeWarning)
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
            chosen = loaded = blob = None
            for s in reversed(avail):
                try:
                    loaded, blob = self._load_step(s, validate)
                    chosen = s
                    break
                except Exception as e:
                    warnings.warn(
                        f"checkpoint step {s} unusable "
                        f"({type(e).__name__}: {e}) — falling back to the "
                        f"previous complete step", RuntimeWarning)
                    if telemetry.enabled():
                        telemetry.counter(
                            "checkpoint_restore_skipped_total").inc()
            if chosen is None:
                raise CheckpointCorrupt(
                    f"no restorable checkpoint in {self.directory}: every "
                    f"complete step failed validation ({avail})")
            for s in self._raw_steps():
                if s > chosen and s not in avail:
                    warnings.warn(
                        f"checkpoint step {s} in {self.directory} is "
                        f"incomplete (interrupted write?) — restored step "
                        f"{chosen} instead", RuntimeWarning)
        if net is not None:
            params = net._collect_params_with_prefix()
            for k, arr in loaded.items():
                if k.startswith("param:"):
                    name = k[len("param:"):]
                    if name in params:
                        params[name].set_data(arr)
        if trainer is not None and "trainer" in blob:
            tr = blob["trainer"]
            trainer.restore_states(tr["states"], tr["num_update"],
                                   tr["index_update_count"])
        if blob.get("torch_rng") is not None:
            _random.set_state(blob["torch_rng"])
        else:
            key, ctr = blob["rng"]
            _random.set_state((np.asarray(key), int(ctr)))
        return {"step": blob["step"],
                "iterator_state": blob.get("iterator_state"),
                "extra": blob.get("extra")}

