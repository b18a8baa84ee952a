"""Crash/preemption flight recorder (the port of
`incubator_mxnet_tpu/telemetry/flight_recorder.py`).

A lock-light ring buffer of the last N step records — step index, span
tree, metric snapshot + counter deltas, retrace events — that installs
SIGTERM/SIGINT and fatal-exception hooks and, on abnormal exit, dumps a
self-contained JSONL + chrome-trace bundle the post-mortem (a
kill-and-resume flow) can consume without the process that
died.  A handler chains to the one it replaced and, where that was the
default, re-delivers the signal, so the exit code stays 128+signum.

Activation (all OFF by default; `_on_step` is one attribute read when
not installed, riding the registry's near-zero disabled path):

* ``MXTPU_FLIGHT_DIR=path``  enable telemetry + install the recorder;
  bundles land in `path`;
* ``MXTPU_FLIGHT_STEPS=N``   ring size, default 16 step records;
* programmatically: ``flight_recorder.install(dirpath, steps=)``
  (``signals=False`` leaves the signal handlers alone: the ring, the
  exception hook and `dump` only).

Bundle layout (``flight.jsonl``): line 1 is a ``flight_meta`` object
(reason, pid, wall time, last step, record count); each further line is
one step record, oldest first, the last step record being the in-flight
step at dump time; after the step records come the registered
subsystem sections (``{"section": name, "data": ...}`` — e.g. the
serving engine's in-flight requests + recent trace ring).
``flight_trace.json`` is the telemetry spans' chrome trace over the
same window.

Step records are appended by the `mark_step` callback chain
(telemetry.__init__._on_step) — a deque append plus an unlocked metric
sweep; no locks are held across user code and signal handlers only ever
read + write files.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import registry as _registry_mod, tracer as _tracer

__all__ = ["install", "uninstall", "installed", "record_step", "records",
           "dump", "DEFAULT_STEPS", "register_section",
           "unregister_section"]

DEFAULT_STEPS = 16

# subsystem dump hooks: name -> callable() -> JSON-able object.  Each
# contributes one {"section": name, "data": ...} line to flight.jsonl
# (the serving engine registers its in-flight request table + recent
# trace ring here, so a SIGTERM bundle explains what was being served)
_sections: Dict[str, object] = {}


def register_section(name: str, fn) -> None:
    """Register a dump contributor (idempotent per name; callbacks run
    inside the signal-time dump and MUST be cheap, lock briefly and
    never touch the device)."""
    _sections[name] = fn


def unregister_section(name: str) -> None:
    _sections.pop(name, None)

_lock = threading.Lock()   # guards install/uninstall/dump, not appends
_ring: Optional[deque] = None
_dir: Optional[str] = None
_prev_counts: Dict[str, float] = {}
_prev_handlers: dict = {}
_prev_excepthook = None
_dumped = False


def _reg() -> _registry_mod.Registry:
    from . import get_registry

    return get_registry()


def installed() -> bool:
    return _ring is not None


def _label_key(m) -> str:
    if not m.labels:
        return m.name
    inner = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
    return f"{m.name}{{{inner}}}"


def _metric_snapshot():
    """(snapshot, monotonic-counts) over the registry — unlocked value
    reads (a torn read near a concurrent update is one sample off,
    which a forensic record tolerates; taking every metric lock on the
    hot step path would not be lock-light)."""
    snap: Dict[str, object] = {}
    counts: Dict[str, float] = {}
    for m in _reg().metrics():
        k = _label_key(m)
        kind = m.kind
        if kind == "histogram":
            c, s = m.count, m.sum
            snap[k] = {"count": c, "sum": s}
            counts[k] = float(c)
        else:
            v = m.value
            snap[k] = v
            if kind == "counter":
                counts[k] = float(v)
    return snap, counts


def record_step(step: int) -> Optional[dict]:
    """Append one step record for `step` (its spans are complete once
    the NEXT mark_step fires; the dump path calls this directly for the
    in-flight step).  No-op unless installed."""
    ring = _ring
    if ring is None:
        return None
    global _prev_counts
    snap, counts = _metric_snapshot()
    prev = _prev_counts
    deltas = {k: v - prev.get(k, 0.0) for k, v in counts.items()
              if v != prev.get(k, 0.0)}
    _prev_counts = counts
    rec = {
        "step": step,
        "ts": time.time(),
        "spans": [s.as_dict() for s in _tracer.spans(step=step)],
        "metrics": snap,
        "deltas": deltas,
        "retraces": deltas.get("retraces_total", 0.0),
    }
    ring.append(rec)
    return rec


def _on_step(step: int) -> None:
    """mark_step hook (wired through telemetry.__init__._on_step):
    records the step that just FINISHED (step - 1; spans of the new
    step haven't run yet).  One attribute read when not installed."""
    if _ring is None:
        return
    if step > 1:
        record_step(step - 1)


def records() -> List[dict]:
    ring = _ring
    return list(ring) if ring is not None else []


def dump(reason: str = "manual", dirpath: Optional[str] = None) -> Optional[dict]:
    """Write the bundle (flight.jsonl + flight_trace.json).  Appends a
    final record for the current in-flight step so the last step's span
    tree and metric snapshot are always present.  Returns the paths, or
    None when not installed."""
    if _ring is None:
        return None
    # Try-lock, not `with _lock:` — dump() runs from signal handlers
    # (SIGTERM/SIGABRT), and the interrupted thread may already hold
    # _lock (mid-record_step).  A blocking acquire would deadlock the
    # process inside the handler; losing the dump is the lesser evil.
    if not _lock.acquire(timeout=2.0):
        return None
    try:
        step = _tracer.current_step()
        record_step(step)
        recs = list(_ring)
        out_dir = dirpath or _dir or "."
        os.makedirs(out_dir, exist_ok=True)
        meta = {"flight_meta": {
            "reason": reason,
            "pid": os.getpid(),
            "time": time.time(),
            "step": step,
            "records": len(recs),
            "ring_size": _ring.maxlen,
        }}
        jsonl_path = os.path.join(out_dir, "flight.jsonl")
        with open(jsonl_path, "w") as f:
            f.write(json.dumps(meta) + "\n")
            for r in recs:
                f.write(json.dumps(r) + "\n")
            for name, fn in sorted(_sections.items()):
                try:
                    sec = {"section": name, "data": fn()}
                except Exception as e:  # a broken hook must not lose the rest
                    sec = {"section": name,
                           "error": f"{type(e).__name__}: {e}"}
                f.write(json.dumps(sec, default=str) + "\n")
        from . import exporters

        trace_path = os.path.join(out_dir, "flight_trace.json")
        with open(trace_path, "w") as f:
            json.dump(exporters.chrome_trace(), f)
    finally:
        _lock.release()
    return {"jsonl": jsonl_path, "trace": trace_path}


def _dump_once(reason: str) -> None:
    global _dumped
    if _dumped:
        return
    _dumped = True
    try:
        dump(reason)
    except Exception:
        pass  # a failing dump must never mask the original death


def _signal_handler(signum, frame):
    name = signal.Signals(signum).name \
        if hasattr(signal, "Signals") else str(signum)
    _dump_once(f"signal:{name}")
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
    else:
        # re-deliver with the default disposition so the exit code is
        # the conventional 128+signum the preemption tooling expects
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def _excepthook(exc_type, exc, tb):
    _dump_once(f"exception:{exc_type.__name__}")
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def install(dirpath: Optional[str] = None, steps: Optional[int] = None,
            signals: bool = True) -> None:
    """Install the recorder: allocate the ring and hook SIGTERM/SIGINT
    (unless ``signals`` is false) + sys.excepthook (previous handlers
    are chained).  Idempotent; signal hooks are skipped off the main
    thread (Python restricts signal.signal to it) — the exception hook
    still installs."""
    global _ring, _dir, _prev_excepthook, _dumped
    with _lock:
        if _ring is not None:
            _dir = dirpath or _dir
            return
        n = steps if steps is not None else \
            int(os.environ.get("MXTPU_FLIGHT_STEPS", str(DEFAULT_STEPS)) or
                DEFAULT_STEPS)
        _ring = deque(maxlen=max(1, n))
        _dir = dirpath or os.environ.get("MXTPU_FLIGHT_DIR", ".")
        _dumped = False
        _prev_counts.clear()
        if signals and \
                threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    _prev_handlers[sig] = signal.signal(sig, _signal_handler)
                except (ValueError, OSError):  # pragma: no cover
                    pass
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook


def uninstall() -> None:
    """Remove hooks and drop the ring (tests / clean shutdown)."""
    global _ring, _prev_excepthook
    with _lock:
        if _ring is None:
            return
        if threading.current_thread() is threading.main_thread():
            for sig, prev in list(_prev_handlers.items()):
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):  # pragma: no cover
                    pass
        _prev_handlers.clear()
        if _prev_excepthook is not None:
            sys.excepthook = _prev_excepthook
            _prev_excepthook = None
        _ring = None
        _prev_counts.clear()
