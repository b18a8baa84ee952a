"""Per-request lifecycle traces + a bounded ring of recent requests (the
port of `incubator_mxnet_tpu/telemetry/requestlog.py`, unchanged).

The serving metrics say *that* the engine shed or evicted; this module
records *why one particular request* was slow, shed or evicted — the
forensic unit the ``/requestz`` endpoint and the flight recorder's
serving section serve.

A `RequestTrace` is an append-only timeline of ``(name, t, attrs)``
events covering the whole lifecycle::

    submit -> queued -> admitted -> prefill -> decode* -> done
                  \\-> shed(reason)        (terminal alternatives:
                       evicted / cancelled / failed)

Events carry host-side annotations only (block ids, batch occupancy,
queue depth — never device data; the no-host-sync rule applies here
too).  Requests REJECTED before admission get a complete trace as well
(submit -> shed), so the ring explains rejected traffic, not just
served traffic.

Completed traces land in a module-level bounded ring
(``MXTPU_REQUESTLOG_RING`` entries, default 256) shared by every
engine in the process; `chrome_trace()` / `jsonl_lines()` /
`dump(dir)` export it in the repo's standard formats, and
``telemetry/http.py`` serves the same snapshot live.

Thread-safety: a trace is appended to by the submitting thread and the
scheduler thread and read by HTTP handler threads, so each trace
carries its own lock; the ring has another.  Both are held only for
list append/copy — never across user code or device calls.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["RequestTrace", "TraceRing", "ring", "push", "recent",
           "clear", "chrome_trace", "jsonl_lines", "dump",
           "DEFAULT_RING"]

DEFAULT_RING = 256

# process-wide request ids: engines come and go, the ring outlives them
_next_rid = itertools.count(1)


class RequestTrace:
    """Append-only event timeline of one request's lifecycle.

    ``t`` values are ``time.monotonic`` seconds (the `Request` timing
    clock); `as_dict()` is JSON-ready and what the ring stores.
    """

    __slots__ = ("rid", "meta", "events", "_lock")

    def __init__(self, meta: Optional[Dict] = None,
                 rid: Optional[int] = None):
        self.rid = int(rid) if rid is not None else next(_next_rid)
        self.meta = dict(meta) if meta else {}
        self.events: List[dict] = []
        self._lock = threading.Lock()

    def event(self, name: str, t: Optional[float] = None, **attrs) -> None:
        rec = {"name": name,
               "t": float(t) if t is not None else time.monotonic()}
        if attrs:
            rec.update(attrs)
        with self._lock:
            self.events.append(rec)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self.events]

    @property
    def terminal(self) -> Optional[str]:
        """Name of the last event if it is a terminal status, else None."""
        with self._lock:
            last = self.events[-1]["name"] if self.events else None
        return last if last in ("done", "shed", "evicted", "cancelled",
                                "failed") else None

    def as_dict(self) -> dict:
        events = self.snapshot()
        out = {"rid": self.rid, "events": events}
        if self.meta:
            out["meta"] = dict(self.meta)
        if events:
            out["t_start"] = events[0]["t"]
            out["t_end"] = events[-1]["t"]
            out["status"] = events[-1]["name"]
        return out

    def __repr__(self):
        return (f"RequestTrace(rid={self.rid}, "
                f"events={[e['name'] for e in self.snapshot()]})")


class TraceRing:
    """Bounded ring of completed trace dicts (newest last)."""

    def __init__(self, cap: int = DEFAULT_RING):
        self._ring: deque = deque(maxlen=max(1, int(cap)))
        self._lock = threading.Lock()
        self._pushed = 0

    @property
    def cap(self) -> int:
        return self._ring.maxlen

    @property
    def pushed(self) -> int:
        """Total traces ever pushed (ring length saturates; this doesn't)."""
        return self._pushed

    def push(self, trace) -> None:
        rec = trace.as_dict() if isinstance(trace, RequestTrace) else trace
        with self._lock:
            self._ring.append(rec)
            self._pushed += 1

    def recent(self, n: Optional[int] = None) -> List[dict]:
        """The last ``n`` completed traces, oldest first (all by default)."""
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-int(n):]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pushed = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_default_ring = TraceRing(
    int(os.environ.get("MXTPU_REQUESTLOG_RING", str(DEFAULT_RING))
        or DEFAULT_RING))


def ring() -> TraceRing:
    return _default_ring


def push(trace) -> None:
    """Push a completed trace into the process-wide ring."""
    _default_ring.push(trace)


def recent(n: Optional[int] = None) -> List[dict]:
    return _default_ring.recent(n)


def clear() -> None:
    _default_ring.clear()


def chrome_trace(traces: Optional[List[dict]] = None) -> dict:
    """The ring (or an explicit trace list) as a chrome://tracing dict.

    Each request renders as one ``tid`` lane: an ``X`` slice per phase
    segment (submit->queued->admitted->...; the segment is named after
    the event that OPENS it) plus an instant ``i`` mark for the
    terminal event, annotations riding in ``args``.  Interleaves with
    the span tracer's export (same monotonic clock family on the
    platforms we run on).
    """
    events = []
    pid = os.getpid()
    for tr in (traces if traces is not None else recent()):
        evs = tr.get("events", [])
        rid = tr.get("rid", 0)
        for i, ev in enumerate(evs):
            args = {k: v for k, v in ev.items() if k not in ("name", "t")}
            args.update(tr.get("meta", {}))
            if i + 1 < len(evs):
                dur = max(0.0, evs[i + 1]["t"] - ev["t"])
                events.append({
                    "name": ev["name"], "cat": "request", "ph": "X",
                    "ts": ev["t"] * 1e6, "dur": dur * 1e6,
                    "pid": pid, "tid": rid, "args": args})
            else:
                events.append({
                    "name": ev["name"], "cat": "request", "ph": "i",
                    "ts": ev["t"] * 1e6, "s": "t",
                    "pid": pid, "tid": rid, "args": args})
    events.sort(key=lambda e: e.get("ts", 0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def jsonl_lines(traces: Optional[List[dict]] = None) -> List[str]:
    """One JSON object per completed request trace, oldest first."""
    return [json.dumps(tr)
            for tr in (traces if traces is not None else recent())]


def dump(dirpath: Optional[str] = None) -> Dict[str, str]:
    """Write requests.jsonl + requests_trace.json; returns the paths."""
    dirpath = dirpath or os.environ.get("MXTPU_TELEMETRY_DIR", ".")
    os.makedirs(dirpath, exist_ok=True)
    traces = recent()
    jsonl_path = os.path.join(dirpath, "requests.jsonl")
    with open(jsonl_path, "w") as f:
        for line in jsonl_lines(traces):
            f.write(line + "\n")
    trace_path = os.path.join(dirpath, "requests_trace.json")
    with open(trace_path, "w") as f:
        json.dump(chrome_trace(traces), f)
    return {"jsonl": jsonl_path, "trace": trace_path}
