"""Unified timeline profiler + decode-stall attribution (the port of
`incubator_mxnet_tpu/telemetry/profiler.py`; the ledger's arithmetic is
the JAX package's, so the same notes give the same tables).

Two halves, mirroring the reference MXNet's ``src/profiler/``
operator/phase-scoped timeline for the serving stack:

**Per-step stall ledger.**  `EngineProfiler` is an always-on, bounded
host-side ledger the serving scheduler feeds: every scheduler-loop
phase notes its wall time under a named cause, and at each decode-step
commit `end_step()` closes one ledger decomposing the step's wall time
(measured from the previous step's commit, so prefill interleave, lock
waits and idle polls between steps are attributed, not lost) into:

    device_step     decode device call (fault-hook injection included)
    prefill         interleaved prefill device calls (legacy cause;
                    chunked prefill notes prefill_chunk)
    prefill_chunk   interleaved fixed-width prefill-chunk device calls
    gather_params   weight gather / requantize for the program call
    lock_wait       scheduler blocked acquiring the engine lock
    bookkeeping     reap + admission reservation + commit sections
    wait            idle condition-wait polls (no live lanes)
    gc              GC pauses on the scheduler thread (``gc.callbacks``)
    host_other      unattributed residue

The invariant is that the causes sum to the step wall time: phases are
disjoint intervals by construction, ``host_other`` is the exact
remainder, and ``gc`` is carved out of that remainder (a pause inside a
timed phase is already inside that phase's interval — carving keeps the
sum exact instead of double-counting).  Violations beyond tolerance are
counted (``invariant_violations``).
Causes export as ``serving_step_stall_seconds{cause=}`` histograms when
telemetry is enabled; a hiccup detector flags steps slower than
k × rolling-p50 and records a full-detail stall record (per-cause
breakdown, co-resident rids, occupancy, queue depth) into a bounded
ring served by ``/stallz`` and bundled by the flight recorder.

**Merged capture.**  `capture(seconds)` (HTTP: ``/profilez?seconds=N``,
engine: ``ServingEngine.capture_profile()``) assembles ONE
chrome-trace/Perfetto JSON with named pid/tid lanes from the streams
that export separately: requestlog lifecycle spans (one lane per
rid), tracer spans (per real thread), engine scheduler phases (one
synthetic lane per engine), program timings from `telemetry.perf` (a
device-timed run sits at its host launch time, with its device
duration),
GC pauses and lock-witness contention events — so a single trace shows
a request's admit→prefill→decode marks aligned against the engine loop
that served it.  All streams share the CLOCK_MONOTONIC family
(``time.perf_counter`` / ``time.monotonic`` on the platforms we run
on), so events interleave on one axis.  `validate_chrome_trace` is the
conformance checker the tests and ``chip_smoke.py`` load traces with.

Knobs (environment):

* ``MXTPU_SERVING_PROFILER=0``   kill switch — ledger records nothing
  (the <5 µs/step disabled path the overhead test pins);
* ``MXTPU_PROFILER_HICCUP_K=K``  hiccup threshold multiplier over the
  rolling p50 (default 3.0);
* ``MXTPU_STALLZ_RING=N``        hiccup ring size (default 64).

THE NO-HOST-SYNC RULE applies: everything here reads host clocks,
already-host ints, or bounded deques — never device data.

Thread-safety: the ledger's accumulation dict and event deque are
touched only by the scheduler thread (`note`/`end_step`); published
aggregates (totals, hiccup ring, recent ledgers) are guarded by one
leaf lock held only for copies — never while acquiring another lock,
so the runtime lock witness records no new ordering edges through it.
"""
from __future__ import annotations

import gc
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import registry as _registry_mod

__all__ = ["EngineProfiler", "register", "unregister", "profilers",
           "stallz", "merged_chrome_trace", "capture",
           "validate_chrome_trace", "install_gc_hooks",
           "uninstall_gc_hooks", "gc_hooks_installed", "gc_events",
           "gc_pause_seconds", "snapshot_lock_witness",
           "DEFAULT_HICCUP_K", "DEFAULT_STALL_RING",
           "CAUSES", "MAX_CAPTURE_S"]

DEFAULT_HICCUP_K = float(os.environ.get("MXTPU_PROFILER_HICCUP_K", "3.0")
                         or 3.0)
DEFAULT_STALL_RING = int(os.environ.get("MXTPU_STALLZ_RING", "64") or 64)
# ledger causes (the serving_step_stall_seconds{cause=} label set);
# draft_step/verify_step are the speculative-decoding iteration's two
# device phases — a speculative engine notes those instead of
# device_step
CAUSES = ("device_step", "draft_step", "verify_step", "prefill",
          "prefill_chunk", "gather_params", "lock_wait", "bookkeeping",
          "wait", "gc", "host_other")
# /profilez sleeps on an HTTP handler thread — bound it
MAX_CAPTURE_S = 30.0
# phase events shorter than this don't land in the trace deque (a 2 µs
# bookkeeping note per idle poll would drown the lane)
_EVENT_MIN_S = 20e-6
_EVENT_BUF = 8192
# steps a hiccup judgment needs in the rolling window before firing
_MIN_SAMPLES = 8
# and an absolute floor so microsecond jitter on an idle engine never
# "hiccups" (1 ms is far above any healthy CPU-smoke step residue)
_MIN_HICCUP_WALL_S = 1e-3


def _reg():
    from . import get_registry

    return get_registry()


def _snap_deque(dq: deque) -> list:
    """Copy a lock-free deque that other threads (or a GC callback
    firing inside THIS thread's allocations) may append to mid-copy —
    a bounded deque rotates on append, so plain iteration can raise
    ``deque mutated during iteration``.  Retry; an event ring a few
    appends newer is equally valid, losing the copy is not."""
    for _ in range(8):
        try:
            return list(dq)
        except RuntimeError:
            continue
    return []  # pragma: no cover — 8 consecutive mid-copy rotations


# --------------------------------------------------------------------- #
# GC pause accounting (gc.callbacks)
# --------------------------------------------------------------------- #
# The callback runs on whichever thread triggered the collection, so a
# per-thread cumulative lets the scheduler's ledger attribute exactly
# the pauses that interrupted IT.  Written only by the collecting
# thread under the GIL (per-tid key), read by anyone — no lock needed.
_gc_tls = threading.local()
_gc_events: deque = deque(maxlen=2048)      # {"t0","dur","gen","tid"}
_gc_by_thread: Dict[int, float] = {}
_gc_installed = False


def _gc_callback(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_tls.t0 = time.perf_counter()
        return
    t0 = getattr(_gc_tls, "t0", None)
    if t0 is None:
        return
    _gc_tls.t0 = None
    dur = time.perf_counter() - t0
    tid = threading.get_ident()
    _gc_by_thread[tid] = _gc_by_thread.get(tid, 0.0) + dur
    _gc_events.append({"t0": t0, "dur": dur,
                       "gen": int(info.get("generation", -1)), "tid": tid})


def install_gc_hooks() -> None:
    """Hook ``gc.callbacks`` (idempotent; cheap enough to stay on for
    the process lifetime — one clock read per collection phase)."""
    global _gc_installed
    if _gc_installed:
        return
    gc.callbacks.append(_gc_callback)
    _gc_installed = True


def uninstall_gc_hooks() -> None:
    global _gc_installed
    if not _gc_installed:
        return
    try:
        gc.callbacks.remove(_gc_callback)
    except ValueError:
        pass
    _gc_installed = False


def gc_hooks_installed() -> bool:
    return _gc_installed


def gc_pause_seconds(tid: Optional[int] = None) -> float:
    """Cumulative GC pause seconds observed on one thread (default: the
    calling thread) since the hooks were installed."""
    return _gc_by_thread.get(
        tid if tid is not None else threading.get_ident(), 0.0)


def gc_events(since: Optional[float] = None) -> List[dict]:
    """Recent GC pause events (perf_counter t0/dur seconds), oldest
    first, optionally only those ending at/after ``since``."""
    out = [dict(e) for e in _snap_deque(_gc_events)]
    if since is not None:
        out = [e for e in out if e["t0"] + e["dur"] >= since]
    return out


# --------------------------------------------------------------------- #
# per-engine stall ledger
# --------------------------------------------------------------------- #
class EngineProfiler:
    """Bounded per-step stall-attribution ledger for one engine.

    The scheduler thread is the only caller of `note()`/`end_step()`
    (accumulation needs no lock); HTTP/flight readers go through
    `stallz()`/`stall_table()`/`chrome_events()`, which copy under one
    leaf lock.  ``clock`` and ``gc_seconds`` are injectable for the
    attribution-math tests.
    """

    def __init__(self, name: str, *, hiccup_k: Optional[float] = None,
                 ring: Optional[int] = None, window: int = 128,
                 clock: Callable[[], float] = time.perf_counter,
                 gc_seconds: Optional[Callable[[], float]] = None,
                 enabled: Optional[bool] = None):
        self.name = name
        self._clock = clock
        self._gc_seconds = gc_seconds if gc_seconds is not None \
            else gc_pause_seconds
        self._enabled = bool(enabled) if enabled is not None else \
            os.environ.get("MXTPU_SERVING_PROFILER", "1") != "0"
        self.hiccup_k = float(hiccup_k if hiccup_k is not None
                              else DEFAULT_HICCUP_K)
        self._causes: Dict[str, float] = {}      # scheduler thread only
        self._step_t0 = self._clock()
        self._last_gc = self._gc_seconds()
        self._walls: deque = deque(maxlen=max(8, int(window)))
        self._p50: Optional[float] = None
        self._p50_at = 0
        self.steps = 0
        self.hiccups_total = 0
        self.invariant_violations = 0
        self._events: deque = deque(maxlen=_EVENT_BUF)  # (name,cat,t0,dur)
        # published aggregates: copies only under this leaf lock, never
        # another lock while holding it (lock-witness discipline)
        self._pub = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._total_wall = 0.0
        self._hiccups: deque = deque(
            maxlen=max(1, int(ring if ring is not None
                              else DEFAULT_STALL_RING)))
        self._recent: deque = deque(maxlen=64)   # last-N step ledgers

    # -- hot path (scheduler thread) ----------------------------------- #
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        """Runtime kill switch (the enabled-vs-disabled CI A/B seam).
        Re-anchors the step window so a toggle never attributes the
        disabled era to the next step."""
        on = bool(on)
        if on and not self._enabled:
            self._causes = {}
            self._step_t0 = self._clock()
            self._last_gc = self._gc_seconds()
        self._enabled = on

    def note(self, cause: str, dur: float) -> None:
        """Accumulate ``dur`` seconds under ``cause`` for the step in
        progress.  One dict update when enabled; one flag read when not
        (the <5 µs disabled-path budget)."""
        if not self._enabled:
            return
        c = self._causes
        c[cause] = c.get(cause, 0.0) + dur
        if _registry_mod._enabled and dur >= _EVENT_MIN_S:
            # deque append is atomic under the GIL; readers copy
            self._events.append(
                (cause, "scheduler", self._clock() - dur, dur))

    def end_step(self, *, rids=(), occupancy: int = 0,
                 queue_depth: int = 0, step: int = 0) -> Optional[dict]:
        """Close the ledger at a decode-step commit: compute the wall
        since the previous commit, carve gc + residue, feed histograms,
        judge the hiccup threshold.  Returns the stall record when the
        step was flagged, else None."""
        if not self._enabled:
            return None
        now = self._clock()
        wall = now - self._step_t0
        self._step_t0 = now
        causes, self._causes = self._causes, {}
        attributed = 0.0
        for v in causes.values():
            attributed += v
        residue = wall - attributed
        cur_gc = self._gc_seconds()
        gc_dt = cur_gc - self._last_gc
        self._last_gc = cur_gc
        # a pause inside a timed phase already sits in that phase's
        # interval; only the part that fell in unattributed time can be
        # carved without breaking the sum-to-wall invariant
        gc_cause = min(gc_dt, residue) if gc_dt > 0 and residue > 0 else 0.0
        causes["gc"] = causes.get("gc", 0.0) + gc_cause
        causes["host_other"] = max(0.0, residue - gc_cause)
        self.steps += 1
        total = sum(causes.values())
        if wall > 0 and abs(total - wall) > 0.05 * wall + 1e-6:
            self.invariant_violations += 1
        if _registry_mod._enabled:
            reg = _reg()
            for cause, s in causes.items():
                reg.histogram("serving_step_stall_seconds",
                              {"cause": cause}).observe(s)
        # rolling p50 over the wall window, recomputed every 16 steps
        # (every step while the window is still small)
        walls = self._walls
        walls.append(wall)
        n = len(walls)
        if self._p50 is None or n < 16 \
                or self.steps - self._p50_at >= 16:
            self._p50 = sorted(walls)[n // 2]
            self._p50_at = self.steps
        p50 = self._p50
        rec = {"step": int(step), "t_end": now, "wall_s": wall,
               "causes": {k: round(v, 6) for k, v in causes.items()},
               "occupancy": int(occupancy),
               "queue_depth": int(queue_depth)}
        hic = None
        if (n >= _MIN_SAMPLES and p50 is not None and p50 > 0
                and wall > self.hiccup_k * p50
                and wall > _MIN_HICCUP_WALL_S):
            dominant = max(causes, key=causes.get)
            hic = dict(rec, dominant=dominant, p50_s=round(p50, 6),
                       ratio=round(wall / p50, 2),
                       rids=[int(r) for r in rids])
            self.hiccups_total += 1
            if _registry_mod._enabled:
                _reg().counter("serving_step_hiccups_total",
                               {"engine": self.name}).inc()
                self._events.append(
                    ("hiccup", "stall", now - wall, wall))
        with self._pub:
            t = self._totals
            for cause, s in causes.items():
                t[cause] = t.get(cause, 0.0) + s
            self._total_wall += wall
            self._recent.append(rec)
            if hic is not None:
                self._hiccups.append(hic)
        return hic

    # -- readers (any thread) ------------------------------------------ #
    def stall_table(self) -> List[dict]:
        """Aggregate attribution rows, biggest cause first:
        ``{"cause", "total_s", "share", "per_step_ms"}``."""
        with self._pub:
            totals = dict(self._totals)
            wall = self._total_wall
        steps = max(1, self.steps)
        rows = [{"cause": c, "total_s": round(s, 6),
                 "share": round(s / wall, 4) if wall > 0 else 0.0,
                 "per_step_ms": round(s / steps * 1e3, 4)}
                for c, s in totals.items()]
        rows.sort(key=lambda r: -r["total_s"])
        return rows

    def recent_stalls(self, n: Optional[int] = None) -> List[dict]:
        """Recent hiccup records, oldest first (all by default)."""
        with self._pub:
            out = [dict(h) for h in self._hiccups]
        return out if n is None else out[-int(n):]

    def recent_steps(self, n: Optional[int] = None) -> List[dict]:
        """Recent per-step ledgers (bounded ring), oldest first."""
        with self._pub:
            out = [dict(r) for r in self._recent]
        return out if n is None else out[-int(n):]

    def stallz(self) -> dict:
        """The per-engine ``/stallz`` payload: config, invariant
        health, the aggregate cause table, and the worst recent
        hiccups (slowest first)."""
        with self._pub:
            hiccups = [dict(h) for h in self._hiccups]
            ring_cap = self._hiccups.maxlen
        hiccups.sort(key=lambda h: -h["wall_s"])
        return {"engine": self.name, "enabled": self._enabled,
                "hiccup_k": self.hiccup_k, "steps": self.steps,
                "rolling_p50_s": None if self._p50 is None
                else round(self._p50, 6),
                "invariant_violations": self.invariant_violations,
                "hiccups_total": self.hiccups_total,
                "ring_cap": ring_cap,
                "attribution": self.stall_table(),
                "hiccups": hiccups}

    def chrome_events(self, since: Optional[float] = None) -> List[tuple]:
        """Phase-event tuples ``(name, cat, t0, dur)`` for the merged
        trace, optionally only those ending at/after ``since``."""
        out = _snap_deque(self._events)
        if since is not None:
            out = [e for e in out if e[2] + e[3] >= since]
        return out


# --------------------------------------------------------------------- #
# process-wide profiler registry (engines register at construction)
# --------------------------------------------------------------------- #
_profilers: Dict[str, EngineProfiler] = {}


def register(prof: EngineProfiler) -> EngineProfiler:
    _profilers[prof.name] = prof
    return prof


def unregister(name: str) -> None:
    _profilers.pop(name, None)


def profilers() -> Dict[str, EngineProfiler]:
    return dict(_profilers)


def stallz() -> dict:
    """The ``/stallz`` payload across every registered engine."""
    return {"engines": {name: p.stallz()
                        for name, p in sorted(_profilers.items())}}


def snapshot_lock_witness() -> bool:
    """Export the runtime lock witness's aggregates to the telemetry
    gauges if (and only if) the witness is installed — the periodic
    hook the engine rides so ``lock_witness_edges_total`` /
    ``lock_contention_seconds`` are scrapeable mid-run, not only after
    the end-of-run `assert_clean()`."""
    try:
        from .. import lock_witness
    except Exception:  # pragma: no cover — package always has it
        return False
    if not lock_witness.installed():
        return False
    lock_witness.snapshot()
    return True


# --------------------------------------------------------------------- #
# merged chrome-trace capture
# --------------------------------------------------------------------- #
# synthetic tid lanes (request lanes use the rid, real threads their
# ident — keep these far above both ranges and stable across captures)
_TID_SCHED_BASE = 900000
_TID_PROGRAMS = 990001
_TID_LOCKS = 990002


def _meta(pid: int, tid, name: str, sort: int) -> List[dict]:
    return [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}},
            {"name": "thread_sort_index", "ph": "M", "pid": pid,
             "tid": tid, "args": {"sort_index": sort}}]


def merged_chrome_trace(since: Optional[float] = None) -> dict:
    """ONE chrome-trace dict merging every timeline source in the
    process (see module docstring), with ``thread_name`` metadata
    naming each lane.  ``since`` (perf_counter seconds) keeps only
    events still in flight at or after that instant."""
    pid = os.getpid()
    events: List[dict] = []
    meta: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": "mxtpu"}}]
    cut = None if since is None else since * 1e6

    def keep(ev: dict) -> bool:
        return cut is None or ev["ts"] + ev.get("dur", 0.0) >= cut

    # 1. requestlog lifecycle spans: one lane per rid (already rendered
    #    by requestlog.chrome_trace — monotonic clock, same family)
    from . import requestlog

    rids = set()
    for ev in requestlog.chrome_trace()["traceEvents"]:
        if keep(ev):
            events.append(ev)
            rids.add(ev["tid"])
    for rid in sorted(rids):
        meta += _meta(pid, rid, f"request rid={rid}", 100 + rid)

    # 2. tracer spans: real thread lanes
    from . import tracer as _tracer

    tids = set()
    for s in _tracer.spans():
        ev = {"name": s.name, "cat": "telemetry", "ph": "X",
              "ts": s.t0 * 1e6, "dur": s.dur * 1e6, "pid": pid,
              "tid": s.tid, "args": {"step": s.step, "depth": s.depth}}
        if keep(ev):
            events.append(ev)
            tids.add(s.tid)

    # 3. engine scheduler phases: one synthetic lane per engine
    for i, (name, prof) in enumerate(sorted(_profilers.items())):
        tid = _TID_SCHED_BASE + i
        meta += _meta(pid, tid, f"{name} scheduler", 10 + i)
        for pname, cat, t0, dur in prof.chrome_events(since=since):
            events.append({"name": pname, "cat": cat, "ph": "X",
                           "ts": t0 * 1e6, "dur": dur * 1e6,
                           "pid": pid, "tid": tid,
                           "args": {"engine": name}})

    # 4. program timings (telemetry.perf's resolved runs)
    from . import perf as _perf

    prog_evs = _perf.recent_timings(since=since)
    if prog_evs:
        meta += _meta(pid, _TID_PROGRAMS, "programs", 50)
        for e in prog_evs:
            events.append({"name": e["program"], "cat": "program",
                           "ph": "X", "ts": e["t0"] * 1e6,
                           "dur": e["dur"] * 1e6, "pid": pid,
                           "tid": _TID_PROGRAMS, "args": {}})

    # 5. GC pauses: on their real thread lanes (they interrupt it)
    for e in gc_events(since=since):
        events.append({"name": f"gc(gen{e['gen']})", "cat": "gc",
                       "ph": "X", "ts": e["t0"] * 1e6,
                       "dur": e["dur"] * 1e6, "pid": pid,
                       "tid": e["tid"], "args": {}})
        tids.add(e["tid"])

    # 6. lock-witness contention events (only when installed)
    try:
        from .. import lock_witness

        cont = lock_witness.recent_contention(since=since) \
            if lock_witness.installed() else []
    except Exception:
        cont = []
    if cont:
        meta += _meta(pid, _TID_LOCKS, "lock contention", 60)
        for e in cont:
            events.append({"name": e["site"], "cat": "lock", "ph": "X",
                           "ts": e["t0"] * 1e6, "dur": e["dur"] * 1e6,
                           "pid": pid, "tid": _TID_LOCKS, "args": {}})

    for tid in sorted(tids):
        meta += _meta(pid, tid, f"thread {tid}", 200)
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def capture(seconds: float = 1.0) -> dict:
    """On-demand merged capture: let ``seconds`` of activity accumulate
    (bounded by ``MAX_CAPTURE_S``; 0 = everything still buffered), then
    assemble the merged trace for that window."""
    s = max(0.0, min(float(seconds), MAX_CAPTURE_S))
    if s <= 0.0:
        return merged_chrome_trace()
    t0 = time.perf_counter()
    time.sleep(s)
    return merged_chrome_trace(since=t0)


# --------------------------------------------------------------------- #
# trace conformance validator (shared by the tests and chip_smoke.py)
# --------------------------------------------------------------------- #
_KNOWN_PH = frozenset("XiIMBEC")


def validate_chrome_trace(trace) -> List[str]:
    """Conformance-check one chrome-trace dict (or its JSON string).
    Returns human-readable problems; an empty list means the trace
    loads in chrome://tracing / Perfetto:

    * top level is ``{"traceEvents": [...]}``;
    * every event has ``name``/``ph``/``pid``/``tid`` (+ numeric
      ``ts`` for non-metadata events);
    * ``X`` slices carry a numeric ``dur >= 0``;
    * non-metadata events are emitted in non-decreasing ``ts`` order
      (the lane/ts-monotonicity contract the tests pin).
    """
    problems: List[str] = []
    if isinstance(trace, (str, bytes)):
        try:
            trace = json.loads(trace)
        except ValueError as e:
            return [f"not JSON: {e}"]
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        return ["top level is not {'traceEvents': [...]}"]
    last_ts = None
    for i, ev in enumerate(trace["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        for k in ("name", "pid", "tid"):
            if k not in ev:
                problems.append(f"event {i} ({ev.get('name')!r}): "
                                f"missing {k!r}")
        if ph == "M":
            continue                      # metadata events carry no ts
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i} ({ev.get('name')!r}): "
                            f"non-numeric ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({ev.get('name')!r}): "
                                f"X slice with bad dur {dur!r}")
        if last_ts is not None and ts < last_ts:
            problems.append(f"event {i} ({ev.get('name')!r}): ts goes "
                            f"backwards ({ts} < {last_ts})")
        last_ts = ts
    return problems
