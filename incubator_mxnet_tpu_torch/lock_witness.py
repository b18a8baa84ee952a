"""Runtime lock witness — tpulint TPU013's reality cross-check (the port
of `incubator_mxnet_tpu/lock_witness.py`; the static graph is built
over the port's own sources).

Opt-in (``MXTPU_LOCK_WITNESS=1``) instrumentation that records the
*actual* per-thread lock-acquisition order while a test or a serving
run goes, then asserts

1. the observed held-while-acquiring graph is **acyclic** (no two
   threads ever acquired the same pair of locks in opposite order),
2. every observed edge is present in tpulint's **static** lock graph
   (``tools.tpulint.lock_rules.build_lock_graph``) — so the analyzer
   is validated against reality instead of only fixtures.

Mechanism: :func:`install` replaces ``threading.Lock``/``RLock`` with
factories that inspect the *creation* frame.  Locks constructed outside
the tracked roots (stdlib internals, third-party code) get the raw
primitive back — the disabled/foreign path has **zero** per-acquisition
overhead.  Package locks come back wrapped: the wrapper keys the lock
by its creation site ``(file, line)`` (the same join key the static
graph exports via ``LockGraph.sites()``), maintains a per-thread
held-stack, and records an edge ``held_site -> acquired_site`` on
every *blocking* acquisition — try-acquires (``blocking=False`` /
``timeout>=0``) never edge, mirroring TPU013's static semantics, but
do join the held-stack so later acquisitions see them as sources.

``threading.Condition(wrapped_lock)`` needs no special casing: the
wrapper deliberately does NOT expose ``_release_save`` /
``_acquire_restore`` / ``_is_owned``, so Condition falls back to plain
``release()``/``acquire()`` on the wrapper — ``wait()``'s release and
re-acquire flow through the witness with correct held-stack and edge
semantics automatically.

Import order matters for module-level locks (telemetry registries,
flight recorder): install the witness BEFORE importing the package
(load this module by path first, as the JAX package's
``tests/conftest.py`` does), which is why this file imports nothing
from the package at module level.

Witness internals are guarded by a raw ``_thread.allocate_lock`` (a
leaf lock: held briefly, never acquires anything) and contention time
is accumulated in plain module aggregates — exporting to telemetry
gauges (``lock_witness_edges_total`` / ``lock_contention_seconds``)
happens only in :func:`snapshot`, so witnessing a metric lock cannot
recurse into metric updates.
"""
from __future__ import annotations

import os
import sys
import time
import traceback
import _thread
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

Site = Tuple[str, int]

_ENV = "MXTPU_LOCK_WITNESS"

_orig_lock = threading.Lock
_orig_rlock = threading.RLock

_installed = False
_track_roots: Tuple[str, ...] = ()

_meta = _thread.allocate_lock()
# (src_site, dst_site) -> {"count": int, "stack": [str, ...]}
_edges: Dict[Tuple[Site, Site], dict] = {}
_held: Dict[int, List["_WitnessLock"]] = {}
_contention_total = 0.0
_n_tracked = 0
# individual contention waits (site, t0, dur — perf_counter seconds)
# for the merged profiler timeline; bounded, guarded by _meta
_recent: deque = deque(maxlen=1024)

_STACK_DEPTH = 12


def enabled() -> bool:
    return os.environ.get(_ENV) == "1"


class _WitnessLock:
    """threading.Lock/RLock stand-in that reports acquisition order."""

    __slots__ = ("_raw", "site")

    def __init__(self, raw, site: Site):
        self._raw = raw
        self.site = site

    # -- lock protocol -------------------------------------------------- #
    def acquire(self, blocking=True, timeout=-1):
        is_blocking = bool(blocking) and (timeout is None or timeout < 0)
        t0 = time.perf_counter()
        if timeout is not None and timeout >= 0:
            ok = self._raw.acquire(blocking, timeout)
        else:
            ok = self._raw.acquire(blocking)
        dt = time.perf_counter() - t0
        if not ok:
            return False
        held = _held.setdefault(_thread.get_ident(), [])
        if (is_blocking and held) or dt > 1e-4:
            _record(held if is_blocking else (), self, dt)
        held.append(self)
        return True

    def release(self):
        held = _held.get(_thread.get_ident())
        if held:
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
        self._raw.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._raw.locked()

    def __repr__(self):
        return (f"<witnessed lock {os.path.basename(self.site[0])}:"
                f"{self.site[1]}>")


def _record(held, dst: "_WitnessLock", dt: float) -> None:
    global _contention_total
    with _meta:
        _contention_total += dt
        if dt > 1e-4:       # a real wait, not edge-only bookkeeping
            _recent.append((dst.site, time.perf_counter() - dt, dt))
        for w in held:
            if w.site == dst.site:
                continue            # reentrancy, not an ordering edge
            key = (w.site, dst.site)
            e = _edges.get(key)
            if e is None:
                stack = [
                    f"{os.path.basename(fr.filename)}:{fr.lineno}:{fr.name}"
                    for fr in traceback.extract_stack(limit=_STACK_DEPTH)
                    if os.path.basename(fr.filename) != "lock_witness.py"]
                _edges[key] = {"count": 1, "stack": stack}
            else:
                e["count"] += 1


def _make_factory(orig):
    def factory(*args, **kwargs):
        global _n_tracked
        raw = orig(*args, **kwargs)
        frame = sys._getframe(1)
        path = frame.f_code.co_filename
        if not os.path.isabs(path):
            path = os.path.abspath(path)
        if not path.startswith(_track_roots):
            return raw              # foreign lock: raw primitive back
        _n_tracked += 1
        return _WitnessLock(raw, (path, frame.f_lineno))
    return factory


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def install(force: bool = False,
            track_roots: Optional[List[str]] = None) -> bool:
    """Patch the lock factories.  No-op (returns False) unless
    ``MXTPU_LOCK_WITNESS=1`` or ``force``.  ``track_roots`` limits
    which creation sites get witnessed (default: this package)."""
    global _installed, _track_roots
    if _installed:
        return True
    if not force and not enabled():
        return False
    roots = track_roots or [os.path.dirname(os.path.abspath(__file__))]
    _track_roots = tuple(os.path.abspath(r).rstrip(os.sep) + os.sep
                         for r in roots)
    threading.Lock = _make_factory(_orig_lock)
    threading.RLock = _make_factory(_orig_rlock)
    _installed = True
    return True


def uninstall() -> None:
    global _installed
    threading.Lock = _orig_lock
    threading.RLock = _orig_rlock
    _installed = False


def reset() -> None:
    with _meta:
        _edges.clear()
        _held.clear()
        _recent.clear()
        global _contention_total
        _contention_total = 0.0


def installed() -> bool:
    return _installed


# ---------------------------------------------------------------------------
# reporting / checks
# ---------------------------------------------------------------------------


def edges() -> Dict[Tuple[Site, Site], dict]:
    with _meta:
        return {k: dict(v) for k, v in _edges.items()}


def stats() -> dict:
    with _meta:
        return {"edges": len(_edges),
                "tracked_locks": _n_tracked,
                "contention_seconds": _contention_total}


def recent_contention(since: Optional[float] = None) -> List[dict]:
    """Recent individual contention waits as
    ``{"site": "file.py:123", "t0": ..., "dur": ...}`` (perf_counter
    seconds), oldest first — the merged-timeline profiler's lock lane.
    ``since`` keeps only waits still in flight at/after that instant."""
    with _meta:
        evs = list(_recent)
    out = [{"site": _fmt_site(site), "t0": t0, "dur": dur}
           for site, t0, dur in evs]
    if since is not None:
        out = [e for e in out if e["t0"] + e["dur"] >= since]
    return out


def snapshot() -> None:
    """Export witness aggregates to telemetry gauges (safe to call
    when telemetry is disabled or absent)."""
    try:
        from . import telemetry
    except Exception:
        return
    if not telemetry.enabled():
        return
    s = stats()
    telemetry.gauge("lock_witness_edges_total").set(s["edges"])
    telemetry.gauge("lock_contention_seconds").set(
        round(s["contention_seconds"], 6))


def _fmt_site(site: Site) -> str:
    return f"{os.path.basename(site[0])}:{site[1]}"


def check_acyclic() -> List[List[Site]]:
    """Cycles in the observed held-while-acquiring graph (empty list =
    no lock-order inversion was ever observed)."""
    obs = edges()
    adj: Dict[Site, List[Site]] = {}
    for (src, dst) in obs:
        adj.setdefault(src, []).append(dst)
        adj.setdefault(dst, [])
    WHITE, GREY, BLACK = 0, 1, 2
    color = {v: WHITE for v in adj}
    cycles: List[List[Site]] = []

    def dfs(v: Site, path: List[Site]) -> None:
        color[v] = GREY
        path.append(v)
        for w in adj[v]:
            if color[w] == GREY:
                cycles.append(path[path.index(w):] + [w])
            elif color[w] == WHITE:
                dfs(w, path)
        path.pop()
        color[v] = BLACK

    for v in sorted(adj):
        if color[v] == WHITE:
            dfs(v, [])
    return cycles


def static_lock_graph(paths: Optional[List[str]] = None):
    """tpulint's static lock graph over `paths` (default: the port's
    own sources, this package).  Requires the repo checkout (tools/
    next to the package); raises ImportError otherwise."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(pkg)
    if root not in sys.path:
        sys.path.insert(0, root)
    from tools.tpulint.analyzer import Project
    from tools.tpulint import lock_rules
    project = Project(paths or [pkg])
    return lock_rules.build_lock_graph(project)


def check_static_subset(graph=None,
                        paths: Optional[List[str]] = None) -> List[str]:
    """Every observed edge must appear in the static graph (matched by
    lock *creation site*, so token naming is irrelevant).  Returns
    human-readable violations — an observed edge the analyzer cannot
    see means a lock-resolution gap in tpulint."""
    g = graph if graph is not None else static_lock_graph(paths)
    site_token = {(os.path.abspath(p), line): token
                  for token, (p, line) in g.sites().items()}
    static_edges = set(g.edges)
    problems: List[str] = []
    for (src, dst), meta in sorted(edges().items()):
        ts, td = site_token.get(src), site_token.get(dst)
        if ts is None or td is None:
            which = src if ts is None else dst
            problems.append(
                f"observed lock at {_fmt_site(which)} has no static "
                f"identity (edge {_fmt_site(src)} -> {_fmt_site(dst)}, "
                f"stack: {' | '.join(meta['stack'][-4:])})")
        elif ts != td and (ts, td) not in static_edges:
            problems.append(
                f"observed edge {ts} -> {td} "
                f"({_fmt_site(src)} -> {_fmt_site(dst)}, "
                f"count={meta['count']}) missing from the static graph "
                f"(stack: {' | '.join(meta['stack'][-4:])})")
    return problems


def assert_clean(graph=None, paths: Optional[List[str]] = None) -> dict:
    """The CI contract: observed graph acyclic AND a subset of the
    static graph.  Returns stats() on success, raises AssertionError
    with full detail otherwise."""
    cycles = check_acyclic()
    if cycles:
        rendered = "; ".join(
            " -> ".join(_fmt_site(s) for s in c) for c in cycles)
        stacks = "\n".join(
            f"  [{_fmt_site(s)} -> {_fmt_site(d)}] "
            f"{' | '.join(m['stack'][-4:])}"
            for (s, d), m in sorted(edges().items()))
        raise AssertionError(
            f"lock witness observed a lock-order cycle: {rendered}\n"
            f"edges:\n{stacks}")
    problems = check_static_subset(graph, paths)
    if problems:
        raise AssertionError(
            "lock witness edges missing from tpulint's static graph:\n  "
            + "\n  ".join(problems))
    return stats()
