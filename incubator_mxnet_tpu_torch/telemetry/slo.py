"""Windowed SLO accounting: good/total fractions and burn rates (the port
of `incubator_mxnet_tpu/telemetry/slo.py`, unchanged).

The serving engine's overload policy (shed/evict) keeps the system
alive; THIS module answers whether the traffic it did serve met its
latency targets — the "throughput under SLO" axis, and the signal
``/healthz`` degrades on.

`SloTracker` is a small host-side event log: every terminal request
contributes one event, ``good`` iff it completed AND met every
configured target (TTFT, mean TPOT).  Shed / evicted / failed requests
are *bad by definition* — an SLO that ignores rejected traffic
over-reports itself exactly when overloaded, the case that matters.

Over each configured window it derives:

* ``fraction``  — good/total over the window (1.0 when idle: no
  traffic violates no objective);
* ``burn_rate`` — ``(1 - fraction) / (1 - objective)``, the standard
  SRE burn rate: 1.0 means the error budget burns exactly at the rate
  that exhausts it in one objective period; >1 is an alert, sustained
  >>1 is a page.

`observe()` feeds the ``serving_slo_fraction{window=}`` /
``serving_slo_burn_rate{window=}`` gauges.  Everything is host clocks
and booleans; locked because the scheduler thread writes while HTTP
handler threads read.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["SloTracker", "DEFAULT_WINDOWS", "DEFAULT_OBJECTIVE"]

# 1-minute fast window (paging signal) + 10-minute slow window
# (sustained-burn confirmation) — the classic multi-window pair
DEFAULT_WINDOWS: Tuple[float, ...] = (60.0, 600.0)
DEFAULT_OBJECTIVE = 0.99
# events kept per tracker: bounds host memory under sustained overload
# (at the cap the oldest events age out of every window anyway)
_MAX_EVENTS = 8192


def _window_label(seconds: float) -> str:
    s = int(seconds)
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


class SloTracker:
    """Good/total accounting over sliding windows.

    ttft_target / tpot_target   seconds; None disables that check
                                (a tracker with NO targets counts every
                                completed request as good — the
                                fraction then measures completion rate
                                under overload, still meaningful).
    windows                     window lengths in seconds.
    objective                   target good fraction (0.99 = "1% error
                                budget") for the burn-rate scaling.
    """

    def __init__(self, ttft_target: Optional[float] = None,
                 tpot_target: Optional[float] = None,
                 windows: Sequence[float] = DEFAULT_WINDOWS,
                 objective: float = DEFAULT_OBJECTIVE):
        if not windows:
            raise ValueError("need at least one window")
        if not (0.0 < objective < 1.0):
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.ttft_target = ttft_target
        self.tpot_target = tpot_target
        self.windows = tuple(sorted(float(w) for w in windows))
        self.objective = float(objective)
        self._budget = 1.0 - self.objective
        self._events: deque = deque(maxlen=_MAX_EVENTS)  # (t, good)
        self._lock = threading.Lock()
        self._good_total = 0
        self._total = 0

    # -- recording ----------------------------------------------------- #
    def is_good(self, ttft: Optional[float],
                tpot: Optional[float]) -> bool:
        """Does a COMPLETED request with these latencies meet the SLO?"""
        if self.ttft_target is not None and (
                ttft is None or ttft > self.ttft_target):
            return False
        if self.tpot_target is not None and (
                tpot is not None and tpot > self.tpot_target):
            return False
        return True

    def note_done(self, ttft: Optional[float], tpot: Optional[float],
                  now: Optional[float] = None) -> bool:
        """Record one completed request; returns its goodness."""
        good = self.is_good(ttft, tpot)
        self._note(good, now)
        return good

    def note_bad(self, now: Optional[float] = None) -> None:
        """Record one shed / evicted / failed request."""
        self._note(False, now)

    def _note(self, good: bool, now: Optional[float]) -> None:
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._events.append((t, good))
            self._total += 1
            if good:
                self._good_total += 1

    # -- reading ------------------------------------------------------- #
    def counts(self, now: Optional[float] = None) -> Dict[str, Tuple[int, int]]:
        """{window_label: (good, total)} over each sliding window."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            events = list(self._events)
        out = {}
        for w in self.windows:
            cut = t - w
            good = total = 0
            # newest-first: windows are suffixes of the event log
            for et, g in reversed(events):
                if et < cut:
                    break
                total += 1
                if g:
                    good += 1
            out[_window_label(w)] = (good, total)
        return out

    def fractions(self, now: Optional[float] = None) -> Dict[str, float]:
        """{window_label: good fraction}; 1.0 for an idle window."""
        return {k: (g / t if t else 1.0)
                for k, (g, t) in self.counts(now).items()}

    def burn_rates(self, now: Optional[float] = None) -> Dict[str, float]:
        """{window_label: error-budget burn rate} (0.0 when idle)."""
        return {k: (1.0 - f) / self._budget
                for k, f in self.fractions(now).items()}

    def snapshot(self, now: Optional[float] = None) -> dict:
        """JSON-ready state for /healthz: targets, per-window numbers."""
        counts = self.counts(now)
        fractions = {k: (g / t if t else 1.0)
                     for k, (g, t) in counts.items()}
        return {
            "objective": self.objective,
            "ttft_target_s": self.ttft_target,
            "tpot_target_s": self.tpot_target,
            "windows": {
                k: {"good": g, "total": t,
                    "fraction": round(fractions[k], 6),
                    "burn_rate": round((1.0 - fractions[k]) / self._budget,
                                       4)}
                for k, (g, t) in counts.items()},
            "lifetime": {"good": self._good_total, "total": self._total},
        }

    def observe(self, prefix: str = "serving",
                now: Optional[float] = None) -> None:
        """Set ``{prefix}_slo_fraction{window=}`` and
        ``{prefix}_slo_burn_rate{window=}`` gauges (no-op while
        telemetry is disabled, like every instrumentation site)."""
        from . import enabled, gauge

        if not enabled():
            return
        for k, f in self.fractions(now).items():
            gauge(f"{prefix}_slo_fraction", labels={"window": k}).set(f)
            gauge(f"{prefix}_slo_burn_rate", labels={"window": k}) \
                .set((1.0 - f) / self._budget)
