"""Process-wide metrics registry: Counter / Gauge / Histogram (the port
of `incubator_mxnet_tpu/telemetry/registry.py`, unchanged: the two
packages' registries give byte-identical exports for the same updates).

The metric backbone every instrumented layer of the port (the serving
engine, generation, the Trainer, checkpoints, the program recorder)
reports through.

Design constraints:

* **near-zero-cost disabled path**: every update method checks one
  module-level boolean first and returns; no locks, no time reads, no
  allocation happen while telemetry is off (the default).
* **thread-safe updates**: enabled-path mutation happens under a
  per-metric lock (the serving scheduler, HTTP handler threads, the
  checkpoint writer and the training loop all report concurrently).
* **no device syncs**: metrics only ever accept host scalars; values
  derived from tensors must come from their metadata (shape/dtype) or
  data already on the host.

Histograms use fixed log-scale buckets (`DEFAULT_BUCKETS`: 4 per
decade, 1e-6 .. 1e4 — step latencies in seconds and small-ratio values
both land mid-range) and derive p50/p95/p99 by log-linear
interpolation inside the owning bucket.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "DEFAULT_BUCKETS",
           "log_buckets"]

# mutated only via Registry.set_enabled (telemetry.enable/disable); read
# unlocked on every hot-path update — a stale read is benign (one extra
# or one missed sample around the toggle)
_enabled = False


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> Tuple[float, ...]:
    """Log-scale bucket upper bounds covering [lo, hi]."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"log_buckets: need 0 < lo < hi, got ({lo}, {hi})")
    n = int(math.ceil(per_decade * math.log10(hi / lo)))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


# 1 µs .. 10 ks at 4 buckets/decade (41 bounds + implicit +Inf): covers
# span/step latencies in seconds with ~78% bucket-to-bucket resolution
DEFAULT_BUCKETS: Tuple[float, ...] = log_buckets(1e-6, 1e4, 4)


class _Metric:
    __slots__ = ("name", "labels", "_lock")

    kind = "untyped"

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels) if labels else {}
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonically increasing count (events, bytes, compiles)."""

    __slots__ = ("_value",)

    kind = "counter"

    def __init__(self, name, labels=None):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"value": self._value}

    def _reset(self) -> None:
        self._value = 0.0


class Gauge(_Metric):
    """Last-written host scalar (queue depths, ratios, rates)."""

    __slots__ = ("_value",)

    kind = "gauge"

    def __init__(self, name, labels=None):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"value": self._value}

    def _reset(self) -> None:
        self._value = 0.0


class Histogram(_Metric):
    """Fixed log-scale-bucket histogram with percentile summaries.

    `observe(v)` is O(log n_buckets) (bisect into the precomputed
    bounds).  Negative/zero observations land in the first bucket;
    values beyond the last bound land in the +Inf overflow bucket.
    """

    __slots__ = ("bounds", "_counts", "_count", "_sum", "_min", "_max")

    kind = "histogram"

    def __init__(self, name, labels=None,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, labels)
        self.bounds: Tuple[float, ...] = tuple(buckets) if buckets \
            else DEFAULT_BUCKETS
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram {name}: buckets must be sorted")
        self._counts = [0] * (len(self.bounds) + 1)  # +Inf overflow slot
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        value = float(value)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> List[int]:
        """Per-bucket counts (last entry = +Inf overflow)."""
        with self._lock:
            return list(self._counts)

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0,1]) by log interpolation
        within the owning bucket.  NaN when empty."""
        with self._lock:
            total = self._count
            if total == 0:
                return math.nan
            rank = q * total
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                prev_cum, cum = cum, cum + c
                if cum >= rank:
                    frac = min(1.0, max(0.0, (rank - prev_cum) / c))
                    if i >= len(self.bounds):       # +Inf overflow bucket
                        return self._max
                    hi = self.bounds[i]
                    # lower edge: previous bound (first bucket: observed min,
                    # clamped positive so the log interp stays defined)
                    lo = self.bounds[i - 1] if i > 0 \
                        else min(max(self._min, hi / 10.0), hi)
                    est = hi * frac if lo <= 0 else lo * (hi / lo) ** frac
                    # interpolation can't beat the observed extremes
                    return min(max(est, self._min), self._max)
            return self._max  # pragma: no cover — rank <= total always hits

    def percentiles(self, qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
        return {f"p{int(q * 100)}": self.percentile(q) for q in qs}

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            out = {"count": self._count, "sum": self._sum,
                   "min": self._min if self._count else None,
                   "max": self._max if self._count else None}
        out["buckets"] = counts
        out["bounds"] = list(self.bounds)
        out.update({k: v for k, v in self.percentiles().items()})
        return out

    def _reset(self) -> None:
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf


def _key(name: str, labels: Optional[Dict[str, str]]):
    if not labels:
        return (name, ())
    return (name, tuple(sorted(labels.items())))


class Registry:
    """Name+labels → metric; get-or-create is idempotent and type-checked."""

    def __init__(self):
        self._metrics: Dict[tuple, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, labels, **kw):
        k = _key(name, labels)
        m = self._metrics.get(k)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"telemetry metric {name!r}{dict(k[1]) or ''} already "
                    f"registered as {m.kind}, requested {cls.kind}")
            return m
        with self._lock:
            m = self._metrics.get(k)
            if m is None:
                m = cls(name, labels, **kw)
                self._metrics[k] = m
            return m

    def counter(self, name: str, labels=None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels=None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels=None, buckets=None) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        """Stable-ordered snapshot of all registered metrics."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str, labels=None) -> Optional[_Metric]:
        return self._metrics.get(_key(name, labels))

    def reset(self) -> None:
        """Zero every metric's state (registrations survive)."""
        with self._lock:
            for m in self._metrics.values():
                with m._lock:
                    m._reset()

    def clear(self) -> None:
        """Drop all registrations (tests)."""
        with self._lock:
            self._metrics.clear()
