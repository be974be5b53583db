"""Counters, gauges, and fixed-bucket histograms behind one registry, as
in ``repro.obs.metrics``.

The fleet layer's ad-hoc latency deques gave windowed percentiles only —
an instance whose deque wrapped silently forgot its history.  A
:class:`Histogram` here keeps BOTH views under bounded memory:

- fixed log-spaced buckets accumulate every observation forever, so
  all-time p50/p99 are available at any fleet age (bucket-interpolated,
  clamped to the observed min/max);
- a ``maxlen``-bounded window deque keeps the most recent raw samples,
  so the recent-window percentiles stay EXACT — the semantics the old
  ``FleetFrontend._latency`` deques had.

Percentile calls on an empty histogram return ``None`` (never raise):
an instance with zero flushes is a reportable fact, not a crash.

:class:`MetricsRegistry` get-or-creates instruments by (name, labels)
and renders the lot JSON-able via ``as_dict`` — the shape the fleet
metrics roll-up extends its wire schema with.
"""
from __future__ import annotations

import collections
import math
import threading


def default_latency_buckets() -> tuple[float, ...]:
    """Log-spaced seconds, 10us .. ~84s (1-2-5 decades): fine enough for
    sub-millisecond decode spans, wide enough for cold jit compiles."""
    out = []
    for exp in range(-5, 2):
        for mant in (1.0, 2.0, 5.0):
            out.append(mant * 10.0**exp)
    return tuple(out)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value, with a running max (peak-tracking gauges are the
    fleet's in-flight byte high-water marks)."""

    __slots__ = ("name", "labels", "value", "max")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self.max = 0.0

    def set(self, v: float) -> None:
        self.value = v
        if v > self.max:
            self.max = v

    def set_max(self, v: float) -> None:
        """Peak semantics: keep the high-water mark in ``value`` itself."""
        if v > self.value:
            self.value = v
            self.max = v


class Histogram:
    """Fixed-bucket histogram + bounded exact-sample window."""

    __slots__ = (
        "name", "labels", "bounds", "bucket_counts", "count", "total",
        "min", "max", "window",
    )

    def __init__(
        self,
        name: str,
        labels: tuple,
        buckets: tuple[float, ...] | None = None,
        window: int = 2048,
    ):
        self.name = name
        self.labels = labels
        self.bounds = tuple(buckets) if buckets else default_latency_buckets()
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram buckets must ascend: {self.bounds}")
        # one count per bound plus the overflow bucket
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.window: collections.deque[float] = collections.deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # first bound >= v (bisect, inlined to stay import-light)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.bucket_counts[lo] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.window.append(v)

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> float | None:
        """All-time percentile estimate from the buckets (linear within the
        target bucket, clamped to observed min/max).  ``None`` when empty."""
        if not self.count:
            return None
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.bucket_counts):
            if not c:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (target - cum) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def window_percentile(self, q: float) -> float | None:
        """EXACT percentile over the recent-sample window; ``None`` when
        empty.  Same nearest-rank-with-interpolation convention as
        ``numpy.percentile(..., q)`` (linear)."""
        if not self.window:
            return None
        vals = sorted(self.window)
        if len(vals) == 1:
            return vals[0]
        pos = q / 100.0 * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)

    def window_values(self) -> list[float]:
        return list(self.window)


class MetricsRegistry:
    """Get-or-create instrument registry, keyed by (name, sorted labels)."""

    def __init__(self) -> None:
        self._instruments: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, tuple(sorted(labels.items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, tuple(sorted(labels.items())), **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):  # pragma: no cover — registry bug
                raise TypeError(f"{name}{labels} already registered as "
                                f"{type(inst).__name__}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self,
        name: str,
        buckets: tuple[float, ...] | None = None,
        window: int = 2048,
        **labels,
    ) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets, window=window)

    def instruments(self) -> list:
        with self._lock:
            return list(self._instruments.values())

    def remove(self, name: str, **labels) -> None:
        """Drop every instrument kind registered under (name, labels) —
        what the fleet does when an instance retires."""
        key_labels = tuple(sorted(labels.items()))
        with self._lock:
            for key in [
                k for k in self._instruments
                if k[1] == name and k[2] == key_labels
            ]:
                del self._instruments[key]

    def as_dict(self) -> dict:
        """JSON-able snapshot of every instrument."""
        out: dict[str, list] = {"counters": [], "gauges": [], "histograms": []}
        for inst in self.instruments():
            labels = dict(inst.labels)
            if isinstance(inst, Counter):
                out["counters"].append(
                    {"name": inst.name, "labels": labels, "value": inst.value}
                )
            elif isinstance(inst, Gauge):
                out["gauges"].append(
                    {"name": inst.name, "labels": labels,
                     "value": inst.value, "max": inst.max}
                )
            elif isinstance(inst, Histogram):
                out["histograms"].append({
                    "name": inst.name,
                    "labels": labels,
                    "count": inst.count,
                    "sum": inst.total,
                    "p50": inst.percentile(50),
                    "p99": inst.percentile(99),
                    "window_p50": inst.window_percentile(50),
                    "window_p99": inst.window_percentile(99),
                })
        return out
