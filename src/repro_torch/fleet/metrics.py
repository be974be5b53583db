"""Fleet-wide observability: roll up per-instance cache stats + latency,
as in ``repro.fleet.metrics`` (``as_dict`` has the reference's keys).

``collect`` snapshots every live instance's cache stats through its
:class:`~repro_torch.fleet.transport.Transport` (``stats()`` returns the same
JSON-able dict for an in-process service and a worker process — the
serve layer's ``CacheStats.as_dict``), the admission-control gauges, and
decode latency off the frontend's per-instance
:class:`repro_torch.obs.Histogram` instruments, then totals them fleet-wide.

Latency comes in TWO flavors per instance, both ``None`` (never a
crash) when the instance has zero flushes:

- ``decode_p50_ms`` / ``decode_p99_ms`` — EXACT percentiles over the
  recent flush window (the semantics this schema always had);
- ``decode_p50_ms_total`` / ``decode_p99_ms_total`` — all-time
  estimates from the histogram's fixed log buckets, which survive any
  amount of window wrap.

An instance whose transport dies MID-POLL (``stats()`` raises
``TransportError``) is demoted to the ``excluded`` list of the same
snapshot — one dead worker costs one instance's row, not the collect.
``excluded_total`` counts exclusions CUMULATIVELY (a rebalance that
retires the corpse shrinks ``excluded`` but never this), and
``collected_at`` stamps the snapshot on the monotonic clock — the two
signals a controller needs to reason about deaths and polling intervals.
Fleet-pooled ``decode_p50_ms``/``decode_p99_ms`` (exact, over the union
of instance windows) and the per-payload ``canary`` roll-up feed
``repro_torch.obs.slo.fleet_slo_sample``.
``as_dict`` renders the snapshot JSON-able, with the reference's keys.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.fleet.frontend import FleetFrontend
from repro_torch.fleet.transport import TransportError
from repro_torch.serve.codec_service import PayloadCacheStats


@dataclasses.dataclass
class CacheCounters(PayloadCacheStats):
    """The serve layer's four cache counters plus roll-up helpers."""

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def add(self, other) -> None:
        self.hits += other.hits
        self.misses += other.misses
        self.evictions += other.evictions
        self.resident_bytes += other.resident_bytes

    @classmethod
    def of(cls, counters) -> "CacheCounters":
        if isinstance(counters, dict):  # a transport's wire snapshot
            return cls(
                counters["hits"],
                counters["misses"],
                counters["evictions"],
                counters["resident_bytes"],
            )
        return cls(counters.hits, counters.misses, counters.evictions,
                   counters.resident_bytes)


@dataclasses.dataclass
class InstanceMetrics:
    instance: str
    cache: CacheCounters
    per_payload: dict[str, CacheCounters]
    peak_inflight_bytes: int
    #: exact percentiles over the recent flush window; None if no flushes
    decode_p50_ms: float | None
    decode_p99_ms: float | None
    #: all-time bucket estimates (survive window wrap); None if no flushes
    decode_p50_ms_total: float | None
    decode_p99_ms_total: float | None
    flushes: int  # monotonic (all-time), matches the _total percentiles
    #: per-payload canary snapshot (checks/breaches/fitness) from the
    #: instance's serve-layer stats; empty for canary-off instances and
    #: old workers whose stats blob predates the key
    canary: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FleetMetrics:
    instances: dict[str, InstanceMetrics]
    fleet: CacheCounters            # totals across live instances
    per_payload: dict[str, CacheCounters]  # fleet totals by payload
    backpressure_flushes: int
    #: members whose transport died — still on the ring, not polled
    excluded: list[str] = dataclasses.field(default_factory=list)
    #: CUMULATIVE exclusion count — unlike ``excluded`` (current members
    #: only, shrinks when a rebalance retires the corpse) this never goes
    #: down, so a controller can tell a NEW death from a long-dead one
    excluded_total: int = 0
    #: monotonic-clock snapshot time — subtract two snapshots' values for
    #: a wall-immune polling interval
    collected_at: float = 0.0
    #: fleet-wide EXACT percentiles over the union of every live
    #: instance's recent flush window; None until anything flushed
    decode_p50_ms: float | None = None
    decode_p99_ms: float | None = None
    #: fleet canary roll-up by payload: summed checks/breaches, worst
    #: (minimum) rolling fitness across instances
    canary: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        def counters(c: CacheCounters) -> dict:
            return {
                "hits": c.hits, "misses": c.misses, "evictions": c.evictions,
                "resident_bytes": c.resident_bytes,
                "hit_rate": round(c.hit_rate, 4),
            }

        return {
            "fleet": counters(self.fleet),
            "per_payload": {k: counters(v) for k, v in self.per_payload.items()},
            "backpressure_flushes": self.backpressure_flushes,
            "excluded": list(self.excluded),
            "excluded_total": self.excluded_total,
            "collected_at": self.collected_at,
            "decode_p50_ms": self.decode_p50_ms,
            "decode_p99_ms": self.decode_p99_ms,
            "canary": self.canary,
            "instances": {
                iid: {
                    "cache": counters(m.cache),
                    "per_payload": {
                        k: counters(v) for k, v in m.per_payload.items()
                    },
                    "peak_inflight_bytes": m.peak_inflight_bytes,
                    "decode_p50_ms": m.decode_p50_ms,
                    "decode_p99_ms": m.decode_p99_ms,
                    "decode_p50_ms_total": m.decode_p50_ms_total,
                    "decode_p99_ms_total": m.decode_p99_ms_total,
                    "flushes": m.flushes,
                    "canary": m.canary,
                }
                for iid, m in self.instances.items()
            },
        }


def _ms(seconds: float | None) -> float | None:
    return None if seconds is None else round(seconds * 1e3, 4)


def _pooled_percentile(values: list[float], q: float) -> float | None:
    """Exact linear-interpolated percentile over pooled samples (same
    convention as ``Histogram.window_percentile``); None when empty."""
    if not values:
        return None
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    pos = q / 100.0 * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def _rollup_canary(per_instance: dict[str, dict]) -> dict:
    """Fleet canary view by payload: total checks/breaches, worst
    (minimum) rolling fitness across the instances reporting one."""
    out: dict[str, dict] = {}
    for canary in per_instance.values():
        for payload, c in canary.items():
            agg = out.setdefault(
                payload,
                {"checks": 0, "breaches": 0, "rolling_fitness": None},
            )
            agg["checks"] += int(c.get("checks", 0))
            agg["breaches"] += int(c.get("breaches", 0))
            rf = c.get("rolling_fitness")
            if rf is not None and (
                agg["rolling_fitness"] is None or rf < agg["rolling_fitness"]
            ):
                agg["rolling_fitness"] = rf
    return out


def collect(fleet: FleetFrontend) -> FleetMetrics:
    instances: dict[str, InstanceMetrics] = {}
    fleet_total = CacheCounters()
    fleet_per_payload: dict[str, CacheCounters] = {}
    pooled_latency: list[float] = []
    for iid in fleet.instances():
        if iid in fleet.excluded:
            continue
        try:
            stats = fleet.transports[iid].stats()
        except TransportError as e:
            fleet.exclude(iid, e)
            continue
        cache = CacheCounters.of(stats)
        per_payload = {
            name: CacheCounters.of(p)
            for name, p in stats["per_payload"].items()
        }
        hist = fleet.latency_histogram(iid)
        pooled_latency.extend(hist.window_values())
        instances[iid] = InstanceMetrics(
            instance=iid,
            cache=cache,
            per_payload=per_payload,
            peak_inflight_bytes=fleet.peak_inflight_bytes(iid),
            decode_p50_ms=_ms(hist.window_percentile(50)),
            decode_p99_ms=_ms(hist.window_percentile(99)),
            decode_p50_ms_total=_ms(hist.percentile(50)),
            decode_p99_ms_total=_ms(hist.percentile(99)),
            flushes=hist.count,
            # .get: an old worker's stats blob predates the canary key
            canary=stats.get("canary") or {},
        )
        fleet_total.add(cache)
        for name, c in per_payload.items():
            fleet_per_payload.setdefault(name, CacheCounters()).add(c)
    return FleetMetrics(
        instances=instances,
        fleet=fleet_total,
        per_payload=fleet_per_payload,
        backpressure_flushes=fleet.backpressure_flushes,
        excluded=sorted(fleet.excluded),
        excluded_total=getattr(fleet, "exclusions_total", len(fleet.excluded)),
        collected_at=time.monotonic(),
        decode_p50_ms=_ms(_pooled_percentile(pooled_latency, 50)),
        decode_p99_ms=_ms(_pooled_percentile(pooled_latency, 99)),
        canary=_rollup_canary(
            {iid: m.canary for iid, m in instances.items() if m.canary}
        ),
    )
