"""Declarative SLOs evaluated over metric samples: hysteresis + burn rate,
as in ``repro.obs.slo``.

An :class:`SLOSpec` names one objective over one metric key (``p99 decode
latency <= 5 ms``, ``per-payload canary fitness >= 0.95``) and the engine
turns a stream of flat metric samples into edge-triggered breach events:

- **streaks, not spikes** — a breach opens only after ``breach_for``
  CONSECUTIVE violating evaluations and closes only after ``clear_for``
  consecutive clearing ones, so one slow flush never flaps a controller;
- **hysteresis** — ``clear`` sets a recovery threshold tighter than the
  target (e.g. breach above 5 ms, clear below 4 ms).  Values between the
  two reset both streaks and HOLD the current state, which is what makes
  an autoscaler built on this engine oscillation-free by construction;
- **burn rate** — each series keeps a bounded window of violate/ok bits;
  ``burn_rate`` is the violating fraction, the "how fast is the error
  budget burning" signal dashboards alert on;
- **wildcards** — a metric key may contain ``*`` (``hit_rate.*``,
  ``canary_fitness.*``): every matching sample key gets its OWN series
  state, so per-instance and per-payload objectives are one spec line.

``None`` values (an instance with zero flushes yet) are skipped without
touching state — absence of signal is not a violation.

The engine is PURE: no clocks, no I/O, no emission — callers pass ``now``
and forward the returned events wherever they want (the fleet controller
mirrors them into ``repro_torch.obs.events``).  That is what makes controller
decision logic testable over recorded fixtures.

    engine = SLOEngine([
        SLOSpec("latency", "decode_p99_ms", target=5.0, clear=4.0,
                breach_for=3, clear_for=2),
        SLOSpec("quality", "canary_fitness.*", target=0.9, op=">="),
    ])
    for sample in samples:
        for ev in engine.evaluate(sample, now=t):
            ...  # ev.kind is "breach_start" / "breach_end"
"""
from __future__ import annotations

import collections
import dataclasses
import fnmatch


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One objective: ``metric op target``, with hysteresis and streaks.

    ``op="<="`` means the metric must stay at or below ``target`` (latency
    style); ``op=">="`` at or above (fitness / hit-rate style).  ``clear``
    is the recovery threshold (defaults to ``target`` — no hysteresis
    band); it must be at least as strict as the target.
    """

    name: str
    metric: str
    target: float
    op: str = "<="
    clear: float | None = None
    breach_for: int = 1
    clear_for: int = 1
    #: burn-rate window in evaluations; default scales with breach_for
    window: int | None = None

    def __post_init__(self):
        if self.op not in ("<=", ">="):
            raise ValueError(f"slo {self.name!r}: op must be '<=' or '>='")
        if self.breach_for < 1 or self.clear_for < 1:
            raise ValueError(
                f"slo {self.name!r}: breach_for/clear_for must be >= 1"
            )
        if self.clear is not None:
            ok = (
                self.clear <= self.target
                if self.op == "<="
                else self.clear >= self.target
            )
            if not ok:
                raise ValueError(
                    f"slo {self.name!r}: clear={self.clear} is looser than "
                    f"target={self.target} under op {self.op!r}"
                )

    @property
    def burn_window(self) -> int:
        return self.window if self.window is not None else max(4 * self.breach_for, 8)

    def violates(self, value: float) -> bool:
        return value > self.target if self.op == "<=" else value < self.target

    def clears(self, value: float) -> bool:
        c = self.target if self.clear is None else self.clear
        return value <= c if self.op == "<=" else value >= c


@dataclasses.dataclass(frozen=True)
class SLOEvent:
    kind: str  # "breach_start" | "breach_end"
    slo: str
    metric: str  # the CONCRETE sample key (wildcards resolved)
    value: float
    threshold: float
    burn_rate: float
    at: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Series:
    """Per (spec, concrete-key) evaluation state."""

    __slots__ = ("bad", "good", "breached", "window")

    def __init__(self, window: int):
        self.bad = 0
        self.good = 0
        self.breached = False
        self.window: collections.deque[int] = collections.deque(maxlen=window)

    def burn_rate(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0


class SLOEngine:
    def __init__(self, specs: list[SLOSpec]):
        self.specs = list(specs)
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slo names: {sorted(names)}")
        self._series: dict[tuple[str, str], _Series] = {}

    def _keys(self, spec: SLOSpec, sample: dict) -> list[str]:
        if "*" not in spec.metric:
            return [spec.metric]
        return sorted(
            k for k in sample if fnmatch.fnmatchcase(k, spec.metric)
        )

    def evaluate(self, sample: dict, now: float = 0.0) -> list[SLOEvent]:
        """Feed one metric sample; returns edge events (state changes
        only — a breach that persists stays silent until it clears)."""
        events: list[SLOEvent] = []
        for spec in self.specs:
            for key in self._keys(spec, sample):
                value = sample.get(key)
                if value is None:
                    continue
                st = self._series.setdefault(
                    (spec.name, key), _Series(spec.burn_window)
                )
                violating = spec.violates(value)
                st.window.append(1 if violating else 0)
                if violating:
                    st.bad += 1
                    st.good = 0
                    if not st.breached and st.bad >= spec.breach_for:
                        st.breached = True
                        events.append(SLOEvent(
                            "breach_start", spec.name, key, float(value),
                            spec.target, st.burn_rate(), now,
                        ))
                elif spec.clears(value):
                    st.good += 1
                    st.bad = 0
                    if st.breached and st.good >= spec.clear_for:
                        st.breached = False
                        events.append(SLOEvent(
                            "breach_end", spec.name, key, float(value),
                            spec.target, st.burn_rate(), now,
                        ))
                else:  # hysteresis band: hold state, reset both streaks
                    st.bad = 0
                    st.good = 0
        return events

    def breached(self) -> list[tuple[str, str]]:
        """Currently-open breaches as (slo name, concrete metric key)."""
        return sorted(
            key for key, st in self._series.items() if st.breached
        )

    def is_breached(self, name: str, metric: str | None = None) -> bool:
        return any(
            st.breached
            for (n, k), st in self._series.items()
            if n == name and (metric is None or k == metric)
        )

    def burn_rate(self, name: str, metric: str) -> float:
        st = self._series.get((name, metric))
        return st.burn_rate() if st is not None else 0.0


def fleet_slo_sample(metrics, extra: dict | None = None) -> dict:
    """Flatten a fleet metrics snapshot (``repro_torch.fleet.metrics.collect``'s
    :class:`FleetMetrics`, or its ``as_dict``) into the flat key space SLO
    specs address.  Duck-typed on ``as_dict`` so this module never imports
    the fleet layer."""
    d = metrics.as_dict() if hasattr(metrics, "as_dict") else dict(metrics)
    instances = d.get("instances", {})
    sample: dict = {
        "decode_p50_ms": d.get("decode_p50_ms"),
        "decode_p99_ms": d.get("decode_p99_ms"),
        "excluded_total": d.get("excluded_total", len(d.get("excluded", []))),
        "backpressure_flushes": d.get("backpressure_flushes", 0),
        "instances": len(instances),
        "flushes_total": sum(m.get("flushes", 0) for m in instances.values()),
    }
    for iid, m in instances.items():
        sample[f"hit_rate.{iid}"] = m.get("cache", {}).get("hit_rate")
    for payload, c in (d.get("canary") or {}).items():
        sample[f"canary_fitness.{payload}"] = c.get("rolling_fitness")
    if extra:
        sample.update(extra)
    return sample
