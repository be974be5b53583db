"""Prometheus text exposition (format 0.0.4) for repro metrics, as in
``repro.obs.exposition``: the same registry, snapshot or fleet snapshot
renders the reference's page byte for byte, and metric names keep its
``repro_`` and ``repro_fleet_*`` prefixes, which are what scrapers read.

Renders three source shapes into one scrapeable page:

- a live :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters and
  gauges verbatim, histograms as FULL Prometheus histograms (cumulative
  ``_bucket{le=...}`` series from the fixed log buckets, ``+Inf``,
  ``_sum``, ``_count``), so a scraper can compute any quantile with
  ``histogram_quantile``;
- a registry SNAPSHOT dict (``MetricsRegistry.as_dict()`` — what rides a
  trace export or a wire stats blob) — histograms collapse to
  summary-style ``{quantile="..."}`` series, because bucket counts do not
  ride the snapshot;
- a fleet metrics snapshot (``repro_torch.fleet.metrics.collect().as_dict()``)
  — ``repro_fleet_*`` gauges with ``instance``/``payload`` labels.

Everything feeds :func:`render_exposition`; ``python -m
repro_torch.obs.serve_metrics`` serves it over HTTP.  Metric and label names
are sanitized to the Prometheus charset; values render with ``repr``
(full float precision).
"""
from __future__ import annotations

import math
import re

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


def _name(s: str) -> str:
    s = _NAME_OK.sub("_", str(s))
    return s if not s or not s[0].isdigit() else "_" + s


def _label_key(s: str) -> str:
    s = _LABEL_OK.sub("_", str(s))
    return s if not s or not s[0].isdigit() else "_" + s


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{_label_key(k)}="{_escape(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def _num(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if isinstance(v, float) else str(v)


def _render_histogram(lines: list[str], h: Histogram) -> None:
    name = _name(h.name)
    labels = dict(h.labels)
    lines.append(f"# TYPE {name} histogram")
    cum = 0
    for bound, count in zip(h.bounds, h.bucket_counts):
        cum += count
        lines.append(
            f"{name}_bucket{_labels(labels, {'le': _num(float(bound))})} {cum}"
        )
    lines.append(f"{name}_bucket{_labels(labels, {'le': '+Inf'})} {h.count}")
    lines.append(f"{name}_sum{_labels(labels)} {_num(h.total)}")
    lines.append(f"{name}_count{_labels(labels)} {h.count}")


def _render_registry(lines: list[str], registry: MetricsRegistry) -> None:
    typed: set[str] = set()
    for inst in registry.instruments():
        name = _name(inst.name)
        if isinstance(inst, Counter):
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{_labels(dict(inst.labels))} {inst.value}")
        elif isinstance(inst, Gauge):
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{_labels(dict(inst.labels))} {_num(inst.value)}")
        elif isinstance(inst, Histogram):
            _render_histogram(lines, inst)


def _render_registry_snapshot(lines: list[str], snap: dict) -> None:
    """A ``MetricsRegistry.as_dict()`` snapshot: bucket counts are gone,
    so histograms render as summary quantile series instead."""
    for c in snap.get("counters", []):
        name = _name(c["name"])
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name}{_labels(c.get('labels', {}))} {c['value']}")
    for g in snap.get("gauges", []):
        name = _name(g["name"])
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{_labels(g.get('labels', {}))} {_num(g['value'])}")
    for h in snap.get("histograms", []):
        name = _name(h["name"])
        labels = h.get("labels", {})
        lines.append(f"# TYPE {name} summary")
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            if h.get(key) is not None:
                lines.append(
                    f"{name}{_labels(labels, {'quantile': q})} {_num(h[key])}"
                )
        lines.append(f"{name}_sum{_labels(labels)} {_num(h.get('sum', 0.0))}")
        lines.append(f"{name}_count{_labels(labels)} {h.get('count', 0)}")


def _render_fleet(lines: list[str], fleet: dict) -> None:
    """``repro_torch.fleet.metrics.collect().as_dict()`` -> repro_fleet_* series."""
    def gauge(name: str, value, labels: dict | None = None) -> None:
        if value is None:
            return
        lines.append(f"repro_fleet_{name}{_labels(labels or {})} {_num(value)}")

    f = fleet.get("fleet", {})
    for key in ("hits", "misses", "evictions", "resident_bytes", "hit_rate"):
        gauge(f"cache_{key}", f.get(key))
    gauge("backpressure_flushes", fleet.get("backpressure_flushes"))
    gauge("excluded", len(fleet.get("excluded", [])))
    gauge("excluded_total", fleet.get("excluded_total"))
    gauge("instances", len(fleet.get("instances", {})))
    gauge("decode_p50_ms", fleet.get("decode_p50_ms"))
    gauge("decode_p99_ms", fleet.get("decode_p99_ms"))
    for payload, c in sorted(fleet.get("canary", {}).items()):
        lbl = {"payload": payload}
        gauge("canary_checks", c.get("checks"), lbl)
        gauge("canary_breaches", c.get("breaches"), lbl)
        gauge("canary_fitness", c.get("rolling_fitness"), lbl)
    for iid, m in sorted(fleet.get("instances", {}).items()):
        lbl = {"instance": iid}
        cache = m.get("cache", {})
        for key in ("hits", "misses", "evictions", "resident_bytes", "hit_rate"):
            gauge(f"instance_cache_{key}", cache.get(key), lbl)
        gauge("instance_decode_p50_ms", m.get("decode_p50_ms"), lbl)
        gauge("instance_decode_p99_ms", m.get("decode_p99_ms"), lbl)
        gauge("instance_flushes", m.get("flushes"), lbl)
        gauge("instance_peak_inflight_bytes", m.get("peak_inflight_bytes"), lbl)


def render_exposition(
    registry: MetricsRegistry | dict | None = None,
    fleet: dict | None = None,
) -> str:
    """Render metrics as Prometheus text format 0.0.4.  ``registry`` may
    be a live :class:`MetricsRegistry` or its ``as_dict()`` snapshot;
    ``fleet`` a fleet metrics snapshot dict.  Either or both."""
    lines: list[str] = []
    if isinstance(registry, MetricsRegistry):
        _render_registry(lines, registry)
    elif isinstance(registry, dict):
        _render_registry_snapshot(lines, registry)
    if fleet is not None:
        _render_fleet(lines, fleet)
    return "\n".join(lines) + ("\n" if lines else "")
