"""``python -m repro_torch.obs.report`` — summarize an exported trace file,
as ``python -m repro.obs.report`` does; it reads the traces of either
package (the format is the reference's) and ``report_dict`` returns the
reference's dict for the same file.

Reads a Chrome trace-event JSON written by
:func:`repro_torch.obs.export_chrome_trace` and prints:

- a per-stage time breakdown (total/mean/max wall time per span name,
  sorted by total) with each stage's share of the traced wall clock;
- the slowest individual spans (name, instance, duration, attrs);
- fleet cache hit rates, when the export embedded a metrics snapshot
  (the ``repro_metrics`` key ``fleet_bench --trace`` writes);
- with ``--fit events.jsonl``, a fit-telemetry summary (events per
  type, final loss, mean entries/sec).

    python -m repro_torch.obs.report trace.json
    python -m repro_torch.obs.report trace.json --top 5 --fit fit.jsonl
    python -m repro_torch.obs.report trace.json --format json   # machine-readable

``--format json`` emits the same breakdown as one JSON object (stage
rows, slowest spans, embedded metrics snapshot, fit summary) so CI and
controller tests assert on parsed fields instead of scraping text.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace-event file "
                         "(missing 'traceEvents')")
    return doc


def stage_breakdown(events: list[dict]) -> list[dict]:
    """Aggregate complete ("X") events by span name."""
    by_name: dict[str, list[float]] = collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X":
            by_name[ev["name"]].append(float(ev.get("dur", 0.0)))
    rows = [
        {
            "stage": name,
            "count": len(durs),
            "total_ms": sum(durs) / 1e3,
            "mean_ms": sum(durs) / len(durs) / 1e3,
            "max_ms": max(durs) / 1e3,
        }
        for name, durs in by_name.items()
    ]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def slowest_spans(events: list[dict], top: int) -> list[dict]:
    xs = [ev for ev in events if ev.get("ph") == "X"]
    xs.sort(key=lambda ev: -float(ev.get("dur", 0.0)))
    return xs[:top]


def _process_names(events: list[dict]) -> dict[int, str]:
    return {
        ev["pid"]: ev["args"]["name"]
        for ev in events
        if ev.get("ph") == "M" and ev.get("name") == "process_name"
    }


def summarize_fit(path: str) -> list[str]:
    counts: collections.Counter[str] = collections.Counter()
    last: dict[str, dict] = {}
    eps: list[float] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            counts[rec.get("event", "?")] += 1
            last[rec.get("event", "?")] = rec
            if "entries_per_sec" in rec:
                eps.append(float(rec["entries_per_sec"]))
    lines = [f"fit telemetry ({path}):"]
    for event, n in counts.most_common():
        tail = last[event]
        extras = []
        for key in ("step", "loss", "fitness", "reservoir_fill", "version",
                    "keyframe", "rekeyed", "rank"):
            if key in tail:
                v = tail[key]
                extras.append(f"{key}={v:.5g}" if isinstance(v, float) else f"{key}={v}")
        lines.append(f"  {event:<16} x{n:<6} last: {', '.join(extras) or '-'}")
    if eps:
        lines.append(f"  mean entries/sec: {sum(eps) / len(eps):,.0f}")
    return lines


def fit_summary_dict(path: str) -> dict:
    """Machine-readable fit-telemetry summary (the JSON analogue of
    :func:`summarize_fit`)."""
    counts: collections.Counter[str] = collections.Counter()
    last: dict[str, dict] = {}
    eps: list[float] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            event = rec.get("event", "?")
            counts[event] += 1
            last[event] = rec
            if "entries_per_sec" in rec:
                eps.append(float(rec["entries_per_sec"]))
    return {
        "path": path,
        "counts": dict(counts),
        "last": last,
        "mean_entries_per_sec": sum(eps) / len(eps) if eps else None,
    }


def report_dict(doc: dict, top: int) -> dict:
    """The whole report as one JSON-able object — what ``--format json``
    prints and what controller tests/CI assert on."""
    events = doc["traceEvents"]
    rows = stage_breakdown(events)
    names = _process_names(events)
    total = sum(r["total_ms"] for r in rows)
    return {
        "spans": sum(r["count"] for r in rows),
        "total_ms": total,
        "processes": sorted(names.values()),
        "stages": rows,
        "slowest": [
            {
                "stage": ev["name"],
                "instance": names.get(ev.get("pid"), str(ev.get("pid"))),
                "dur_ms": float(ev.get("dur", 0.0)) / 1e3,
                "args": {
                    k: v for k, v in ev.get("args", {}).items()
                    if k not in ("trace_id", "span_id", "parent_id")
                },
            }
            for ev in slowest_spans(events, top)
        ],
        "metrics": doc.get("repro_metrics"),
    }


def render(doc: dict, top: int) -> list[str]:
    events = doc["traceEvents"]
    rows = stage_breakdown(events)
    names = _process_names(events)
    lines: list[str] = []
    total = sum(r["total_ms"] for r in rows)
    n_spans = sum(r["count"] for r in rows)
    lines.append(
        f"{n_spans} spans, {len(rows)} stages, {len(names)} processes, "
        f"{total:.2f} ms total span time"
    )
    lines.append("")
    lines.append(f"{'stage':<20} {'count':>7} {'total ms':>10} "
                 f"{'mean ms':>9} {'max ms':>9} {'share':>7}")
    for r in rows:
        share = r["total_ms"] / total if total else 0.0
        lines.append(
            f"{r['stage']:<20} {r['count']:>7} {r['total_ms']:>10.2f} "
            f"{r['mean_ms']:>9.3f} {r['max_ms']:>9.3f} {share:>6.1%}"
        )
    lines.append("")
    lines.append(f"slowest {top} spans:")
    for ev in slowest_spans(events, top):
        who = names.get(ev.get("pid"), str(ev.get("pid")))
        args = {
            k: v for k, v in ev.get("args", {}).items()
            if k not in ("trace_id", "span_id", "parent_id")
        }
        lines.append(
            f"  {ev['name']:<20} {float(ev.get('dur', 0)) / 1e3:>9.3f} ms"
            f"  [{who}]  {args or ''}"
        )
    metrics = doc.get("repro_metrics")
    if metrics:
        lines.append("")
        lines.append("fleet cache hit rates:")
        fleet = metrics.get("fleet")
        if fleet:
            lines.append(
                f"  fleet     hits={fleet['hits']} misses={fleet['misses']} "
                f"hit_rate={fleet.get('hit_rate', 0):.3f}"
            )
        for iid, m in sorted(metrics.get("instances", {}).items()):
            c = m["cache"]
            lines.append(
                f"  {iid:<9} hits={c['hits']} misses={c['misses']} "
                f"hit_rate={c.get('hit_rate', 0):.3f} "
                f"p99_ms={m.get('decode_p99_ms')} "
                f"p99_ms_total={m.get('decode_p99_ms_total')}"
            )
        if metrics.get("excluded"):
            lines.append(f"  excluded: {', '.join(metrics['excluded'])}")
    return lines


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="summarize a Chrome trace-event file written by repro_torch.obs",
    )
    parser.add_argument("trace", help="trace.json (Chrome trace-event format)")
    parser.add_argument("--top", type=int, default=10,
                        help="how many slowest spans to show (default 10)")
    parser.add_argument("--fit", default=None,
                        help="also summarize a fit-telemetry JSONL file")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        help="output format (json = machine-readable)")
    args = parser.parse_args(argv)

    try:
        doc = load_trace(args.trace)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"repro_torch.obs.report: {e}", file=sys.stderr)
        return 1
    if args.format == "json":
        out = report_dict(doc, args.top)
        if args.fit:
            out["fit"] = fit_summary_dict(args.fit)
        print(json.dumps(out, indent=2, default=float))
        return 0
    for line in render(doc, args.top):
        print(line)
    if args.fit:
        print()
        for line in summarize_fit(args.fit):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
