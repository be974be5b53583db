"""Trace/telemetry export: Chrome trace-event JSON + structured JSONL, as
in ``repro.obs.export``; the files are the reference's format.

Two sinks:

- :func:`export_chrome_trace` renders recorded spans as Chrome
  trace-event format (the ``{"traceEvents": [...]}`` JSON object that
  ``chrome://tracing`` and https://ui.perfetto.dev load directly).  Each
  span becomes one complete ("ph": "X") event; fleet instances map to
  numbered pids with ``process_name`` metadata events so the frontend
  and every worker render as separate swim-lanes on ONE stitched
  timeline.  An optional fleet-metrics snapshot rides along under the
  top-level ``repro_metrics`` key (ignored by viewers, consumed by the
  reference's ``python -m repro.obs.report``, which reads these files).

- :class:`JsonlEventLog` appends one JSON object per line — the
  fit-telemetry format.  ``repro_torch.stream`` fitters and
  ``repro_torch.temporal.VersionedStore`` emit through the process-global
  :func:`fit_event` hook, which is a no-op unless a sink was installed
  (``set_fit_log(path)`` or ``REPRO_FIT_LOG=path``), so fitting pays
  nothing when telemetry is off.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import IO

from repro_torch.obs.trace import Span, get_recorder


def chrome_trace_events(spans: list[Span], time_base: float | None = None) -> list[dict]:
    """Spans -> Chrome trace-event dicts (timestamps in microseconds,
    re-based so the earliest span starts at ``ts=0``)."""
    if time_base is None:
        time_base = min((s.t_start for s in spans), default=0.0)
    pids: dict[str, int] = {}
    events: list[dict] = []
    for s in spans:
        pid = pids.get(s.instance)
        if pid is None:
            pid = pids[s.instance] = len(pids) + 1
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": s.instance},
            })
        events.append({
            "name": s.name,
            "cat": "repro",
            "ph": "X",
            "ts": round((s.t_start - time_base) * 1e6, 3),
            "dur": round(max(s.t_end - s.t_start, 0.0) * 1e6, 3),
            "pid": pid,
            "tid": pid,
            "args": dict(
                s.attrs,
                trace_id=f"{s.trace_id:x}",
                span_id=f"{s.span_id:x}",
                parent_id=f"{s.parent_id:x}",
            ),
        })
    return events


def export_chrome_trace(
    path: str,
    spans: list[Span] | None = None,
    metrics: dict | None = None,
) -> int:
    """Write a Chrome trace-event JSON file; returns the span count.
    ``spans`` defaults to a snapshot of the global recorder (buffer
    unchanged); ``metrics`` (any JSON-able dict, e.g. the fleet metrics
    roll-up's ``as_dict()``) is embedded under ``repro_metrics``."""
    if spans is None:
        spans = get_recorder().snapshot()
    doc: dict = {
        "traceEvents": chrome_trace_events(spans),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs", "spans": len(spans)},
    }
    if metrics is not None:
        doc["repro_metrics"] = metrics
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(spans)


# ---------------------------------------------------------------------------
# structured-event JSONL (fit telemetry)
# ---------------------------------------------------------------------------
class JsonlEventLog:
    """Append-only JSONL event sink; every ``emit`` is one flushed line,
    so a crashed fit leaves a readable prefix.

    ``max_bytes`` bounds the sink so a week-long ``fit_stream`` cannot
    fill the disk: a path-owned log ROTATES (``path`` -> ``path.1`` ->
    ... -> ``path.{backups}``, oldest dropped) and keeps writing, so the
    newest events always survive; a borrowed file object has nowhere to
    rotate to, so over-limit events are DROPPED and counted in
    ``events_dropped`` instead.  One event larger than the whole limit
    still rotates-then-writes (the alternative is losing it silently).
    Default is unbounded, matching the old behavior.
    """

    def __init__(
        self,
        path_or_file: str | IO[str],
        *,
        max_bytes: int | None = None,
        backups: int = 1,
    ):
        self.max_bytes = max_bytes
        self.backups = max(int(backups), 1)
        if isinstance(path_or_file, str):
            self._path: str | None = path_or_file
            self._f: IO[str] = open(path_or_file, "a")
            self._owns = True
            try:
                self._bytes = os.path.getsize(path_or_file)
            except OSError:
                self._bytes = 0
        else:
            self._path = None
            self._f = path_or_file
            self._owns = False
            self._bytes = 0
        self._lock = threading.Lock()
        self.events_written = 0
        self.events_dropped = 0
        self.rotations = 0

    @property
    def bytes_written(self) -> int:
        """Bytes in the CURRENT file (resets on rotation)."""
        return self._bytes

    def _rotate(self) -> None:
        self._f.close()
        for i in range(self.backups, 0, -1):
            src = self._path if i == 1 else f"{self._path}.{i - 1}"
            dst = f"{self._path}.{i}"
            if os.path.exists(src):
                os.replace(src, dst)
        self._f = open(self._path, "w")
        self._bytes = 0
        self.rotations += 1

    def emit(self, event: str, **fields) -> None:
        rec = {"event": event, "t": round(time.time(), 6), **fields}
        line = json.dumps(rec, default=float) + "\n"
        with self._lock:
            if (
                self.max_bytes is not None
                and self._bytes + len(line) > self.max_bytes
            ):
                if self._path is None:
                    self.events_dropped += 1
                    return
                self._rotate()
            self._f.write(line)
            self._f.flush()
            self._bytes += len(line)
            self.events_written += 1

    def close(self) -> None:
        with self._lock:
            if self._owns:
                self._f.close()

    def __enter__(self) -> "JsonlEventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_FIT_LOG: JsonlEventLog | None = None
_FIT_LOG_INIT = False
_FIT_LOCK = threading.Lock()


def _default_max_bytes() -> int | None:
    """Size bound for PATH-based global sinks: 64 MiB per file unless
    ``REPRO_FIT_LOG_MAX_BYTES`` overrides it (0 = unbounded)."""
    return int(os.environ.get("REPRO_FIT_LOG_MAX_BYTES", str(64 << 20))) or None


def set_fit_log(sink: str | IO[str] | JsonlEventLog | None) -> JsonlEventLog | None:
    """Install (or clear, with ``None``) the process-global fit-telemetry
    sink.  Returns the active log.  A path string gets the default size
    bound (see :func:`fit_log`); pass a :class:`JsonlEventLog` to choose
    your own."""
    global _FIT_LOG, _FIT_LOG_INIT
    with _FIT_LOCK:
        if _FIT_LOG is not None and sink is not _FIT_LOG:
            _FIT_LOG.close()
        if sink is None:
            _FIT_LOG = None
        elif isinstance(sink, JsonlEventLog):
            _FIT_LOG = sink
        elif isinstance(sink, str):
            _FIT_LOG = JsonlEventLog(sink, max_bytes=_default_max_bytes())
        else:
            _FIT_LOG = JsonlEventLog(sink)
        _FIT_LOG_INIT = True
    return _FIT_LOG


def fit_log() -> JsonlEventLog | None:
    """The active fit-telemetry sink, honoring ``REPRO_FIT_LOG`` on first
    use; ``None`` when telemetry is off.  Env-installed sinks are bounded
    (rotation at ``REPRO_FIT_LOG_MAX_BYTES``, default 64 MiB) so leaving
    telemetry on for a week cannot fill the disk."""
    global _FIT_LOG_INIT
    if not _FIT_LOG_INIT:
        with _FIT_LOCK:
            if not _FIT_LOG_INIT:
                path = os.environ.get("REPRO_FIT_LOG")
                if path:
                    globals()["_FIT_LOG"] = JsonlEventLog(
                        path, max_bytes=_default_max_bytes()
                    )
                globals()["_FIT_LOG_INIT"] = True
    return _FIT_LOG


def fit_telemetry_enabled() -> bool:
    """Cheap guard for call sites whose FIELD computation has a cost
    (e.g. forcing a device sync to read a loss scalar)."""
    return fit_log() is not None


def fit_event(event: str, **fields) -> None:
    """Emit one fit-telemetry event; no-op (one attribute read) when no
    sink is installed."""
    log = fit_log()
    if log is not None:
        log.emit(event, **fields)
