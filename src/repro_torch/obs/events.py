"""Operational event stream: a bounded in-process buffer + the JSONL sink,
as in ``repro.obs.events``.

Spans answer "where did the time go"; EVENTS answer "what did the system
decide" — a canary fitness breach, a controller scale-up, an instance
exclusion.  :func:`emit_event` appends to a bounded ring buffer (cheap,
always on, never grows) and forwards to the process-global fit-telemetry
sink when one is installed (``set_fit_log`` / ``REPRO_FIT_LOG``), so the
same JSONL file carries fit progress and serve-time decisions.

Tests and the fleet controller read the buffer back with
:func:`events`; it is a diagnostic window, not a durable queue — old
events fall off the end once ``maxlen`` is reached.
"""
from __future__ import annotations

import collections
import threading
import time

from repro_torch.obs import export as _export

#: ring-buffer capacity; oldest events are dropped beyond this
BUFFER_EVENTS = 1024

_BUFFER: collections.deque = collections.deque(maxlen=BUFFER_EVENTS)
_LOCK = threading.Lock()


def emit_event(kind: str, **fields) -> dict:
    """Record one operational event; returns the event dict.  Buffered
    in-process always; mirrored to the fit-telemetry JSONL sink when one
    is installed."""
    ev = {"event": str(kind), "t": round(time.time(), 6), **fields}
    with _LOCK:
        _BUFFER.append(ev)
    log = _export.fit_log()
    if log is not None:
        log.emit(ev["event"], **{k: v for k, v in ev.items() if k not in ("event", "t")})
    return ev


def events(kind: str | None = None) -> list[dict]:
    """Snapshot of the buffered events, oldest first, optionally filtered
    by kind."""
    with _LOCK:
        evs = list(_BUFFER)
    if kind is None:
        return evs
    return [e for e in evs if e["event"] == kind]


def clear_events() -> None:
    with _LOCK:
        _BUFFER.clear()
