"""``repro_torch.obs`` — low-overhead tracing + metrics for the serving
stack, the core of ``repro.obs``.

Spans thread through ``CodecService`` stages (``decode_at``,
``chunk_read``, ``materialize``, ``tile_decode``, ``prefetch_wait``,
``coalesce_flush``, ``canary``) down to the fused ``kernel_decode`` and
export as Chrome trace-event JSON that Perfetto loads directly.

    from repro_torch import obs

    obs.enable_tracing()                      # or REPRO_TRACE=1
    svc.decode_at("embed", idx)               # answers unchanged, bit-exact
    obs.export_chrome_trace("trace.json")

Design contract: tracing and metrics are OBSERVATIONAL ONLY — answers
and every cache counter are bit-identical with tracing off or on, and a
disabled recorder allocates nothing per span.  Spans are host spans: on
the card, ``kernel_decode`` times the launch's dispatch, not the kernel,
and no span synchronises the device.

Fit-time telemetry rides the same package: ``REPRO_FIT_LOG=fit.jsonl``
(or :func:`set_fit_log`) streams per-slab fit events (step, loss,
entries/sec, reservoir occupancy) and ``VersionedStore`` append
decisions as JSONL.  The reference's ``exposition``, ``report``,
``serve_metrics`` and ``slo`` modules are not ported yet.
"""
from repro_torch.obs.events import clear_events, emit_event, events
from repro_torch.obs.export import (
    JsonlEventLog,
    chrome_trace_events,
    export_chrome_trace,
    fit_event,
    fit_log,
    fit_telemetry_enabled,
    set_fit_log,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_latency_buckets,
)
from repro_torch.obs.trace import (
    Span,
    TraceRecorder,
    current_context,
    disable_tracing,
    enable_tracing,
    enabled,
    get_recorder,
    remote_context,
    span,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlEventLog",
    "MetricsRegistry",
    "Span",
    "TraceRecorder",
    "chrome_trace_events",
    "clear_events",
    "current_context",
    "default_latency_buckets",
    "disable_tracing",
    "emit_event",
    "enable_tracing",
    "enabled",
    "events",
    "export_chrome_trace",
    "fit_event",
    "fit_log",
    "fit_telemetry_enabled",
    "get_recorder",
    "remote_context",
    "set_fit_log",
    "span",
]
