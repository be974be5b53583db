"""Ring-buffer span recorder: the tracing core of ``repro_torch.obs``, as
in ``repro.obs.trace``.

One process holds one global :class:`TraceRecorder` — a bounded deque of
finished :class:`Span` records.  ``span(name, **attrs)`` is the single
instrumentation primitive: a context manager that snapshots monotonic
start/end times and parents itself under the ambient (trace id, span id)
context, which propagates through nested ``with`` blocks via a
``contextvars.ContextVar`` (thread- and task-correct).

Cost model — the whole point of this module:

- **disabled** (the default): ``span()`` returns one shared no-op
  context manager.  No ``Span`` object, no recorder append, no id
  allocation — the recorder's ``span_allocs`` counter observably stays
  flat, which ``tests/test_torch_obs.py`` asserts.
- **enabled** (``REPRO_TRACE=1`` or :func:`enable_tracing`): one small
  object + two ``perf_counter`` calls per span, appended to a
  ``maxlen``-bounded deque, so memory is capped no matter how long the
  process serves.

Cross-process stitching: a worker adopts the frontend's (trace id,
span id) via :func:`remote_context`, records its spans against ITS
monotonic clock, and ships them back in the flush reply; the frontend
calls :meth:`TraceRecorder.ingest` with a clock offset so every span in
the buffer lives on one frontend timeline.  Tracing never touches decode
inputs or cache counters — answers are bit-identical on or off.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import os
import time

#: ambient (trace_id, span_id) the next span parents under; None = new trace
_CTX: contextvars.ContextVar[tuple[int, int] | None] = contextvars.ContextVar(
    "repro_torch_obs_ctx", default=None
)

#: default ring capacity (spans); REPRO_TRACE_CAPACITY overrides
DEFAULT_CAPACITY = 16384


@dataclasses.dataclass(slots=True)
class Span:
    """One finished span: half-open ``[t_start, t_end)`` on the recording
    process's monotonic clock (seconds)."""

    name: str
    trace_id: int
    span_id: int
    parent_id: int  # 0 = root of its trace
    t_start: float
    t_end: float
    attrs: dict
    #: which fleet member recorded it ("frontend" unless ingested)
    instance: str = "frontend"

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


class _NoopSpan:
    """The shared disabled-path context manager: allocation-free entry."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoopSpan()


class _LiveSpan:
    """An open span: created by ``TraceRecorder.span`` when enabled."""

    __slots__ = ("_rec", "_span", "_token")

    def __init__(self, rec: "TraceRecorder", name: str, attrs: dict):
        self._rec = rec
        parent = _CTX.get()
        sid = next(rec._ids)
        if parent is None:
            tid, pid = rec.new_trace_id(), 0
        else:
            tid, pid = parent[0], parent[1]
        self._span = Span(name, tid, sid, pid, 0.0, 0.0, attrs, rec.service)
        rec.span_allocs += 1

    def __enter__(self) -> Span:
        self._token = _CTX.set((self._span.trace_id, self._span.span_id))
        self._span.t_start = time.perf_counter()
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        self._span.t_end = time.perf_counter()
        _CTX.reset(self._token)
        if exc_type is not None:
            self._span.attrs = dict(self._span.attrs, error=exc_type.__name__)
        self._rec._append(self._span)


class TraceRecorder:
    """Bounded in-memory span store for one process."""

    def __init__(self, capacity: int | None = None, service: str = "frontend"):
        if capacity is None:
            capacity = int(os.environ.get("REPRO_TRACE_CAPACITY", DEFAULT_CAPACITY))
        self.capacity = capacity
        self.service = service
        self.enabled = False
        # no lock: deque append/copy/clear/popleft are single C calls, so
        # they are atomic under the GIL — instance-executor threads record
        # concurrently without contending on anything
        self._spans: collections.deque[Span] = collections.deque(maxlen=capacity)
        # span ids are process-unique; trace ids additionally fold in the
        # pid so two processes opening traces concurrently cannot collide
        self._ids = itertools.count(1)
        self._trace_base = (os.getpid() & 0xFFFFF) << 40
        #: Span objects ever created — the disabled path must keep this
        #: flat (asserted by the zero-allocation smoke test)
        self.span_allocs = 0
        #: spans dropped by the ring bound (admission is never blocked)
        self.dropped = 0

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **attrs):
        """Start a span (context manager).  Returns the shared no-op when
        the recorder is disabled — zero allocations on the hot path."""
        if not self.enabled:
            return _NOOP
        return _LiveSpan(self, name, attrs)

    def new_trace_id(self) -> int:
        return self._trace_base | next(self._ids)

    def _append(self, s: Span) -> None:
        if len(self._spans) == self._spans.maxlen:
            self.dropped += 1  # the bounded deque evicts the oldest span
        self._spans.append(s)

    # -- reading ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._spans)

    def snapshot(self) -> list[Span]:
        """Copy of the buffered spans, oldest first (buffer unchanged)."""
        return list(self._spans)

    def drain(self) -> list[Span]:
        """Pop every buffered span — what a worker ships in a flush reply.
        Pops one at a time so spans recorded concurrently (e.g. by a
        prefetch thread) are either drained or left for the next drain,
        never lost."""
        out = []
        try:
            while True:
                out.append(self._spans.popleft())
        except IndexError:
            return out

    def clear(self) -> None:
        self._spans.clear()

    def ingest(
        self, spans: list[Span], *, clock_offset: float = 0.0,
        instance: str | None = None,
    ) -> None:
        """Stitch spans recorded on ANOTHER process's clock into this
        buffer: ``clock_offset`` (this process's ``perf_counter`` minus the
        remote one, sampled at reply time) re-bases their timestamps onto
        the local timeline; ``instance`` labels who recorded them."""
        for s in spans:
            if clock_offset:
                s = dataclasses.replace(
                    s, t_start=s.t_start + clock_offset, t_end=s.t_end + clock_offset
                )
            if instance is not None:
                s = dataclasses.replace(s, instance=instance)
            self._append(s)


# ---------------------------------------------------------------------------
# the process-global recorder
# ---------------------------------------------------------------------------
_RECORDER = TraceRecorder()
_RECORDER.enabled = os.environ.get("REPRO_TRACE", "") not in ("", "0")


def get_recorder() -> TraceRecorder:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER.enabled


def enable_tracing(capacity: int | None = None) -> TraceRecorder:
    """Turn the global recorder on (idempotent).  ``capacity`` resizes the
    ring, dropping buffered spans."""
    if capacity is not None and capacity != _RECORDER.capacity:
        _RECORDER.capacity = capacity
        _RECORDER._spans = collections.deque(maxlen=capacity)
    _RECORDER.enabled = True
    return _RECORDER


def disable_tracing() -> None:
    _RECORDER.enabled = False


def span(name: str, **attrs):
    """Module-level convenience over the global recorder — THE primitive
    every instrumentation point in the repo calls."""
    rec = _RECORDER
    if not rec.enabled:
        return _NOOP
    return _LiveSpan(rec, name, attrs)


def current_context() -> tuple[int, int] | None:
    """The ambient (trace id, span id), for wire propagation."""
    return _CTX.get()


def remote_context(ctx: tuple[int, int] | None):
    """Adopt a (trace id, span id) shipped from another process so local
    spans stitch under the remote parent; ``None`` is a no-op."""
    if ctx is None:
        return contextlib.nullcontext()
    return _AdoptedContext(ctx)


class _AdoptedContext:
    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: tuple[int, int]):
        self._ctx = ctx

    def __enter__(self) -> None:
        self._token = _CTX.set(self._ctx)

    def __exit__(self, *exc) -> None:
        _CTX.reset(self._token)
