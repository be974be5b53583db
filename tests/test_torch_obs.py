"""``repro_torch.obs`` against the JAX package's ``repro.obs``, on the CPU.

The recorder's semantics (the disabled path allocates nothing, the ring
bounds memory and counts drops, parentage nests and adopts a remote
context), the histogram's percentiles (all-time buckets against the exact
window, empty -> None), the registry, the Chrome trace export and the
fit-telemetry JSONL are those of ``tests/test_obs.py``; the same
observations go into both packages and their outputs must be equal.  The
port's stream fitters emit ``fit_slab`` events with the reference's keys,
and the fused decode runs inside a ``kernel_decode`` span.
"""
import io
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.stream import fit as jfit
from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.obs.trace import TraceRecorder
from repro_torch.stream import fit as tfit


@pytest.fixture()
def recorder():
    """A clean, enabled global recorder; restored to disabled after."""
    rec = obs.enable_tracing()
    rec.clear()
    yield rec
    obs.disable_tracing()
    rec.clear()


@pytest.fixture()
def fit_logs():
    """Both packages' fit-telemetry sinks on string buffers; cleared after."""
    bufs = io.StringIO(), io.StringIO()
    obs.set_fit_log(obs.JsonlEventLog(bufs[0]))
    jobs.set_fit_log(jobs.JsonlEventLog(bufs[1]))
    try:
        yield bufs
    finally:
        obs.set_fit_log(None)
        jobs.set_fit_log(None)


def _records(buf) -> list[dict]:
    return [json.loads(line) for line in buf.getvalue().splitlines()]


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------
def test_disabled_recorder_allocates_no_spans():
    rec = obs.get_recorder()
    obs.disable_tracing()
    before = rec.span_allocs
    for _ in range(100):
        with obs.span("hot", k=1):
            pass
    assert rec.span_allocs == before  # zero Span objects on the off path
    assert len(rec) == 0 or rec.snapshot()[-1].name != "hot"
    # the disabled context manager is one shared object, not per-call
    assert obs.span("a") is obs.span("b")


def test_enabled_recorder_records_nested_parentage(recorder):
    with obs.span("outer", stage="o") as outer:
        with obs.span("inner") as inner:
            pass
    by_name = {s.name: s for s in recorder.snapshot()[-2:]}
    assert by_name["inner"].trace_id == by_name["outer"].trace_id
    assert by_name["inner"].parent_id == by_name["outer"].span_id
    assert by_name["outer"].parent_id == 0  # root
    assert by_name["inner"].t_start >= by_name["outer"].t_start
    assert by_name["inner"].t_end <= by_name["outer"].t_end
    assert outer.attrs == {"stage": "o"}
    assert inner.duration >= 0.0


@pytest.mark.parametrize("capacity,n", [(4, 10), (1, 3), (8, 8)])
def test_ring_capacity_bounds_memory_and_counts_drops(capacity, n):
    recs = [TraceRecorder(capacity=capacity), jobs.TraceRecorder(capacity=capacity)]
    for rec in recs:
        rec.enabled = True
        for k in range(n):
            with rec.span(f"s{k}"):
                pass
    port, ref = recs
    assert len(port) == len(ref) == min(capacity, n)
    assert port.dropped == ref.dropped == max(n - capacity, 0)
    assert [s.name for s in port.snapshot()] == [s.name for s in ref.snapshot()]


def test_env_capacity_and_default(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_CAPACITY", "7")
    assert TraceRecorder().capacity == jobs.TraceRecorder().capacity == 7
    monkeypatch.delenv("REPRO_TRACE_CAPACITY")
    assert TraceRecorder().capacity == jobs.TraceRecorder().capacity == 16384


def test_span_records_exception_and_reraises(recorder):
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("x")
    s = recorder.snapshot()[-1]
    assert s.name == "boom" and s.attrs["error"] == "ValueError"


def test_ingest_rebases_clock_and_labels_instance(recorder):
    remote = TraceRecorder(capacity=8)
    remote.enabled = True
    with remote.span("w"):
        pass
    (w,) = remote.drain()
    recorder.ingest([w], clock_offset=100.0, instance="w3")
    got = recorder.snapshot()[-1]
    assert got.instance == "w3"
    assert got.t_start == pytest.approx(w.t_start + 100.0)
    assert got.duration == pytest.approx(w.duration)


def test_remote_context_adopts_parent(recorder):
    with obs.remote_context((42, 7)):
        with obs.span("adopted"):
            pass
    s = recorder.snapshot()[-1]
    assert (s.trace_id, s.parent_id) == (42, 7)
    assert obs.current_context() is None  # the ambient context is restored


def test_enable_tracing_resizes_the_ring(recorder):
    obs.enable_tracing(capacity=3)
    try:
        for k in range(5):
            with obs.span(f"s{k}"):
                pass
        assert [s.name for s in recorder.snapshot()] == ["s2", "s3", "s4"]
        assert obs.enabled()
    finally:
        obs.enable_tracing(capacity=16384)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def test_histogram_empty_percentiles_are_none_not_crash():
    h = obs.Histogram("lat", ())
    assert h.percentile(50) is None
    assert h.percentile(99) is None
    assert h.window_percentile(50) is None
    assert h.mean is None


def test_histogram_window_percentiles_are_exact():
    h = obs.Histogram("lat", (), window=100)
    vals = [0.001 * k for k in range(1, 101)]
    for v in vals:
        h.observe(v)
    assert h.window_percentile(50) == pytest.approx(np.percentile(vals, 50))
    assert h.window_percentile(99) == pytest.approx(np.percentile(vals, 99))
    assert h.count == 100 and h.min == vals[0] and h.max == vals[-1]


def test_histogram_alltime_survives_window_wrap():
    h = obs.Histogram("lat", (), window=4)
    for _ in range(100):
        h.observe(0.001)  # old regime
    for _ in range(10):
        h.observe(1.0)  # recent regime fills the whole window
    assert h.window_percentile(50) == pytest.approx(1.0)
    assert h.percentile(50) == pytest.approx(0.001, rel=1.0)
    assert h.count == 110


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_matches_reference(seed):
    """The same observations give the reference's buckets and percentiles,
    bit for bit (the same float arithmetic in the same order)."""
    rng = np.random.default_rng(seed)
    vals = np.exp(rng.normal(-6.0, 2.5, 500))
    hs = obs.Histogram("lat", (), window=64), jobs.Histogram("lat", (), window=64)
    for h in hs:
        for v in vals:
            h.observe(v)
    port, ref = hs
    assert port.bucket_counts == ref.bucket_counts
    assert port.bounds == ref.bounds == obs.default_latency_buckets()
    for q in (1, 25, 50, 90, 99, 100):
        assert port.percentile(q) == ref.percentile(q)
        assert port.window_percentile(q) == ref.window_percentile(q)
    assert (port.count, port.total, port.min, port.max) == (ref.count, ref.total,
                                                            ref.min, ref.max)


def test_histogram_rejects_unsorted_buckets():
    with pytest.raises(ValueError, match="ascend"):
        obs.Histogram("lat", (), buckets=(1.0, 0.5))


def test_registry_get_or_create_remove_and_as_dict():
    regs = obs.MetricsRegistry(), jobs.MetricsRegistry()
    for reg in regs:
        c = reg.counter("requests", instance="i0")
        assert reg.counter("requests", instance="i0") is c
        c.inc(3)
        g = reg.gauge("peak", instance="i0")
        g.set_max(10)
        g.set_max(5)  # peak keeps the high-water mark
        reg.gauge("last", instance="i0").set(2.5)
        reg.histogram("lat", instance="i0").observe(0.5)
    port, ref = regs
    d = port.as_dict()
    assert d == ref.as_dict()
    assert d["counters"] == [{"name": "requests", "labels": {"instance": "i0"}, "value": 3}]
    assert d["gauges"][0]["value"] == 10
    assert d["histograms"][0]["count"] == 1
    assert d["histograms"][0]["window_p99"] == pytest.approx(0.5)
    port.remove("lat", instance="i0")
    assert port.as_dict()["histograms"] == []


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------
def test_chrome_trace_export_is_valid_and_loadable(tmp_path, recorder):
    with obs.span("stage_a", payload="p"):
        with obs.span("stage_b"):
            pass
    path = str(tmp_path / "trace.json")
    n = obs.export_chrome_trace(path, metrics={"fleet": None, "instances": {}})
    assert n == 2
    doc = json.load(open(path))
    assert isinstance(doc["traceEvents"], list)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    ms = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {e["name"] for e in xs} == {"stage_a", "stage_b"}
    assert ms[0]["name"] == "process_name"
    for e in xs:  # required Chrome trace-event fields
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["ts"] >= 0 and e["dur"] >= 0
    assert doc["repro_metrics"]["instances"] == {}


def test_chrome_trace_events_match_reference():
    """The same spans render to the reference's trace events."""
    spans = [
        obs.Span("a", 5, 1, 0, 10.0, 10.5, {"payload": "p"}),
        obs.Span("b", 5, 2, 1, 10.1, 10.2, {}, "w1"),
        obs.Span("c", 6, 3, 0, 11.0, 11.0, {"tiles": 3}),
    ]
    ref_spans = [jobs.Span(s.name, s.trace_id, s.span_id, s.parent_id, s.t_start, s.t_end,
                           dict(s.attrs), s.instance) for s in spans]
    assert obs.chrome_trace_events(spans) == jobs.chrome_trace_events(ref_spans)
    assert obs.chrome_trace_events([]) == jobs.chrome_trace_events([]) == []


# ---------------------------------------------------------------------------
# fit telemetry and events
# ---------------------------------------------------------------------------
def test_jsonl_event_log_and_fit_event_hook():
    buf = io.StringIO()
    log = obs.set_fit_log(obs.JsonlEventLog(buf))
    try:
        assert obs.fit_telemetry_enabled()
        obs.fit_event("fit_slab", step=1, loss=0.5)
        obs.fit_event("version_append", version=0, keyframe=True)
        assert log.events_written == 2
    finally:
        obs.set_fit_log(None)
    assert not obs.fit_telemetry_enabled()
    obs.fit_event("dropped")  # no sink: must be a silent no-op
    recs = _records(buf)
    assert [r["event"] for r in recs] == ["fit_slab", "version_append"]
    assert recs[0]["loss"] == 0.5 and "t" in recs[0]


def test_jsonl_log_rotates_at_max_bytes(tmp_path):
    path = str(tmp_path / "fit.jsonl")
    with obs.JsonlEventLog(path, max_bytes=200, backups=2) as log:
        for k in range(20):
            log.emit("fit_slab", step=k, pad="x" * 20)
        assert log.rotations > 0 and log.bytes_written <= 200
    assert (tmp_path / "fit.jsonl.1").exists()
    last = _records(io.StringIO((tmp_path / "fit.jsonl").read_text()))[-1]
    assert last["step"] == 19  # the newest event survives
    borrowed = obs.JsonlEventLog(io.StringIO(), max_bytes=60)
    for k in range(5):
        borrowed.emit("e", k=k)
    assert borrowed.events_dropped > 0 and borrowed.events_written >= 1


def test_env_fit_log(monkeypatch, tmp_path):
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv("REPRO_FIT_LOG", path)
    monkeypatch.setattr(obs.export, "_FIT_LOG_INIT", False)
    try:
        assert obs.fit_telemetry_enabled()
        assert obs.fit_log().max_bytes == 64 << 20
        obs.fit_event("version_append", version=0)
    finally:
        obs.set_fit_log(None)
    assert [r["event"] for r in _records(io.StringIO(open(path).read()))] == ["version_append"]


def test_emit_event_buffers_and_mirrors_to_the_fit_log(fit_logs):
    obs.clear_events()
    ev = obs.emit_event("quality_breach", payload="p", fitness=0.5)
    obs.emit_event("payload_refreshed", payload="p")
    assert obs.events("quality_breach") == [ev]
    assert [e["event"] for e in obs.events()] == ["quality_breach", "payload_refreshed"]
    assert [r["event"] for r in _records(fit_logs[0])] == ["quality_breach",
                                                            "payload_refreshed"]
    obs.clear_events()
    assert obs.events() == []


def test_nttd_stream_fitter_emits_slab_events_with_reference_keys(fit_logs):
    rng = np.random.default_rng(0)
    shape = (8, 6, 4)
    opts = dict(rank=2, hidden=4, steps_per_slab=2, batch_size=64, replay_capacity=128)
    port = tfit.NTTDStreamFitter(shape, **opts, kernel_impl="ref", device="cpu")
    ref = jfit.NTTDStreamFitter(shape, **opts)
    for _ in range(2):
        idx = np.stack([rng.integers(0, s, 200) for s in shape], axis=1)
        vals = rng.random(200).astype(np.float32)
        port.update(idx, vals)
        ref.update(idx, vals)
    port_slabs, ref_slabs = ([r for r in _records(b) if r["event"] == "fit_slab"]
                             for b in fit_logs)
    assert len(port_slabs) == len(ref_slabs) == 2
    for got, want in zip(port_slabs, ref_slabs):
        assert got.keys() == want.keys()
        assert got["codec"] == "nttd" and isinstance(got["loss"], float)
        assert got["entries"] == 200 and got["entries_per_sec"] > 0
        for k in ("step", "entries", "reservoir_fill", "reservoir_capacity"):
            assert got[k] == want[k], k
    assert port_slabs[0]["step"] == 0 and port_slabs[1]["step"] == 1


def test_nttd_stream_fitter_without_telemetry_reads_no_loss(monkeypatch):
    """Telemetry off: the fit never converts its loss to a host float."""
    assert not obs.fit_telemetry_enabled()
    reads = []
    real = torch.Tensor.__float__

    def counted(self):
        reads.append(1)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "__float__", counted)
    fitter = tfit.NTTDStreamFitter((8, 6, 4), rank=2, hidden=4, steps_per_slab=2,
                                   batch_size=64, kernel_impl="ref", device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(2):
        idx = np.stack([rng.integers(0, s, 100) for s in (8, 6, 4)], axis=1)
        fitter.update(idx, rng.random(100).astype(np.float32))
    assert reads == [] and fitter.loss is not None


def test_ttice_stream_fitter_emits_reference_slab_events(fit_logs):
    rng = np.random.default_rng(2)
    shape = (12, 5, 4)
    x = rng.random(shape)
    flat = x.reshape(-1)
    port = tfit.TTICEStreamFitter(shape, max_rank=3)
    ref = jfit.TTICEStreamFitter(shape, max_rank=3)
    idx = np.stack(np.unravel_index(np.arange(flat.size), shape), axis=1)
    for lo in range(0, flat.size, 70):  # slabs cutting rows mid-way
        for f in (port, ref):
            f.update(idx[lo:lo + 70], flat[lo:lo + 70])
    got, want = ([{k: v for k, v in r.items() if k != "t"} for r in _records(b)]
                 for b in fit_logs)
    assert got == want and len(got) > 1
    assert {r["codec"] for r in got} == {"tt_ice"}


# ---------------------------------------------------------------------------
# the kernel_decode span
# ---------------------------------------------------------------------------
def _decode_operands(b, t=3, m=5, h=4, r=2):
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, m, (b, t), generator=g, dtype=torch.int32)
    ws = [torch.randn(s, generator=g) * 0.3 for s in
          [(t, m, h), (h, 4 * h), (h, 4 * h), (4 * h,), (h, r), (r,), (h, r * r), (r * r,),
           (h, r), (r,)]]
    return idx, ws


@pytest.mark.parametrize("impl", ["ref", "auto", "fused"])
def test_kernel_decode_span_wraps_the_fused_decode(recorder, impl):
    idx, ws = _decode_operands(7)
    out = ops.nttd_decode_tile(idx, *ws, impl=impl)
    spans = [s for s in recorder.snapshot() if s.name == "kernel_decode"]
    assert len(spans) == 1 and spans[0].attrs == {"impl": impl, "b": 7}
    # tracing is observational: the same answer with it off
    obs.disable_tracing()
    torch.testing.assert_close(ops.nttd_decode_tile(idx, *ws, impl=impl), out,
                               rtol=0, atol=0)
    assert len([s for s in recorder.snapshot() if s.name == "kernel_decode"]) == 1


def test_kernel_decode_span_skips_empty_batches(recorder):
    idx, ws = _decode_operands(0)
    assert ops.nttd_decode_tile(idx, *ws).shape == (0,)
    assert not [s for s in recorder.snapshot() if s.name == "kernel_decode"]


def test_versioned_store_emits_append_events(tmp_path, fit_logs):
    from repro.temporal import VersionedStore as JStore
    from repro_torch.temporal import VersionedStore

    rng = np.random.default_rng(3)
    base = rng.random((12, 10)).astype(np.float32)
    for cls, name in ((VersionedStore, "p.tcdc"), (JStore, "r.tcdc")):
        with cls.create(str(tmp_path / name), "ttd", keyframe_interval=4,
                        keyframe_opts={"max_rank": 4}, delta_opts={"max_rank": 2}) as store:
            for k in range(3):
                store.append(base + 0.01 * k)
    got, want = ([{k: v for k, v in r.items() if k != "t"} for r in _records(b)
                  if r["event"] == "version_append"] for b in fit_logs)
    assert got == want
    assert [r["version"] for r in got] == [0, 1, 2]
    assert got[0]["keyframe"] is True and got[1]["keyframe"] is False
