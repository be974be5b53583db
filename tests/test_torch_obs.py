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


# ---------------------------------------------------------------------------
# exposition, the scrape server and the report: the fleet's side of obs
# ---------------------------------------------------------------------------
def _registries():
    """The same observations in both packages' registries."""
    out = []
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("decode_calls", instance="i0").inc(3)
        reg.counter("repairs_total", payload="e", kind="quality", outcome="ok").inc()
        reg.gauge("canary_fitness", payload='e"x\\y\n').set(0.75)
        reg.gauge("9bad name", **{"1label": "v"}).set(float("inf"))
        h = reg.histogram("decode_ms", buckets=(1.0, 10.0))
        for v in (0.5, 2.0, 20.0):
            h.observe(v)
        w = reg.histogram("flush_latency_seconds", window=8, instance="i1")
        for v in np.random.default_rng(0).random(20):
            w.observe(float(v))
        out.append(reg)
    return out


FLEET_SNAPSHOT = {
    "fleet": {"hits": 5, "misses": 1, "evictions": 0, "resident_bytes": 4096,
              "hit_rate": 0.8333},
    "backpressure_flushes": 2, "excluded": ["i2"], "excluded_total": 1,
    "decode_p50_ms": 0.25, "decode_p99_ms": None,
    "canary": {"e": {"checks": 2, "breaches": 0, "rolling_fitness": 0.9},
               "f": {"checks": 0, "breaches": 0, "rolling_fitness": None}},
    "instances": {"i0": {"cache": {"hits": 5, "hit_rate": 1.0}, "flushes": 4,
                         "decode_p50_ms": 0.2, "decode_p99_ms": 0.3,
                         "peak_inflight_bytes": 800},
                  "i1": {"cache": {}, "flushes": 0}},
}


def test_exposition_pages_are_the_references_byte_for_byte():
    from repro.obs.exposition import render_exposition as jrender
    from repro_torch.obs.exposition import render_exposition as render

    reg, jreg = _registries()
    cases = [((reg,), (jreg,)), ((reg.as_dict(),), (jreg.as_dict(),)),
             ((None, FLEET_SNAPSHOT), (None, FLEET_SNAPSHOT)),
             ((reg.as_dict(), FLEET_SNAPSHOT), (jreg.as_dict(), FLEET_SNAPSHOT)),
             ((reg, FLEET_SNAPSHOT), (jreg, FLEET_SNAPSHOT)), ((), ())]
    for ours, theirs in cases:
        page = render(*ours)
        assert page.encode() == jrender(*theirs).encode()
    page = render(reg, FLEET_SNAPSHOT)
    assert 'decode_ms_bucket{le="+Inf"} 3' in page
    assert "repro_fleet_cache_hits 5" in page and "repro_fleet_decode_p99_ms" not in page
    assert 'repro_fleet_instance_flushes{instance="i0"} 4' in page
    assert render() == ""


def test_exposition_of_a_live_fleet_is_the_references(tmp_path):
    """A port fleet's ``collect().as_dict()`` renders to the reference's
    page for the same snapshot, with the ``repro_fleet_*`` names."""
    from repro.obs.exposition import render_exposition as jrender
    from repro_torch import fleet
    from repro_torch.codecs import get_codec
    from repro_torch.obs.exposition import render_exposition as render
    from repro_torch.stream import sample_heldout, write_chunked

    x = np.random.default_rng(0).random((12, 10, 8)).astype(np.float32)
    path = str(tmp_path / "p.tcdc")
    write_chunked(path, get_codec("ttd").fit(x, max_rank=4), chunk_bytes=512,
                  heldout=sample_heldout(x, 64, seed=1))
    f = fleet.FleetFrontend(3, cache_bytes=1 << 16, canary_fraction=1.0, device="cpu")
    try:
        f.load_stream("e", path, tile_entries=128)
        f.decode_at("e", np.stack([np.arange(40) % s for s in x.shape], axis=1))
        snap = fleet.collect(f).as_dict()
        snapshot = f.metrics.as_dict()  # the frontend's flush-latency registry
        assert render(snapshot, fleet=snap) == jrender(snapshot, fleet=snap)
        page = render(fleet=snap)
        assert page == jrender(fleet=snap)
        assert "repro_fleet_instances 3" in page and "repro_fleet_canary_checks" in page
    finally:
        f.close()


def test_metrics_server_scrapes_over_loopback_and_404s():
    import urllib.error
    import urllib.request

    from repro_torch.obs.exposition import render_exposition
    from repro_torch.obs.serve_metrics import CONTENT_TYPE, MetricsServer

    reg = _registries()[0]
    with MetricsServer(lambda: render_exposition(registry=reg)) as srv:
        host, port = srv.address
        assert host == "127.0.0.1" and port > 0
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"] == CONTENT_TYPE
        assert body == render_exposition(registry=reg)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{host}:{port}/other", timeout=10)
        assert e.value.code == 404
    with MetricsServer(lambda: 1 / 0) as srv:  # a failing provider is a 500
        host, port = srv.address
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{host}:{port}/", timeout=10)
        assert e.value.code == 500


def test_serve_metrics_once_cli_matches_the_reference(tmp_path, capsys):
    from repro.obs import serve_metrics as jserve
    from repro_torch.obs import serve_metrics as tserve

    reg = _registries()[0]
    files = {"fleet.json": FLEET_SNAPSHOT, "registry.json": reg.as_dict(),
             "trace.json": {"traceEvents": [], "repro_metrics": FLEET_SNAPSHOT}}
    for name, doc in files.items():
        path = tmp_path / name
        path.write_text(json.dumps(doc))
        pages = []
        for mod in (tserve, jserve):
            assert mod.main([str(path), "--once"]) == 0
            pages.append(capsys.readouterr().out)
        assert pages[0] == pages[1] and pages[0]
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert tserve.main([str(bad), "--once"]) == 1
    assert "not a fleet/registry/trace" in capsys.readouterr().err


def _traced_file(tmp_path, metrics):
    """A trace of nested spans from two 'processes', exported by the port."""
    rec = obs.enable_tracing()
    rec.clear()
    try:
        with obs.span("controller.step"):
            with obs.span("controller.scale_up", instance="s0"):
                with obs.span("fleet.flush", tickets=3):
                    pass
        rec.ingest([obs.Span("decode_at", 9, 2, 1, 0.5, 0.75, {"payload": "e"}),
                    obs.Span("kernel_decode", 9, 3, 2, 0.6, 0.7, {"impl": "auto"})],
                   clock_offset=1.0, instance="w0")
        path = str(tmp_path / "trace.json")
        obs.export_chrome_trace(path, metrics=metrics)
    finally:
        obs.disable_tracing()
        rec.clear()
    return path


def test_report_dict_is_the_references_for_the_same_trace(tmp_path, capsys):
    from repro.obs import report as jreport
    from repro_torch.obs import report as treport

    fit = tmp_path / "fit.jsonl"
    fit.write_text("".join(json.dumps(r) + "\n" for r in [
        {"event": "fit_slab", "step": 1, "loss": 0.5, "entries_per_sec": 1000.0},
        {"event": "fit_slab", "step": 2, "loss": 0.25, "entries_per_sec": 3000.0},
        {"event": "version_append", "version": 0, "keyframe": True}]))
    metrics = {"fleet": {"hits": 1, "misses": 2, "hit_rate": 0.3333},
               "instances": {"w0": {"cache": {"hits": 1, "misses": 2, "hit_rate": 0.3333},
                                    "decode_p99_ms": 0.5}},
               "excluded": ["w9"]}
    path = _traced_file(tmp_path, metrics)
    for top in (1, 3, 10):
        doc = treport.load_trace(path)
        assert treport.report_dict(doc, top) == jreport.report_dict(jreport.load_trace(path),
                                                                    top)
        assert treport.render(doc, top) == jreport.render(doc, top)
    assert treport.fit_summary_dict(str(fit)) == jreport.fit_summary_dict(str(fit))
    assert treport.summarize_fit(str(fit)) == jreport.summarize_fit(str(fit))
    d = treport.report_dict(treport.load_trace(path), 10)
    assert d["spans"] == 5 and "w0" in d["processes"]
    outs = []
    for mod in (treport, jreport):
        assert mod.main([path, "--format", "json", "--fit", str(fit)]) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1]


def test_report_cli_rejects_a_non_trace_file(tmp_path):
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    bad = tmp_path / "not_a_trace.json"
    bad.write_text(json.dumps({"instances": {}}))
    path = _traced_file(tmp_path, None)
    env = {**os.environ, "PYTHONPATH": src}
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", str(bad)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "not a Chrome trace-event file" in res.stderr
    assert "repro_torch.obs.report" in res.stderr and not res.stdout
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", path, "--top", "2"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("5 spans, 5 stages, 2 processes")
    assert "jax" not in res.stderr


def test_socket_fleet_stitches_one_trace(tmp_path, recorder):
    """One traced request through a port socket fleet: the workers' spans
    (down to ``kernel_decode`` on an NTTD payload) come back over the wire,
    re-based and labelled with the worker, under the frontend's
    ``transport.flush``; the exported file reports both processes."""
    from repro_torch import fleet
    from repro_torch.codecs import get_codec
    from repro_torch.obs.report import load_trace, report_dict
    from repro_torch.stream import write_chunked

    x = np.random.default_rng(0).random((12, 10, 8)).astype(np.float32)
    path = str(tmp_path / "nttd.tcdc")
    enc = get_codec("nttd").fit(x, rank=3, hidden=6, epochs=1, device="cpu")
    write_chunked(path, enc, chunk_bytes=512)
    obs.disable_tracing()
    f = fleet.FleetFrontend(
        ["w0", "w1"], device="cpu",
        transport_factory=lambda iid: fleet.SocketTransport.spawn(iid, device="cpu"))
    try:
        f.load_stream("e", path)  # untiled: every request decodes
        idx = np.stack([np.arange(200) % s for s in x.shape], axis=1)
        untraced = f.decode_at("e", idx)
        obs.enable_tracing()
        recorder.clear()
        traced = f.decode_at("e", idx)
        spans = recorder.snapshot()
        trace = str(tmp_path / "fleet_trace.json")
        obs.export_chrome_trace(trace, metrics=fleet.collect(f).as_dict())
    finally:
        f.close()
    np.testing.assert_array_equal(traced, untraced)  # tracing is observational
    flushes = {s.span_id: s.attrs["instance"] for s in spans if s.name == "transport.flush"}
    remote = [s for s in spans if s.instance in ("w0", "w1")]
    ids = {s.span_id for s in remote}
    assert {s.name for s in remote} >= {"decode_at", "kernel_decode"}
    roots = [s for s in remote if s.parent_id not in ids]
    assert roots and all(flushes[s.parent_id] == s.instance for s in roots)
    assert len({s.trace_id for s in spans}) == 1  # one stitched trace
    doc = report_dict(load_trace(trace), top=3)
    assert {"w0", "w1"} & set(doc["processes"])
    assert {"transport.flush", "kernel_decode"} <= {r["stage"] for r in doc["stages"]}
