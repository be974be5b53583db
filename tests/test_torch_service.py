"""The codec service (``repro_torch.serve.codec_service``) against the JAX
package's ``repro.serve.codec_service``, on the CPU.

The same container files, written by the reference's writer and by the
port's (byte-identical), are served by both packages' ``CodecService``
through one scripted sequence: eager and lazy loads, direct, tiled and
versioned queries, eviction under a byte budget, a coalesced flush with
one bad payload, canaries with a breach, the ownership filter, fault
injection and refresh, chunk export and unload.  The payloads are an
NTTD tensor (random params from a seed; decoded by the port's plain route
here and by the fused kernel on the card), a v4 NTTD chain, an NTTD file
with a TT read-repair patch, a TT file and the golden v4 file.  Answers
agree at rtol 1e-5 / atol 1e-6; every stats dict (``cache_stats``,
``PayloadInfo``, ``canary_stats``, ``quarantine_stats``, the metrics
registry, the quality-breach events) is equal, its canary fitness floats
within 1e-5 (they are sums over the decoded values).  The port's answers
and stats are bitwise the same with prefetch on and off and with tracing
on and off, and the plain decode runs exactly once per counted decode
call and canary check: the launch rule ``chip_smoke.py`` holds on the card.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.serve import codec_service as jservice
from repro.stream import writer as jwriter
from repro_torch import obs
from repro_torch.codecs import container, get_codec
from repro_torch.codecs.adapters import NTTDEncoded
from repro_torch.core import nttd
from repro_torch.core.codec import CompressedTensor
from repro_torch.core.folding import make_folding_spec
from repro_torch.kernels import ref as tref
from repro_torch.serve import codec_service as tservice
from repro_torch.stream import writer as twriter

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NPZ = np.load(os.path.join(GOLDEN, "expected.npz"))
SHAPE = (16, 12, 10)
N = int(np.prod(SHAPE))
TILE = 128
MAX_BATCH = 256
MIN_FITNESS = 0.9
RTOL, ATOL, FIT_TOL = 1e-5, 1e-6, 1e-5
NTTD_NAMES = ("eager", "nttd", "tiled", "patched", "chain", "chain_tiled")


def _nttd(seed: int, scale: float = 1.0) -> NTTDEncoded:
    spec = make_folding_spec(SHAPE)
    cfg = nttd.NTTDConfig(rank=4, hidden=8)
    params = nttd.init_params(torch.Generator().manual_seed(seed), spec, cfg, "cpu")
    rng = np.random.default_rng(seed)
    pi = [rng.permutation(n) for n in SHAPE]
    return NTTDEncoded(CompressedTensor(params, pi, spec, cfg, norm_mean=0.25 * scale,
                                        norm_std=2.0 * scale))


def _low_rank(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = sum(np.einsum("i,j,k->ijk", *(rng.normal(size=n) for n in SHAPE)) for _ in range(3))
    return (x + 0.01 * rng.normal(size=SHAPE)).astype(np.float32)


def _idx(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, n) for s in SHAPE], axis=1)


def _flat_idx(lo: int, hi: int, n: int, seed: int) -> np.ndarray:
    flat = np.random.default_rng(seed).integers(lo, hi, n)
    return np.stack(np.unravel_index(flat, SHAPE), axis=1).astype(np.int64)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_files(pkg_writer, root, enc, tt, heldouts, chain, overlay) -> dict:
    """The scripted sequence's files, written by one package's writer."""
    os.makedirs(root, exist_ok=True)
    paths = {k: os.path.join(root, f"{k}.tcdc") for k in ("nttd", "tt", "patched", "chain")}
    pkg_writer.write_chunked(paths["nttd"], enc, chunk_bytes=1024, heldout=heldouts[0])
    pkg_writer.write_chunked(paths["tt"], tt, chunk_bytes=512, heldout=heldouts[1])
    pkg_writer.write_chunked(paths["patched"], enc, chunk_bytes=1024)
    pkg_writer.append_patch(paths["patched"], overlay.to_bytes(), (256, 512), "ttd",
                            chunk_bytes=300)
    with pkg_writer.ChunkedWriter(paths["chain"], "nttd", delta=True) as w:
        for v, part in enumerate(chain):
            w.begin_version(v - 1)
            body = part.to_bytes()
            for at in range(0, len(body), 1024):
                w.append(body[at:at + 1024])
            w.sync()
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Both writers' files (byte-identical) and the eager NTTD blob."""
    tmp = tmp_path_factory.mktemp("service")
    enc = _nttd(0)
    dense = enc.to_dense().astype(np.float64).reshape(-1)
    rng = np.random.default_rng(9)
    held = np.sort(rng.choice(N, 64, replace=False)).astype(np.int64)
    noise = 0.05 * dense.std() * rng.standard_normal(64)
    x = _low_rank(1)
    tt = get_codec("ttd").fit(x, max_rank=8)
    heldouts = ((held, dense[held] + noise), twriter.sample_heldout(x, 64, seed=3))
    chain = [_nttd(0), _nttd(1, 0.1), _nttd(2, 0.1)]
    overlay = get_codec("ttd").fit(np.full((16, 16), 1.5, np.float32), max_rank=1)
    out = {"port": _write_files(twriter, str(tmp / "port"), enc, tt, heldouts, chain, overlay),
           "reference": _write_files(jwriter, str(tmp / "reference"), enc, tt, heldouts,
                                     chain, overlay)}
    for key in out["port"]:
        assert _read(out["port"][key]) == _read(out["reference"][key]), key
    return out, container.save_bytes(enc), float(dense.std())


@pytest.fixture(scope="module", autouse=True)
def fused_decode_route():
    """Both packages load NTTD payloads onto their fused decode route: the
    reference's jitted oracle (its default "ref" route compiles its scan
    anew at every call on the CPU, ~0.5 s a call), the port's wrapper,
    which runs the plain version on the CPU as its "auto" does."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_DECODE_IMPL", "fused")
        yield


@dataclasses.dataclass
class Pkg:
    service: object
    obs: object
    kw: dict


PORT = Pkg(tservice, obs, {"device": "cpu"})
REFERENCE = Pkg(jservice, jobs, {})


def _drive(pkg: Pkg, paths: dict, blob: bytes, noise_sigma: float,
           prefetch: bool = False) -> tuple[list, dict]:
    """One scripted run; returns (log of labelled answers, final stats)."""
    body = sum(c.length for c in container.open_container(paths["nttd"]).chunks)
    svc = pkg.service.CodecService(
        max_batch=MAX_BATCH, cache_bytes=body + 6 * TILE * 4, prefetch=prefetch,
        canary_fraction=0.5, canary_seed=0, canary_min_fitness=MIN_FITNESS, **pkg.kw)
    log = []

    def ask(label, name, idx, version=None):
        try:
            log.append((label, svc.decode_at(name, idx, version=version)))
        except Exception as e:  # noqa: BLE001 — the error is part of the script
            log.append((label, f"{type(e).__name__}: {e}"))

    pkg.obs.clear_events()
    svc.load("eager", blob)
    ask("eager", "eager", _idx(600, 1))  # > max_batch: three decode calls
    svc.load_stream("nttd", paths["nttd"])
    for s in range(4):
        ask(f"direct{s}", "nttd", _idx(300, 10 + s))
    svc.load_stream("tiled", paths["nttd"], tile_entries=TILE)
    for s in range(3):  # one window of four tiles: misses, then hits
        ask(f"window{s}", "tiled", _flat_idx(0, 4 * TILE, 200, 20 + s))
    ask("sweep", "tiled", _flat_idx(0, N, 600, 30))  # every tile: evictions
    svc.load_stream("tt", paths["tt"], tile_entries=64)
    ask("tt", "tt", _idx(200, 40))
    svc.load_stream("patched", paths["patched"])
    ask("patched", "patched", _idx(300, 41))
    svc.load_stream("chain", paths["chain"])
    svc.load_stream("chain_tiled", paths["chain"], tile_entries=TILE)
    svc.load_stream("golden", os.path.join(GOLDEN, "v4_delta.tcdc"), tile_entries=16)
    for v in (0, 1, 2, None):
        ask(f"chain_v{v}", "chain", _idx(300, 42), v)
        ask(f"chain_tiled_v{v}", "chain_tiled", _idx(300, 43), v)
        ask(f"golden_v{v}", "golden", NPZ["indices"], v)
    log.append(("shape_of", svc.shape_of("chain")))

    # a coalesced flush with one bad payload
    tickets = [svc.submit("nttd", _idx(50, 50)), svc.submit("tt", _idx(30, 51)),
               svc.submit("tiled", _idx(40, 52)), svc.submit("nttd", _idx(70, 53)),
               svc.submit("chain", _idx(20, 54), version=1)]
    svc.inject_fault("tt", {"kind": "corrupt_chunk", "chunk": 0})
    out = svc.flush()
    log += [(f"ticket{t}", out[t]) for t in tickets if t in out]
    log.append(("failed", {t: type(e).__name__ for t, e in svc.failed.items()}))
    log.append(("quarantine", svc.quarantine_stats()))
    log.append(("export_quarantined", svc.export_chunk("tt", 0)))
    svc.refresh("tt")
    ask("tt_refreshed", "tt", _idx(200, 40))

    # canaries: a seeded fraction of calls, then a breach under injected noise
    svc.inject_fault("nttd", {"kind": "fitness_noise", "entry_start": 0,
                              "entry_stop": N // 2, "sigma": noise_sigma, "seed": 1})
    for s in range(6):
        ask(f"noisy{s}", "nttd", _idx(100, 60 + s))
    canary_at_breach = svc.canary_stats()
    svc.refresh("nttd")
    ask("nttd_refreshed", "nttd", _idx(100, 60))

    # the ownership filter, tile export and admission
    ask("owned_warm", "tiled", _flat_idx(0, 6 * TILE, 200, 70))  # tiles 0-5 cached
    svc.set_ownership("tiled", pkg.service.Ownership(chunk_ids=frozenset({0}),
                                                      tile_ids=frozenset({0, 1, 2})))
    log.append(("drop_unowned", svc.drop_unowned("tiled")))
    ask("owned", "tiled", _flat_idx(0, 6 * TILE, 200, 71))  # 3-5 decode through
    tiles = svc.export_tiles("tiled")
    log.append(("export_tiles", sorted(tiles)))
    log.append(("admit", [svc.admit_tile("tiled", tid, tiles[0]) for tid in (3, 1)]))
    svc.set_ownership("tiled", pkg.service.Ownership(chunk_ids=frozenset(),
                                                      tile_ids=frozenset()))
    log.append(("drop_all", svc.drop_unowned("tiled")))
    ask("not_owned", "tiled", _idx(10, 71))
    log.append(("export_chunk", svc.export_chunk("nttd", 1)))
    log.append(("export_chain_chunk", svc.export_chunk("chain", 2)))
    log.append(("patched_info", dataclasses.asdict(svc.info("patched"))))
    svc.unload("patched")
    stats = {
        "cache": svc.cache_stats.as_dict(),
        "info": {n: dataclasses.asdict(svc.info(n)) for n in svc.payloads()},
        "canary": svc.canary_stats(),
        "canary_at_breach": canary_at_breach,
        "quarantine": svc.quarantine_stats(),
        "metrics": svc.metrics.as_dict(),
        "stats": svc.stats(),
        "payloads": svc.payloads(),
        "events": [{k: v for k, v in e.items() if k != "t"} for e in pkg.obs.events()],
    }
    return log, stats


def _same(got, want, float_tol: float, where: str = "") -> None:
    """Equal structure and values; floats within ``float_tol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], float_tol, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, float_tol, f"{where}[{k}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, abs=float_tol), where
    else:
        assert got == want, where


def _same_logs(got: list, want: list, exact: bool) -> None:
    assert [label for label, _ in got] == [label for label, _ in want]
    for (label, g), (_, w) in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype, label
            if exact:
                np.testing.assert_array_equal(g, w, err_msg=label)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=label)
        else:
            _same(g, w, 0.0 if exact else FIT_TOL, label)


@pytest.fixture(scope="module")
def runs(files):
    """The port's and the reference's runs, on each writer's files."""
    out, blob, std = files
    return {writer: {"port": _drive(PORT, paths, blob, 10 * std),
                     "reference": _drive(REFERENCE, paths, blob, 10 * std)}
            for writer, paths in out.items()}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_service_answers_match_reference(runs, writer):
    port, ref = runs[writer]["port"], runs[writer]["reference"]
    _same_logs(port[0], ref[0], exact=False)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("key", ["cache", "info", "canary", "canary_at_breach", "quarantine",
                                 "metrics", "stats", "payloads", "events"])
def test_service_stats_match_reference(runs, writer, key):
    _same(runs[writer]["port"][1][key], runs[writer]["reference"][1][key], FIT_TOL, key)


def test_scripted_sequence_exercises_every_path(files, runs):
    log, stats = runs["port"]["port"]
    answers = dict(log)
    assert stats["cache"]["evictions"] > 0
    assert stats["info"]["tiled"]["cache_hits"] > 0
    assert stats["info"]["tiled"]["cache_misses"] > 1
    assert answers["failed"] and set(answers["failed"].values()) == {"ChunkCorruptError"}
    assert list(answers["quarantine"]) == ["tt"] and list(answers["quarantine"]["tt"]) == [0]
    assert answers["export_quarantined"] is None
    assert stats["canary_at_breach"]["nttd"]["breaches"] > 0
    assert [e["event"] for e in stats["events"]].count("quality_breach") > 0
    assert stats["canary"]["tiled"]["checks"] > 0  # the clean file's canaries
    assert answers["drop_unowned"] > 0 and answers["admit"] == [False, True]
    assert answers["not_owned"].startswith("NotOwnedError")
    assert "patched" not in stats["payloads"]
    # an exported chunk is the file's bytes
    path = files[0]["port"]["nttd"]
    oc = container.open_container(path)
    try:
        c = oc.chunks[1]
        assert answers["export_chunk"] == bytes(oc.view[c.offset:c.offset + c.length])
    finally:
        oc.close()
    # the patched file serves the overlay inside its range
    flat = np.ravel_multi_index(tuple(_idx(300, 41).T), SHAPE)
    inside = (flat >= 256) & (flat < 512)
    np.testing.assert_allclose(answers["patched"][inside], 1.5, rtol=1e-6)


def test_versioned_answers_are_the_chain_sum(files, runs):
    """Every version's answer is the f64 sum of its chain's decodes, direct
    and tiled alike, as ``load_bytes``'s ``ChainEncoded`` gives it."""
    answers = dict(runs["port"]["port"][0])
    from repro_torch.temporal import VersionedReader

    with VersionedReader(files[0]["port"]["chain"], device="cpu") as reader:
        for v in (0, 1, 2, None):
            np.testing.assert_array_equal(answers[f"chain_v{v}"],
                                          reader.decode_at(_idx(300, 42), v))
            np.testing.assert_array_equal(answers[f"chain_tiled_v{v}"],
                                          reader.decode_at(_idx(300, 43), v))
    for v in (0, 1, 2):
        np.testing.assert_allclose(answers[f"golden_v{v}"], NPZ[f"v4_version{v}"],
                                   rtol=1e-5, atol=1e-6)


def test_prefetch_on_and_off_bitwise_equal(files, runs):
    paths, blob, std = files[0]["port"], files[1], files[2]
    off = runs["port"]["port"]
    on = _drive(PORT, paths, blob, 10 * std, prefetch=True)
    _same_logs(on[0], off[0], exact=True)
    _same(on[1], off[1], 0.0)


def test_prefetch_warm_that_finishes_first_counts_as_prefetch_off(files, runs, monkeypatch):
    """The caller descheduled right after each ``load_stream`` (as a busy
    CPU may leave it): every background warm runs to its end first.  The
    warm thread counts nothing, so the stats still equal prefetch off.
    Before, the warm counted its miss itself, and ``refresh`` then copied
    the old counters over the new payload's: ``info.nttd.cache_misses`` was
    4 against 5."""
    paths, blob, std = files[0]["port"], files[1], files[2]
    real = tservice.CodecService.load_stream

    def load_stream(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        time.sleep(0.05)  # the warm thread takes the interpreter meanwhile
        return out

    monkeypatch.setattr(tservice.CodecService, "load_stream", load_stream)
    on = _drive(PORT, paths, blob, 10 * std, prefetch=True)
    _same_logs(on[0], runs["port"]["port"][0], exact=True)
    _same(on[1], runs["port"]["port"][1], 0.0)


def test_tracing_on_and_off_bitwise_equal(files, runs, tmp_path):
    paths, blob, std = files[0]["port"], files[1], files[2]
    rec = obs.enable_tracing()
    rec.clear()
    try:
        traced = _drive(PORT, paths, blob, 10 * std, prefetch=True)
        spans = rec.snapshot()
        n = obs.export_chrome_trace(str(tmp_path / "trace.json"))
    finally:
        obs.disable_tracing()
        rec.clear()
    _same_logs(traced[0], runs["port"]["port"][0], exact=True)
    _same(traced[1], runs["port"]["port"][1], 0.0)
    names = {s.name for s in spans}
    assert {"decode_at", "materialize", "chunk_read", "tile_decode", "canary",
            "kernel_decode", "coalesce_flush", "prefetch_wait"} <= names
    # a kernel_decode span parents under the query that ran it
    by_id = {s.span_id: s for s in spans}
    kd = [s for s in spans if s.name == "kernel_decode" and s.parent_id in by_id]
    assert kd and {by_id[s.parent_id].name for s in kd} <= {
        "decode_at", "tile_decode", "canary", "kernel_decode"}
    import json

    doc = json.load(open(tmp_path / "trace.json"))
    assert n == len(spans) and len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == n


def test_plain_decode_runs_once_per_counted_call(files, monkeypatch):
    """The launch rule: the fused decode runs once per ``decode_calls`` of
    an NTTD payload plus once per canary check of one.  On the CPU the
    wrapper runs the plain version, counted here; on the card
    ``chip_smoke.py`` counts kernel launches by the same rule."""
    paths, blob, std = files[0]["port"], files[1], files[2]
    calls = []
    real = tref.nttd_decode_tile
    monkeypatch.setattr(tref, "nttd_decode_tile",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    log, stats = _drive(PORT, paths, blob, 10 * std)
    # refresh keeps PayloadInfo's counters but not canary_stats: count the
    # checks from the metrics registry, which refresh leaves alone
    checks = {c["labels"]["payload"]: c["value"] for c in stats["metrics"]["counters"]
              if c["name"] == "canary_checks"}
    info = dict(stats["info"], patched=dict(log)["patched_info"])
    want = sum(info[n]["decode_calls"] for n in NTTD_NAMES) + sum(
        checks.get(n, 0) for n in NTTD_NAMES)
    assert len(calls) == want and checks["nttd"] > 0


@pytest.mark.parametrize("name,key", [("v3_mono.tcdc", "v3"), ("v3_chunked.tcdc", "v3")])
def test_golden_v3_load_stream(name, key):
    svc = tservice.CodecService(device="cpu")
    svc.load_stream("g", os.path.join(GOLDEN, name))
    np.testing.assert_allclose(np.asarray(svc.decode_at("g", NPZ["indices"]), np.float64),
                               NPZ[key], rtol=1e-5, atol=1e-6)


def test_golden_v4_load_stream_all_versions():
    svc = tservice.CodecService(device="cpu")
    svc.load_stream("g", os.path.join(GOLDEN, "v4_delta.tcdc"))
    assert svc.info("g").n_versions == 3
    for v in range(3):
        np.testing.assert_allclose(svc.decode_at("g", NPZ["indices"], version=v),
                                   NPZ[f"v4_version{v}"], rtol=1e-5, atol=1e-6)


def test_golden_v2_has_no_lazy_open():
    svc = tservice.CodecService(device="cpu")
    with pytest.raises(ValueError, match="lazy open"):
        svc.load_stream("g", os.path.join(GOLDEN, "v2_nttd.bin"))
    with open(os.path.join(GOLDEN, "v2_nttd.bin"), "rb") as f:
        svc.load("g", f.read())  # the eager path takes it
    assert svc.info("g").codec == "nttd"


def test_service_materializes_nttd_on_its_device(files):
    svc = tservice.CodecService(device="cpu", prefetch=True)
    assert svc.device == torch.device("cpu")
    svc.load_stream("n", files[0]["port"]["nttd"])
    svc.decode_at("n", _idx(10, 0))
    assert svc._streams["n"].enc.ct.device.type == "cpu"
    svc.unload("n")
    assert svc.payloads() == []


def test_service_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tservice.CodecService()


def test_service_rejects_malformed_requests_like_the_reference(files):
    svcs = tservice.CodecService(device="cpu"), jservice.CodecService()
    idx = _idx(5, 0)
    for svc in svcs:
        svc.load_stream("t", files[0]["port"]["tt"])
    for bad, exc in ((idx[:, :2], ValueError), (idx + 1000, ValueError),
                     (idx.astype(np.float64), ValueError)):
        msgs = []
        for svc in svcs:
            with pytest.raises(exc) as e:
                svc.submit("t", bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for svc in svcs:
        with pytest.raises(KeyError, match="no payload"):
            svc.decode_at("missing", idx)
        with pytest.raises(ValueError, match="not versioned"):
            svc.decode_at("t", idx, version=0)
        with pytest.raises(ValueError, match="canary_fraction"):
            type(svc)(canary_fraction=1.5)
        assert svc.info("t").requests == 0
