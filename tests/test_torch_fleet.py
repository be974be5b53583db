"""``repro_torch.fleet`` against the JAX package's ``repro.fleet``, on the CPU.

- The consistent-hash ring: for the same members, vnodes and replication
  the port's owners are the reference's for every key, before and after
  membership changes, and a payload's route (groups, ownership tables)
  is the reference's for the same file.
- One scripted sequence through both packages' ``FleetFrontend`` over
  the same container files: load, ``decode_at``, submits with an empty
  request and a flush, a direct query resolving queued tickets, admission
  backpressure, canaries, a dead member excluded from routing, rebalance
  remove and add (drain barrier, warm handoff), with tiles on and off and
  replication 1 and 2.  A TT payload's answers are bitwise the
  reference's (the five NumPy codecs' payloads are byte-identical across
  the packages); an NTTD payload's agree at rtol 1e-5 / atol 1e-6, and
  within the port they are bitwise one ``CodecService``'s.  Rebalance
  reports, failures and ``collect().as_dict()`` (keys and counters) are
  the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.serve import codec_service as jservice
from repro_torch import fleet as tfleet
from repro_torch.codecs import container, get_codec
from repro_torch.codecs.adapters import NTTDEncoded
from repro_torch.core import nttd
from repro_torch.core.codec import CompressedTensor
from repro_torch.core.folding import make_folding_spec
from repro_torch.serve import codec_service as tservice
from repro_torch.stream import sample_heldout, write_chunked

SHAPE = (16, 12, 10)
N = int(np.prod(SHAPE))
RTOL, ATOL = 1e-5, 1e-6
PKGS = {"port": (tfleet, tservice), "reference": (jfleet, jservice)}
#: wall-clock and float-sum fields of collect().as_dict(), compared loosely
TIMING_KEYS = {"collected_at", "decode_p50_ms", "decode_p99_ms", "decode_p50_ms_total",
               "decode_p99_ms_total"}


@pytest.fixture(scope="module", autouse=True)
def fused_decode_route():
    """The reference decodes NTTD through its jitted fused oracle (its
    default "ref" recompiles at every call on the CPU); the port's wrapper
    runs the plain version on the CPU either way."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_DECODE_IMPL", "fused")
        yield


def _nttd(seed: int) -> NTTDEncoded:
    spec = make_folding_spec(SHAPE)
    cfg = nttd.NTTDConfig(rank=4, hidden=8)
    params = nttd.init_params(torch.Generator().manual_seed(seed), spec, cfg, "cpu")
    rng = np.random.default_rng(seed)
    pi = [rng.permutation(n) for n in SHAPE]
    return NTTDEncoded(CompressedTensor(params, pi, spec, cfg, norm_mean=0.25,
                                        norm_std=2.0))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A TT and an NTTD chunked file, both with a held-out block."""
    tmp = tmp_path_factory.mktemp("fleet")
    rng = np.random.default_rng(0)
    x = rng.random(SHAPE).astype(np.float32)
    paths = {"ttd": str(tmp / "ttd.tcdc"), "nttd": str(tmp / "nttd.tcdc")}
    write_chunked(paths["ttd"], get_codec("ttd").fit(x, max_rank=4), chunk_bytes=700,
                  heldout=sample_heldout(x, 64, seed=3))
    enc = _nttd(0)
    dense = enc.to_dense().astype(np.float64).reshape(-1)
    held = np.sort(rng.choice(N, 64, replace=False)).astype(np.int64)
    write_chunked(paths["nttd"], enc, chunk_bytes=1024,
                  heldout=(held, dense[held] + 0.01 * rng.standard_normal(64)))
    return paths


def _idx(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, n) for s in SHAPE], axis=1)


# ---------------------------------------------------------------------------
# the ring and the route
# ---------------------------------------------------------------------------
KEYS = [f"p/c{k}" for k in range(1000)] + [f"embed/t{k}" for k in range(1000)]


@pytest.mark.parametrize("replication", [1, 2])
def test_ring_owners_equal_the_reference(replication):
    members = [f"i{k}" for k in range(5)] + ["w0", "s0"]
    port = tfleet.HashRing(members, vnodes=64, replication=replication)
    ref = jfleet.HashRing(members, vnodes=64, replication=replication)
    for ring in (port, ref):
        ring.remove("i2")
        ring.add("s1")
    for key in KEYS:
        assert port.owners(key) == ref.owners(key), key
        assert port.owners(key, 3) == ref.owners(key, 3), key
    assert port.instances == ref.instances and len(port) == len(ref)
    assert port._points == ref._points


@pytest.mark.parametrize("vnodes,members", [(1, 1), (8, 3), (64, 4), (200, 2)])
def test_ring_owners_equal_the_reference_at_other_sizes(vnodes, members):
    ids = [f"m{k}" for k in range(members)]
    port = tfleet.HashRing(ids, vnodes=vnodes, replication=2)
    ref = jfleet.HashRing(ids, vnodes=vnodes, replication=2)
    assert [port.owners(k) for k in KEYS[::7]] == [ref.owners(k) for k in KEYS[::7]]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ring_rejects_bad_membership(pkg):
    ring = PKGS[pkg][0].HashRing(["i0"])
    with pytest.raises(ValueError, match="already"):
        ring.add("i0")
    with pytest.raises(KeyError, match="not on the ring"):
        ring.remove("nope")
    ring.remove("i0")
    with pytest.raises(RuntimeError, match="empty"):
        ring.owner("k")


@pytest.mark.parametrize("kind", ["ttd", "nttd"])
@pytest.mark.parametrize("tile_entries", [None, 64])
def test_route_equals_the_reference(files, kind, tile_entries):
    _, chunks, versions = container.container_index(files[kind])
    port = tfleet.PayloadRoute("e", SHAPE, chunks, tile_entries, versions)
    ref = jfleet.PayloadRoute("e", SHAPE, chunks, tile_entries, versions)
    ring_args = dict(vnodes=64, replication=2)
    members = ["i0", "i1", "i2"]
    flat = port.flat(_idx(500, 4))
    np.testing.assert_array_equal(flat, ref.flat(_idx(500, 4)))
    np.testing.assert_array_equal(port.group_of(flat), ref.group_of(flat))
    assert port.n_tiles == ref.n_tiles and port.n_chunks == ref.n_chunks
    assert (port.ownership_tables(tfleet.HashRing(members, **ring_args))
            == ref.ownership_tables(jfleet.HashRing(members, **ring_args)))


def test_route_rejects_a_broken_partition(files):
    _, chunks, _ = container.container_index(files["ttd"])
    bad = list(chunks)
    bad[1] = dataclasses.replace(bad[1], entry_start=bad[1].entry_start + 1)
    with pytest.raises(ValueError, match="partition"):
        tfleet.PayloadRoute("e", SHAPE, bad)


# ---------------------------------------------------------------------------
# the scripted sequence
# ---------------------------------------------------------------------------
def _script(pkg, path, tile_entries, replication):
    """One fleet's run -> (answers by label, facts by label)."""
    mod, _ = PKGS[pkg]
    kw = dict(device="cpu") if pkg == "port" else {}
    fleet = mod.FleetFrontend(4, cache_bytes=1 << 16, replication=replication,
                              max_inflight_bytes=2048, canary_fraction=0.5,
                              canary_min_fitness=0.5, **kw)
    answers, facts = {}, {}

    def ask(label, idx):
        try:
            answers[label] = fleet.decode_at("e", idx)
        except Exception as e:  # noqa: BLE001 - the failure is compared
            facts[label] = type(e).__name__

    try:
        fleet.load_stream("e", path, tile_entries=tile_entries)
        ask("first", _idx(300, 1))
        tickets = [fleet.submit("e", _idx(n, 10 + n)) for n in (40, 0, 250, 7)]
        out = fleet.flush()
        for k, t in enumerate(tickets):
            answers[f"submit{k}"] = out[t]
        queued = fleet.submit("e", _idx(33, 5))
        ask("direct_with_queued", _idx(120, 6))
        answers["queued"] = fleet.flush()[queued]
        facts["backpressure"] = fleet.backpressure_flushes
        victim = fleet.instances()[1]
        fleet.exclude(victim, mod.TransportError("dead"))
        ask("excluded", _idx(200, 7))
        facts["failed_excluded"] = sorted(type(e).__name__ for e in fleet.failed.values())
        pending = [fleet.submit("e", _idx(64, 20 + k)) for k in range(3)]
        report = mod.rebalance(fleet, remove=[victim])
        out = fleet.flush()  # queued before the rebalance, answered after it
        for k, t in enumerate(pending):
            if t in out:
                answers[f"drained{k}"] = out[t]
            else:  # a group whose one owner is the excluded member
                facts[f"drained{k}"] = type(fleet.failed[t]).__name__
        facts["remove"] = report.__dict__
        ask("after_remove", _idx(300, 8))
        report = mod.rebalance(fleet, add=["i9"])
        facts["add"] = report.__dict__
        ask("after_add", _idx(300, 9))
        ask("all", np.stack(np.unravel_index(np.arange(N), SHAPE), axis=1))
        facts["group_owners"] = fleet._group_owners["e"]
        facts["members"] = fleet.instances()
        facts["metrics"] = mod.collect(fleet).as_dict()
        facts["failed"] = sorted(fleet.failed)
    finally:
        fleet.close()
    return answers, facts


def _single(path, tile_entries):
    svc = tservice.CodecService(cache_bytes=1 << 16, device="cpu")
    svc.load_stream("e", path, tile_entries=tile_entries)
    return svc


def _same_tree(a, b, exact: bool, path="$"):
    """Nested dicts equal, floats within RTOL unless ``exact``; the timing
    fields need only the same presence and type."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            if k in TIMING_KEYS:
                assert (a[k] is None) == (b[k] is None), (path, k)
            else:
                _same_tree(a[k], b[k], exact, f"{path}.{k}")
    elif isinstance(a, float) and not exact:
        assert b == pytest.approx(a, rel=RTOL, abs=ATOL), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("replication", [1, 2])
@pytest.mark.parametrize("tile_entries", [None, 64])
@pytest.mark.parametrize("kind", ["ttd", "nttd"])
def test_scripted_sequence_matches_the_reference(files, kind, tile_entries, replication):
    path = files[kind]
    port, pfacts = _script("port", path, tile_entries, replication)
    ref, rfacts = _script("reference", path, tile_entries, replication)
    assert port.keys() == ref.keys()
    for label, got in port.items():
        want = ref[label]
        assert got.dtype == want.dtype and got.shape == want.shape, label
        if kind == "ttd":
            np.testing.assert_array_equal(got, want, err_msg=label)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=label)
    _same_tree(pfacts, rfacts, exact=kind == "ttd")
    assert pfacts["failed"] == [] and pfacts["add"]["added"] == ["i9"]
    if tile_entries:
        assert pfacts["add"]["tiles_warmed"]["e"] > 0
    if replication == 2:  # every group has a surviving replica
        assert "excluded" in port and pfacts["failed_excluded"] == []
    # within the port: bitwise one service, whatever the fleet's shape
    svc = _single(path, tile_entries)
    for label in ("first", "after_remove", "after_add", "all"):
        if label in port:
            want = svc.decode_at("e", _idx(300, {"first": 1, "after_remove": 8,
                                                 "after_add": 9}[label])
                                 if label != "all"
                                 else np.stack(np.unravel_index(np.arange(N), SHAPE), 1))
            np.testing.assert_array_equal(port[label], want, err_msg=label)
