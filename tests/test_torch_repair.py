"""``repro_torch.fleet.repair`` against the JAX package's
``repro.fleet.repair``, on the CPU.

- Corruption: a CRC-flipped chunk on its primary owner costs no failed
  ticket (failover), both packages' controllers raise the same ticket
  and restore the chunk from the same donor, and the repaired file is
  byte-identical to the pristine one.  A v4 keyframe restore re-validates
  every dependent chain; a chunk no replica can vouch for fails cleanly.
- Quality: an injected regression in one chunk's range is found by the
  canary, refit by the port's ``NTTDStreamFitter`` on the CPU (the
  training kernels' plain versions) and lands as a patch overlay: held-out
  fitness recovers as in the reference's test, entries outside the range
  stay bitwise the pristine answers, and the reference's ``load_bytes``
  reads the patched file to the port's answers (rtol 1e-5 / atol 1e-6).
- ``_range_shape`` and ``_nearest_divisor`` equal the reference's over
  its grid and beyond.
"""
import shutil

import numpy as np
import pytest
import torch

from repro.codecs import container as jcontainer
from repro.fleet import FleetFrontend as JFleetFrontend
from repro.fleet import RepairController as JRepairController
from repro.fleet import repair as jrepair
from repro_torch.codecs import container, get_codec
from repro_torch.codecs.indexing import flat_to_multi
from repro_torch.fleet import FleetFrontend, RepairConfig, RepairController
from repro_torch.fleet import repair as trepair
from repro_torch.fleet.worker import parse_fault_flags
from repro_torch.serve.codec_service import CodecService
from repro_torch.stream import sample_heldout, write_chunked
from repro_torch.temporal import VersionedStore, drifting_versions
from repro_torch.temporal.store import _fitness

SHAPE = (16, 12, 8)
N = int(np.prod(SHAPE))
CANARY_MIN_FITNESS = 0.95
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The refit is many small ops: one intra-op thread keeps it from
    spinning against the suite's other workers on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _truth() -> np.ndarray:
    i, j, k = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    return (np.sin(0.3 * i) * np.cos(0.2 * j) * np.sin(0.15 * k)
            + 0.5 * np.cos(0.1 * i) * np.sin(0.25 * j) * np.cos(0.3 * k)).astype(np.float32)


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    x = _truth()
    path = str(tmp_path_factory.mktemp("repair") / "pristine.tcdc")
    write_chunked(path, get_codec("ttd").fit(x, max_rank=4), chunk_bytes=1024,
                  heldout=sample_heldout(x, 128, seed=3))
    return path


def _copy(pristine, tmp_path, name="payload.tcdc"):
    path = str(tmp_path / name)
    shutil.copyfile(pristine, path)
    return path


def _inject(target, *, corrupt=None, noise=None):
    for name, faults in parse_fault_flags(corrupt, noise).items():
        for fault in faults:
            target.inject_fault(name, fault)


def _batches(n=4, per=400):
    rng = np.random.default_rng(2)
    return [np.stack([rng.integers(0, s, per) for s in SHAPE], axis=1) for _ in range(n)]


def _chunk_range(path, cid):
    _, chunks, _ = container.container_index(path)
    return int(chunks[cid].entry_start), int(chunks[cid].entry_stop)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _all_idx():
    return flat_to_multi(np.arange(N, dtype=np.int64), SHAPE)


# ---------------------------------------------------------------- corruption
def _corruption_run(pkg, path):
    """Corrupt chunk 1 on its primary owner, serve through it, repair ->
    (tickets, report fields, answers)."""
    if pkg == "port":
        fleet = FleetFrontend(["i0", "i1", "i2"], replication=2, device="cpu")
        ctl_cls = RepairController
    else:
        fleet = JFleetFrontend(["i0", "i1", "i2"], replication=2)
        ctl_cls = JRepairController
    try:
        fleet.load_stream("e", path, tile_entries=256)
        lo, _ = _chunk_range(path, 1)
        gid = int(fleet.routes["e"].group_of(np.array([lo], dtype=np.int64))[0])
        victim = fleet._group_owners["e"][gid][0]
        _inject(fleet.transports[victim], corrupt=["e:1"])
        answers = [fleet.decode_at("e", idx) for idx in _batches()]
        assert not fleet.failed
        ctl = ctl_cls(fleet)
        tickets = [(t.payload, t.kind, t.instance, t.chunk, t.entry_start, t.entry_stop)
                   for t in ctl.poll()]
        reports = ctl.run()
        facts = [(r.kind, r.ok, r.chunks_restored, r.donors, r.error) for r in reports]
        answers += [fleet.decode_at("e", idx) for idx in _batches()]
        left = ctl.poll()
        quarantine = [t.stats().get("quarantine") for t in fleet.transports.values()]
        return tickets, facts, answers, victim, left, quarantine
    finally:
        fleet.close()


def test_corruption_repair_restores_the_chunk_byte_exactly(pristine, tmp_path):
    port_path = _copy(pristine, tmp_path, "port.tcdc")
    ref_path = _copy(pristine, tmp_path, "ref.tcdc")
    tickets, facts, answers, victim, left, quarantine = _corruption_run("port", port_path)
    ref = _corruption_run("reference", ref_path)
    assert (tickets, facts) == (ref[0], ref[1]) and victim == ref[3]
    assert [t[1] for t in tickets] == ["corruption"] and tickets[0][3] == 1
    assert facts[0][1] and facts[0][2] == [1] and facts[0][3][1] != victim
    assert _read(port_path) == _read(pristine)  # byte-exact
    single = CodecService(device="cpu")
    single.load_stream("e", pristine, tile_entries=256)
    for got, idx, want in zip(answers, _batches() * 2, ref[2]):
        np.testing.assert_array_equal(got, single.decode_at("e", idx))
        np.testing.assert_array_equal(got, want)
    assert not left and not any(quarantine)


def test_no_donor_fails_cleanly(pristine, tmp_path):
    path = _copy(pristine, tmp_path)
    fleet = FleetFrontend(["i0", "i1"], replication=2, device="cpu")
    try:
        fleet.load_stream("e", path, tile_entries=256)
        lo, hi = _chunk_range(path, 1)
        idx = flat_to_multi(np.arange(lo, hi, dtype=np.int64), SHAPE)
        for iid in ("i0", "i1"):
            _inject(fleet.transports[iid], corrupt=["e:1"])
            with pytest.raises(ValueError):
                fleet.services[iid].decode_at("e", idx)
        assert len(RepairController(fleet).poll()) == 1  # one damage, one ticket
        [report] = RepairController(fleet).run()
        assert not report.ok and "no live replica" in report.error
        assert _read(path) == _read(pristine)
    finally:
        fleet.close()


def test_keyframe_restore_revalidates_dependent_chains(tmp_path):
    path = str(tmp_path / "chain.tcdc")
    with VersionedStore.create(path, "ttd", keyframe_interval=4, chunk_bytes=2048,
                               keyframe_opts={"max_rank": 4},
                               delta_opts={"max_rank": 2}) as store:
        for x in drifting_versions(SHAPE, 5, drift=0.05, noise=0.02, seed=5):
            store.append(x)
    pristine = _read(path)
    _, chunks, versions = container.container_index(path)
    kf_chunk = int(versions[0].chunk_start)
    fleet = FleetFrontend(["i0", "i1"], replication=2, device="cpu")
    try:
        fleet.load_stream("e", path, tile_entries=256)
        probe = np.stack([np.arange(8) % s for s in SHAPE], axis=1).astype(np.int64)
        reference = [fleet.decode_at("e", probe, version=v) for v in range(5)]
        _inject(fleet.transports["i0"], corrupt=[f"e:{kf_chunk}"])
        with pytest.raises(ValueError):
            fleet.services["i0"].decode_at("e", probe, version=0)
        ctl = RepairController(fleet)
        assert [t.chunk for t in ctl.poll()] == [kf_chunk]
        [report] = ctl.run()
        assert report.ok, report.error
        assert report.donors == {kf_chunk: "i1"} and report.chains_revalidated == 5
        for v in range(5):
            np.testing.assert_array_equal(fleet.decode_at("e", probe, version=v), reference[v])
        assert not ctl.poll() and _read(path) == pristine
    finally:
        fleet.close()


# ------------------------------------------------------------------- quality
def test_quality_repair_refits_with_the_ports_stream_fitter(pristine, tmp_path):
    path = _copy(pristine, tmp_path)
    single = CodecService(device="cpu")
    single.load_stream("e", pristine, tile_entries=256)
    batches = _batches()
    reference = [single.decode_at("e", idx) for idx in batches]
    ref_all = single.decode_at("e", _all_idx())

    fleet = FleetFrontend(["i0", "i1", "i2"], replication=2, canary_fraction=1.0,
                          canary_min_fitness=CANARY_MIN_FITNESS, device="cpu")
    try:
        fleet.load_stream("e", path, tile_entries=256)
        lo, hi = _chunk_range(path, 2)
        for t in fleet.transports.values():
            _inject(t, noise=[f"e:{lo}:{hi}:0.4:5"])
        flat = np.arange(N)
        outside = (flat < lo) | (flat >= hi)

        def serve_round():
            for k, idx in enumerate(batches):
                keep = ~((np.ravel_multi_index(tuple(idx.T), SHAPE) >= lo)
                         & (np.ravel_multi_index(tuple(idx.T), SHAPE) < hi))
                np.testing.assert_array_equal(fleet.decode_at("e", idx)[keep],
                                              reference[k][keep])
            assert not fleet.failed

        ctl = RepairController(fleet, RepairConfig(reorder=True))
        quality = []
        for _ in range(8):
            serve_round()
            quality = [t for t in ctl.poll() if t.kind == "quality"]
            if quality:
                break
        assert quality and (quality[0].entry_start, quality[0].entry_stop) == (lo, hi)
        [refit] = [r for r in ctl.run() if r.kind == "quality"]
        assert refit.ok, refit.error
        assert refit.fitness_before < CANARY_MIN_FITNESS < refit.fitness_after
        assert refit.refit_entries > 0 and refit.refit_entries_per_sec > 0
        serve_round()
        served = fleet.decode_at("e", _all_idx())
        np.testing.assert_array_equal(served[outside], ref_all[outside])
        counters = {c["labels"]["outcome"]: c["value"]
                    for c in fleet.metrics.as_dict()["counters"] if c["name"] == "repairs_total"}
        assert counters == {"ok": 1}
    finally:
        fleet.close()

    # the patched file, read by the reference and by the port, decodes alike
    blob = _read(path)
    port_enc = container.load_bytes(blob, device="cpu")
    ref_enc = jcontainer.load_bytes(blob)
    ours = np.asarray(port_enc.decode_at(_all_idx()), np.float64)
    np.testing.assert_allclose(np.asarray(ref_enc.decode_at(_all_idx()), np.float64), ours,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, served, rtol=RTOL, atol=ATOL)
    oc = container.open_container(path)
    try:
        sel = (oc.heldout.indices >= lo) & (oc.heldout.indices < hi)
        h_idx, h_vals = oc.heldout.indices[sel].copy(), oc.heldout.values[sel].copy()
    finally:
        oc.close()
    assert len(h_idx) > 4
    pre = _fitness(h_vals, ref_all[h_idx])
    assert _fitness(h_vals, ours[h_idx]) >= pre - 0.05


def test_quality_repair_rejects_bad_ranges(pristine, tmp_path):
    path = _copy(pristine, tmp_path)
    fleet = FleetFrontend(["i0"], replication=1, device="cpu")
    try:
        fleet.load_stream("e", path, tile_entries=256)
        ctl = RepairController(fleet)
        assert not ctl.repair_quality("e", 10, 10).ok
        assert not ctl.repair_quality("e", -4, 10).ok
        small = RepairController(fleet, RepairConfig(max_patch_entries=8))
        report = small.repair_quality("e", 0, 256)
        assert not report.ok and "max_patch_entries" in report.error
        assert _read(path) == _read(pristine)
    finally:
        fleet.close()


def test_refit_trains_on_the_controllers_device(tmp_path, monkeypatch):
    """The fleet's device reaches the stream fitter through its options;
    a ``device`` in ``refit_opts`` wins."""
    from repro_torch.stream import fit as tfit

    class Seen(Exception):
        pass

    def spy(self, shape, **opts):
        raise Seen(str(opts.get("device")))

    monkeypatch.setattr(tfit.NTTDStreamFitter, "__init__", spy)
    fleet = FleetFrontend(["i0"], device="cpu")
    try:
        sub = np.zeros((4, 4, 4), np.float32)
        for ctl, want in ((RepairController(fleet), "cpu"),
                          (RepairController(fleet, RepairConfig(
                              refit_opts={"rank": 2, "device": "meta"})), "meta")):
            with pytest.raises(Seen, match=want):
                ctl._refit(sub)
    finally:
        fleet.close()


# ------------------------------------------------------------------- helpers
GRID = [1, 2, 7, 97, 256, 384, 1536, 4096, 9973, 30030]


@pytest.mark.parametrize("n", GRID + list(range(3, 2000, 37)))
def test_range_shape_equals_the_reference(n):
    dims = trepair._range_shape(n)
    assert dims == jrepair._range_shape(n)
    assert int(np.prod(dims)) == max(n, 1) and 1 <= len(dims) <= 3


def test_nearest_divisor_equals_the_reference():
    cases = [(12, 3), (12, 5), (7, 3), (100, 1000), (1, 0), (30030, 31)]
    cases += [(n, t) for n in range(1, 200, 7) for t in range(0, 40, 3)]
    for n, t in cases:
        assert trepair._nearest_divisor(n, t) == jrepair._nearest_divisor(n, t), (n, t)
    assert trepair._nearest_divisor(12, 5) == 4 and trepair._nearest_divisor(7, 3) == 1
