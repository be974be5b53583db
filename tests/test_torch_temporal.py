"""The versioned store and drift (``repro_torch.temporal``) against the JAX
package's ``repro.temporal``, on the CPU.

``drifting_versions`` is host NumPy in both packages: bitwise the same
arrays.  A ``VersionedStore`` on ``"ttd"`` (host NumPy) writes a file
byte-identical to the reference's, with equal append stats and
``version_append`` decisions, ``rekey_below`` included; ``revalidate_chains``
gives the reference's verdicts on a clean and on a corrupted file.  An
NTTD store (fitted on the CPU here; on the card in ``chip_smoke.py``)
written by either package loads in the other's ``VersionedReader`` and
``CodecService``: answers within rtol 1e-5 / atol 1e-6.
"""
import os

import numpy as np
import pytest

from repro.serve.codec_service import CodecService as JService
from repro.temporal import VersionedStore as JStore
from repro.temporal import drifting_versions as jdrift
from repro.temporal import revalidate_chains as jrevalidate
from repro_torch.serve.codec_service import CodecService
from repro_torch.temporal import (
    ChainEncoded,
    VersionedReader,
    VersionedStore,
    drifting_versions,
    revalidate_chains,
)

SHAPE = (12, 10, 8)
RTOL, ATOL = 1e-5, 1e-6
TT_STORE = dict(keyframe_interval=4, chunk_bytes=2048, keyframe_opts={"max_rank": 8},
                delta_opts={"max_rank": 2})
NTTD_SHAPE = (8, 6, 5)
NTTD_STORE = dict(
    keyframe_interval=3, chunk_bytes=512,
    keyframe_opts=dict(rank=3, hidden=6, epochs=2, batch_size=128, eval_batch=256,
                       init_reorder=False, update_reorder=False, seed=0),
    delta_opts=dict(rank=2, hidden=4, d_prime=2, lr=1e-2, batch_size=64,
                    steps_per_slab=5, seed=0),
)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _probe(shape=SHAPE, n=200, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, n) for s in shape], axis=1)


def _write(cls, path, codec, data, **kw):
    with cls.create(str(path), codec, **kw) as store:
        return [store.append(x) for x in data]


@pytest.mark.parametrize("shape,n,kw", [
    ((12, 10, 8), 5, dict(drift=0.05, noise=0.02, seed=5)),
    ((24, 16, 16), 8, dict(drift=0.04, noise=0.03, seed=11)),
    ((7, 5), 3, {}),
])
def test_drifting_versions_bitwise_equal(shape, n, kw):
    got, want = drifting_versions(shape, n, **kw), jdrift(shape, n, **kw)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_drifting_versions_rejects_no_versions():
    with pytest.raises(ValueError, match="n_versions"):
        drifting_versions((4, 4), 0)


@pytest.fixture(scope="module")
def tt_stores(tmp_path_factory):
    """(port path, reference path, data, port stats, reference stats)."""
    tmp = tmp_path_factory.mktemp("tt_store")
    data = drifting_versions(SHAPE, 5, drift=0.05, noise=0.02, seed=5)
    port = _write(VersionedStore, tmp / "p.tcdc", "ttd", data, **TT_STORE)
    ref = _write(JStore, tmp / "r.tcdc", "ttd", data, **TT_STORE)
    return str(tmp / "p.tcdc"), str(tmp / "r.tcdc"), data, port, ref


def test_ttd_store_file_byte_identical(tt_stores):
    port_path, ref_path, _, port, ref = tt_stores
    assert _read(port_path) == _read(ref_path)
    assert port == ref
    assert [s["keyframe"] for s in port] == [True, False, False, False, True]


def test_ttd_reader_matches_reference(tt_stores):
    port_path, _, data, stats, _ = tt_stores
    idx = _probe()
    with VersionedReader(port_path) as reader, JStore.open(port_path) as ref:
        assert reader.n_versions == ref.n_versions == len(data)
        assert [(v.base, v.chunk_start, v.chunk_stop) for v in reader.versions] == \
            [(v.base, v.chunk_start, v.chunk_stop) for v in ref.versions]
        for v in range(len(data)):
            assert reader.version_bytes(v) == ref.version_bytes(v)
            np.testing.assert_array_equal(reader.decode(v), ref.decode(v))
            np.testing.assert_array_equal(reader.decode_at(idx, v), ref.decode_at(idx, v))
            x64 = np.asarray(data[v], np.float64)
            hat = reader.decode(v)
            fit = 1 - np.linalg.norm(x64 - hat) / np.linalg.norm(x64)
            assert fit == pytest.approx(stats[v]["fitness"], abs=1e-6)
        assert isinstance(reader.encoded(), ChainEncoded)
        np.testing.assert_array_equal(reader.decode(), reader.decode(len(data) - 1))


@pytest.mark.parametrize("rekey_below,drift", [(0.999, 0.3), (None, 0.3), (0.5, 0.01)])
def test_rekey_decisions_match_reference(tmp_path, rekey_below, drift):
    data = drifting_versions((10, 8, 6), 4, drift=drift, noise=0.1, seed=9)
    kw = dict(keyframe_interval=100, keyframe_opts={"max_rank": 6},
              delta_opts={"max_rank": 1}, rekey_below=rekey_below)
    port = _write(VersionedStore, tmp_path / "p.tcdc", "ttd", data, **kw)
    ref = _write(JStore, tmp_path / "r.tcdc", "ttd", data, **kw)
    assert port == ref
    assert _read(tmp_path / "p.tcdc") == _read(tmp_path / "r.tcdc")
    if rekey_below == 0.999:  # a rank-1 residual cannot hold the chain above .999
        assert any(s["rekeyed"] for s in port[1:])


def test_store_rejects_what_the_reference_rejects(tmp_path):
    for bad, match in ((dict(keyframe_interval=0), "keyframe_interval"),
                       (dict(chunk_bytes=0), "chunk_bytes")):
        for cls in (VersionedStore, JStore):
            with pytest.raises(ValueError, match=match):
                cls.create(str(tmp_path / "bad.tcdc"), "ttd", **bad)
    with VersionedStore.create(str(tmp_path / "m.tcdc"), "ttd",
                               keyframe_opts={"max_rank": 2}) as s:
        s.append(np.zeros((4, 4, 4), np.float32) + 1)
        with pytest.raises(ValueError, match="shape"):
            s.append(np.ones((4, 4, 5), np.float32))
    with pytest.raises(ValueError, match="not a v4"):
        VersionedReader(os.path.join(os.path.dirname(__file__), "golden", "v3_chunked.tcdc"))


def _corrupt_chunk(path, chunk) -> None:
    from repro_torch.codecs import container

    oc = container.open_container(path)
    off = oc.chunks[chunk].offset
    oc.close()
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("corrupt", [None, 0, "last"])
def test_revalidate_chains_matches_reference(tmp_path, tt_stores, corrupt):
    port_path, _, data, _, _ = tt_stores
    path = str(tmp_path / "v.tcdc")
    with open(path, "wb") as f:
        f.write(_read(port_path))
    if corrupt is not None:
        with VersionedReader(path) as reader:
            n_chunks = reader.versions[-1].chunk_stop
        _corrupt_chunk(path, 0 if corrupt == 0 else n_chunks - 1)
    truth = {0: data[0], 2: data[2], 4: data[4]}
    got, want = revalidate_chains(path, truth), jrevalidate(path, truth)
    assert [(h.version, h.chain, h.ok, h.error, h.fitness) for h in got] == \
        [(h.version, h.chain, h.ok, h.error, h.fitness) for h in want]
    if corrupt == 0:  # the keyframe's chunk: every version of its chain fails
        assert [h.ok for h in got] == [False, False, False, False, True]


# ---------------------------------------------------------------------------
# NTTD stores: each package's file in the other's reader and service
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nttd_stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nttd_store")
    data = drifting_versions(NTTD_SHAPE, 3, seed=11)
    port = _write(VersionedStore, tmp / "p.tcdc", "nttd", data, device="cpu", **NTTD_STORE)
    ref = _write(JStore, tmp / "r.tcdc", "nttd", data, **NTTD_STORE)
    return {"port": str(tmp / "p.tcdc"), "reference": str(tmp / "r.tcdc")}, port, ref


def test_nttd_store_append_stats(nttd_stores):
    _, port, ref = nttd_stores
    assert [(s["version"], s["keyframe"], s["rekeyed"], s["bytes"]) for s in port] == \
        [(s["version"], s["keyframe"], s["rekeyed"], s["bytes"]) for s in ref]
    assert all(np.isfinite(s["fitness"]) for s in port)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_nttd_store_reads_in_both_packages(nttd_stores, writer):
    path = nttd_stores[0][writer]
    idx = _probe(NTTD_SHAPE, 150, seed=4)
    with VersionedReader(path, device="cpu") as reader, JStore.open(path) as ref:
        for v in range(reader.n_versions):
            want = ref.decode_at(idx, v)
            np.testing.assert_allclose(reader.decode_at(idx, v), want, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(reader.decode(v), ref.decode(v), rtol=RTOL, atol=ATOL)
            assert reader.component(v).ct.device.type == "cpu"


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("tile_entries", [None, 64])
def test_nttd_store_serves_in_both_packages(nttd_stores, writer, tile_entries):
    path = nttd_stores[0][writer]
    idx = _probe(NTTD_SHAPE, 150, seed=5)
    svc, jsvc = CodecService(device="cpu"), JService()
    with VersionedReader(path, device="cpu") as reader:
        for s in (svc, jsvc):
            s.load_stream("t", path, tile_entries=tile_entries)
        for v in (0, 1, 2, None):
            got = svc.decode_at("t", idx, version=v)
            np.testing.assert_array_equal(got, reader.decode_at(idx, v))
            np.testing.assert_allclose(got, jsvc.decode_at("t", idx, version=v),
                                       rtol=RTOL, atol=ATOL)
    assert svc.cache_stats.as_dict() == jsvc.cache_stats.as_dict()
