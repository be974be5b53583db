"""Delta chains (``repro_torch.temporal``) against the JAX package's
``repro.temporal``, on the CPU.

``resolve_chain``, ``load_chain`` and ``ChainEncoded`` must match the
reference's on the golden v4 file and on version lists built here.
``DeltaFitter`` on NTTD runs the port's stream fitter on the CPU's plain
route from the reference fitter's params, carried across with
``repro_torch.convert.params_from_numpy``: params within rtol 1e-4 / atol
1e-6 after each residual, as ``tests/test_torch_stream.py`` holds them; on
TT (host NumPy in both packages) the payloads are byte-identical.
"""
import os

import jax
import numpy as np
import pytest

import repro.codecs as jcodecs
from repro.codecs import container as jcontainer
from repro.temporal import delta as jdelta
from repro_torch import codecs as tcodecs
from repro_torch import convert
from repro_torch import temporal as ttemporal
from repro_torch.codecs import container as tcontainer
from repro_torch.temporal import delta as tdelta

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NPZ = np.load(os.path.join(GOLDEN, "expected.npz"))
SHAPE = (8, 6, 5)
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


def _golden_v4():
    """(codec name, per-version bodies, version index) of the golden v4
    file, parsed by the reference's container."""
    with open(os.path.join(GOLDEN, "v4_delta.tcdc"), "rb") as f:
        data = f.read()
    flags, name, off = jcontainer._parse_header(data)
    chunks, versions, _ = jcontainer._check_delta(data, flags, off)
    bodies = [b"".join(jcontainer.read_chunk(data, c) for c in chunks[v.chunk_start:v.chunk_stop])
              for v in versions]
    return name, bodies, versions


def _port_versions(versions):
    return [tcontainer.VersionEntry(v.base, v.chunk_start, v.chunk_stop) for v in versions]


@pytest.mark.parametrize("bases", [[-1], [-1, 0, 1], [-1, 0, 0, -1, 3], [-1, -1, 1, 2, 0]])
def test_resolve_chain_matches_reference(bases):
    jversions = [jcontainer.VersionEntry(b, i, i + 1) for i, b in enumerate(bases)]
    versions = _port_versions(jversions)
    for v in range(len(bases)):
        assert tdelta.resolve_chain(versions, v) == jdelta.resolve_chain(jversions, v)
    for bad in (-1, len(bases)):
        with pytest.raises(ValueError, match="out of range"):
            tdelta.resolve_chain(versions, bad)


def test_load_chain_matches_reference_at_every_golden_version():
    name, bodies, jversions = _golden_v4()
    versions = _port_versions(jversions)
    idx = NPZ["indices"]
    for v in range(len(versions)):
        chain = tdelta.load_chain(tcodecs.get_codec(name), bodies, versions, v, device="cpu")
        want = jdelta.load_chain(jcodecs.get_codec(name), bodies, jversions, v)
        assert len(chain.components) == len(want.components) == len(
            tdelta.resolve_chain(versions, v))
        assert chain.shape == want.shape and chain.payload_bytes() == want.payload_bytes()
        got = chain.decode_at(idx)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want.decode_at(idx))
        np.testing.assert_allclose(got, NPZ[f"v4_version{v}"], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(chain.to_dense(), want.to_dense())
    latest = tdelta.load_chain(tcodecs.get_codec(name), bodies, versions, device="cpu")
    assert len(latest.components) == len(tdelta.resolve_chain(versions, len(versions) - 1))
    with pytest.raises(ValueError, match="bodies for"):
        tdelta.load_chain(tcodecs.get_codec(name), bodies[:-1], versions, device="cpu")


def test_chain_encoded_sums_in_f64_keyframe_first():
    """The one summation convention: float64 on the host, keyframe first,
    whatever each component returns; the byte hooks refuse; components of
    another shape are rejected."""
    x = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    parts = [tcodecs.get_codec("ttd").fit(x * s, max_rank=2) for s in (1.0, 1e-7, 3e-8)]
    chain = ttemporal.ChainEncoded(parts)
    idx = np.stack(np.unravel_index(np.arange(x.size), SHAPE), axis=1)
    want = np.zeros(x.size)
    for p in parts:
        want += np.asarray(p.decode_at(idx), np.float64)
    np.testing.assert_array_equal(chain.decode_at(idx), want)
    ref = jdelta.ChainEncoded([jcodecs.load_bytes(p.save()) for p in parts])
    np.testing.assert_array_equal(chain.decode_at(idx), ref.decode_at(idx))
    assert chain.codec_name == ref.codec_name == "chain"
    with pytest.raises(ValueError, match="to_bytes"):
        chain.to_bytes()
    with pytest.raises(ValueError, match="v4 containers"):
        ttemporal.ChainEncoded.from_bytes(b"", device="cpu")
    with pytest.raises(ValueError, match="disagree on shape"):
        ttemporal.ChainEncoded([parts[0], tcodecs.get_codec("ttd").fit(x[:4], max_rank=2)])
    with pytest.raises(ValueError, match="empty chain"):
        ttemporal.ChainEncoded([])


def _residuals(n=2):
    rng = np.random.default_rng(4)
    return [(0.1 * rng.standard_normal(SHAPE)).astype(np.float32) for _ in range(n)]


def test_delta_fitter_nttd_matches_reference_from_carried_params():
    """One persistent stream fitter resumed for every residual (warm start),
    normalization off by default; params and decodes match the
    reference's after each residual."""
    opts = dict(rank=2, hidden=4, batch_size=128, steps_per_slab=3, seed=0)
    ref = jdelta.DeltaFitter(SHAPE, "nttd", slab_entries=100, passes=2, opts=opts)
    port = tdelta.DeltaFitter(SHAPE, "nttd", slab_entries=100, passes=2,
                              opts={**opts, "kernel_impl": "ref"}, device="cpu")
    port._fitter.params = convert.params_from_numpy(
        jax.tree.map(np.asarray, ref._fitter.params), "cpu")
    port._fitter._opt_state = port._fitter._opt.init(port._fitter.params)
    inner = port._fitter
    assert inner.normalize is False and inner.device.type == "cpu"
    idx = np.stack(np.unravel_index(np.arange(0, int(np.prod(SHAPE)), 7), SHAPE), axis=1)
    for r in _residuals():
        got, want = port.fit_residual(r), ref.fit_residual(r)
        assert port._fitter is inner
        np.testing.assert_array_equal(port._fitter._rpos, ref._fitter._rpos)
        for (key, leaf), (_, jleaf) in zip(_leaves(port._fitter.params),
                                          _leaves(jax.tree.map(np.asarray, ref._fitter.params))):
            np.testing.assert_allclose(leaf.numpy(), jleaf, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=key)
        assert (got.ct.norm_mean, got.ct.norm_std) == (0.0, 1.0)
        np.testing.assert_allclose(got.decode_at(idx), want.decode_at(idx), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="residual shape"):
        port.fit_residual(np.zeros((2, 2, 2), np.float32))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix, tree


def test_delta_fitter_tt_bytes_match_reference():
    ref = jdelta.DeltaFitter(SHAPE, "ttd", opts={"max_rank": 2})
    port = tdelta.DeltaFitter(SHAPE, "ttd", opts={"max_rank": 2})
    assert port._fitter is None
    for r in _residuals():
        assert port.fit_residual(r).to_bytes() == ref.fit_residual(r).to_bytes()
    budget = tdelta.DeltaFitter(SHAPE, "ttd", opts={"budget": 800})
    assert budget.fit_residual(_residuals(1)[0]).to_bytes() == jdelta.DeltaFitter(
        SHAPE, "ttd", opts={"budget": 800}).fit_residual(_residuals(1)[0]).to_bytes()


def test_delta_file_of_port_fits_reads_in_both_packages(tmp_path):
    """A keyframe and two deltas fitted by the port, written by the delta
    writer: both packages read the latest version as the f64 sum of the
    three components."""
    from repro_torch.stream import ChunkedWriter

    rng = np.random.default_rng(2)
    x = rng.normal(size=SHAPE).astype(np.float32)
    key = tcodecs.get_codec("nttd").fit(x, rank=2, hidden=4, epochs=2, batch_size=64,
                                        device="cpu")
    fitter = tdelta.DeltaFitter(SHAPE, "nttd", slab_entries=100, passes=1,
                                opts=dict(rank=2, hidden=4, batch_size=64), device="cpu")
    parts = [key] + [fitter.fit_residual(r) for r in _residuals()]
    path = str(tmp_path / "delta.tcdc")
    with ChunkedWriter(path, "nttd", delta=True) as w:
        for v, enc in enumerate(parts):
            w.begin_version(v - 1)
            w.append(enc.to_bytes())
            w.sync()
    idx = np.stack(np.unravel_index(np.arange(int(np.prod(SHAPE))), SHAPE), axis=1)
    want = sum(np.asarray(p.decode_at(idx), np.float64) for p in parts)
    got = tcodecs.load_file(path, device="cpu")
    assert isinstance(got, ttemporal.ChainEncoded) and len(got.components) == 3
    assert all(c.ct.device.type == "cpu" for c in got.components)
    np.testing.assert_allclose(got.decode_at(idx), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(jcodecs.load_file(path).decode_at(idx), want,
                               rtol=1e-5, atol=1e-6)
