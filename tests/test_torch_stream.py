"""Out-of-core streaming (``repro_torch.stream``) against the JAX package's
``repro.stream``, on the CPU.

The slab sources are host NumPy in both packages: their slabs must be the
same arrays.  The writer must write files byte-identical to the
reference's for the same payload and the same calls, in both modes, and
each package loads the other's files.  The NTTD stream fitter runs on
``device="cpu"`` through the plain route (``kernel_impl="ref"``), from the
reference fitter's params carried across with
``repro_torch.convert.params_from_numpy``: the host state (reservoir,
normalization, orders) must be exactly the reference's, and the params
within rtol 1e-4 / atol 1e-6 after three slabs (the gradients' sums run
in another order).  Resume is byte-identical.
"""
import os

import jax
import numpy as np
import pytest
import torch

import repro.codecs as jcodecs
import repro.stream as jstream
from repro.codecs import container as jcontainer
from repro_torch import codecs as tcodecs
from repro_torch import convert
from repro_torch import stream as tstream
from repro_torch.codecs import container as tcontainer
from repro_torch.core import nttd as tnttd

SHAPE = (16, 12, 10)
FIT = dict(rank=3, hidden=6, steps_per_slab=2, batch_size=256, seed=0)
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


def _sources(pkg, slab_entries=300, seed=3):
    return pkg.SyntheticTensorSource(SHAPE, slab_entries=slab_entries, seed=seed)


def _materialize(src) -> np.ndarray:
    x = np.zeros(src.shape, np.float32)
    for slab in src.iter_slabs():
        x[tuple(slab.indices[:, k] for k in range(len(src.shape)))] = slab.values
    return x


def _indices(shape=SHAPE, n=60, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, size=n) for s in shape], axis=1)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix, tree


def _assert_params_close(port_params, ref_params):
    want = dict(_leaves(jax.tree.map(np.asarray, ref_params)))
    got = dict(_leaves(port_params))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].detach().cpu().numpy(), want[key],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)


def _fitter_pair(shape=SHAPE, **opts):
    """(reference fitter, port fitter on the CPU's plain route) from the
    same params: the reference's draws carried across."""
    ref = jstream.NTTDStreamFitter(shape, **opts)
    port = tstream.NTTDStreamFitter(shape, **opts, kernel_impl="ref", device="cpu")
    port.params = convert.params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")
    port._opt_state = port._opt.init(port.params)
    return ref, port


# ---------------------------------------------------------------------------
# slab sources
# ---------------------------------------------------------------------------
def _source_pair(kind, tmp_path):
    x = _materialize(_sources(jstream))
    if kind == "synthetic":
        return _sources(jstream), _sources(tstream)
    if kind == "dense":
        return (jstream.DenseSource(x, slab_entries=300),
                tstream.DenseSource(x, slab_entries=300))
    jpath, tpath = str(tmp_path / "ref.bin"), str(tmp_path / "port.bin")
    jstream.write_tensor_file(jpath, x)
    tstream.write_tensor_file(tpath, x)
    assert _read(jpath) == _read(tpath)
    return (jstream.MMapTensorSource(jpath, SHAPE, np.float32, slab_entries=300),
            tstream.MMapTensorSource(tpath, SHAPE, np.float32, slab_entries=300))


@pytest.mark.parametrize("kind", ["dense", "mmap", "synthetic"])
def test_sources_slabs_match_reference(tmp_path, kind):
    ref, port = _source_pair(kind, tmp_path)
    assert (port.shape, port.n_slabs, port.n_entries, port.slab_nbytes) == (
        ref.shape, ref.n_slabs, ref.n_entries, ref.slab_nbytes)
    for got, want in zip(port.iter_slabs(), ref.iter_slabs()):
        assert got.cursor == want.cursor
        assert got.indices.dtype == want.indices.dtype and got.values.dtype == want.values.dtype
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.values, want.values)
    # a resumed cursor sees exactly the tail an uninterrupted run sees
    assert [s.cursor for s in port.iter_slabs(start=3)] == list(range(3, ref.n_slabs))
    np.testing.assert_array_equal(port.slab_at(4).values, ref.slab_at(4).values)
    with pytest.raises(IndexError, match="cursor"):
        port.slab_at(port.n_slabs)
    if kind == "synthetic":
        idx = _indices(n=500, seed=9)
        np.testing.assert_array_equal(port.values_at(idx), ref.values_at(idx))
        assert isinstance(port, tstream.SlabSource)


def test_mmap_source_rejects_short_file(tmp_path):
    path = str(tmp_path / "short.bin")
    np.zeros(10, np.float32).tofile(path)
    with pytest.raises(ValueError, match="entries on disk"):
        tstream.MMapTensorSource(path, SHAPE, np.float32)
    with pytest.raises(ValueError, match="slab_entries"):
        tstream.SyntheticTensorSource(SHAPE, slab_entries=0)


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tt_payloads():
    """(reference, port) TT payloads of the synthetic tensor: the same body."""
    x = _materialize(_sources(jstream))
    ref = jcodecs.get_codec("ttd").fit(x, max_rank=4)
    port = tcodecs.get_codec("ttd").fit(x, max_rank=4)
    assert port.to_bytes() == ref.to_bytes()
    return x, ref, port


def test_write_chunked_identical_to_reference(tmp_path, tt_payloads):
    x, ref, port = tt_payloads
    heldout = tstream.sample_heldout(x, n=40, seed=2)
    want_heldout = jstream.sample_heldout(x, n=40, seed=2)
    for got, want in zip(heldout, want_heldout):
        np.testing.assert_array_equal(got, want)
    jpath, tpath = str(tmp_path / "ref.tcdc"), str(tmp_path / "port.tcdc")
    n = jstream.write_chunked(jpath, ref, chunk_bytes=512, heldout=want_heldout)
    assert tstream.write_chunked(tpath, port, chunk_bytes=512, heldout=heldout) == n
    assert _read(tpath) == _read(jpath)
    assert os.path.getsize(tpath) == n
    # each package reads the other's file, eagerly and through the index
    idx = _indices()
    got = tcontainer.load_file(jpath, device="cpu")
    np.testing.assert_array_equal(got.decode_at(idx), ref.decode_at(idx))
    assert jcontainer.load_file(tpath).to_bytes() == ref.to_bytes()
    oc, joc = tcontainer.open_container(tpath), jcontainer.open_container(jpath)
    try:
        assert (oc.codec, oc.flags, oc.chunks, oc.versions, oc.patches) == (
            joc.codec, joc.flags, [tcontainer.ChunkEntry(*_fields(c)) for c in joc.chunks],
            None, [])
        np.testing.assert_array_equal(oc.heldout.indices, heldout[0])
        np.testing.assert_array_equal(oc.heldout.values, heldout[1])
        assert b"".join(tcontainer.read_chunk(oc.view, c) for c in oc.chunks) == ref.to_bytes()
    finally:
        oc.close()
        joc.close()
    name, chunks = tcontainer.chunk_index(tpath)
    assert name == "ttd" and len(chunks) > 1
    assert chunks[0].entry_start == 0 and chunks[-1].entry_stop == x.size
    with pytest.raises(ValueError, match="out of range"):
        tstream.write_chunked(tpath, port, heldout=(np.array([x.size]), np.zeros(1)))


def _fields(chunk):
    return (chunk.offset, chunk.length, chunk.crc, chunk.entry_start, chunk.entry_stop)


def _delta_file(pkg, path, bodies, heldout):
    """Three versions (keyframe, a delta on it, a delta on that), a sync
    after each, the held-out sample recorded between versions; returns the
    file's bytes after each sync and after close."""
    snapshots = []
    w = pkg.ChunkedWriter(path, "ttd", delta=True)
    for v, body in enumerate(bodies):
        assert w.begin_version(v - 1) == v
        for at in range(0, len(body), 700):
            w.append(body[at:at + 700], entry_range=(0, int(np.prod(SHAPE))))
        if v == 1:
            assert w.record_heldout(*heldout) == len(heldout[0])
        w.sync()
        snapshots.append(_read(path))
    assert (w.chunks_written, w.versions_written) == (
        sum(-(-len(b) // 700) for b in bodies), len(bodies))
    n = w.close()
    snapshots.append(_read(path))
    assert n == len(snapshots[-1])
    return snapshots


def test_delta_writer_identical_to_reference(tmp_path, tt_payloads):
    """Delta mode (v4): begin_version, append, sync and record_heldout give
    the reference's bytes at every sync and at close; the file reads back
    in both packages as the chain of its latest version."""
    x, ref, port = tt_payloads
    small = [jcodecs.get_codec("ttd").fit(x * s, max_rank=2).to_bytes() for s in (0.05, 0.02)]
    bodies = [ref.to_bytes()] + small
    heldout = jstream.sample_heldout(x, n=16, seed=1)
    want = _delta_file(jstream, str(tmp_path / "ref.tcdc"), bodies, heldout)
    got = _delta_file(tstream, str(tmp_path / "port.tcdc"), bodies, heldout)
    assert got == want
    idx = _indices()
    chain = tcontainer.load_bytes(got[-1], device="cpu")
    jchain = jcontainer.load_bytes(got[-1])
    assert type(chain).__name__ == "ChainEncoded" and len(chain.components) == 3
    np.testing.assert_array_equal(chain.decode_at(idx), jchain.decode_at(idx))
    codec, chunks, versions = tcontainer.container_index(str(tmp_path / "port.tcdc"))
    assert codec == "ttd" and [v.base for v in versions] == [-1, 0, 1]
    assert versions[-1].chunk_stop == len(chunks)
    with pytest.raises(ValueError, match="open_container"):
        tcontainer.open_chunks(str(tmp_path / "port.tcdc"))
    with pytest.raises(ValueError, match="container_index"):
        tcontainer.chunk_index(str(tmp_path / "port.tcdc"))


def test_writer_version_discipline(tmp_path):
    w = tstream.ChunkedWriter(str(tmp_path / "v.tcdc"), "ttd", delta=True)
    with pytest.raises(ValueError, match="outside begin_version"):
        w.append(b"x")
    with pytest.raises(ValueError, match="keyframe"):
        w.begin_version(0)
    w.begin_version(-1)
    with pytest.raises(ValueError, match="has no chunks"):
        w.begin_version(0)
    plain = tstream.ChunkedWriter(str(tmp_path / "p.tcdc"), "ttd")
    with pytest.raises(ValueError, match="delta=True"):
        plain.begin_version()
    with pytest.raises(ValueError, match="empty chunk"):
        plain.append(b"")
    plain.append(b"x")
    plain.close()
    with pytest.raises(ValueError, match="closed"):
        plain.append(b"y")


def test_rewrite_and_patch_identical_to_reference(tmp_path, tt_payloads):
    """``rewrite_chunks`` (same length in place, another length relocated)
    and ``append_patch`` (a read-repair overlay) leave the reference's
    bytes; the patched file decodes as the reference's does, in both
    packages."""
    x, ref, _ = tt_payloads
    overlay = jcodecs.get_codec("ttd").fit(np.full((10, 30), 1.5, np.float32),
                                           max_rank=1).to_bytes()
    files = []
    for pkg in (jstream, tstream):
        path = str(tmp_path / f"{pkg.__name__}.tcdc")
        pkg.write_chunked(path, ref, chunk_bytes=512)
        pkg.rewrite_chunks(path, {1: b"\x00" * 512, 2: b"\x01" * 100})
        body = ref.to_bytes()
        pkg.rewrite_chunks(path, {1: body[512:1024], 2: body[1024:1536]})
        assert pkg.append_patch(path, overlay, (300, 600), "ttd", chunk_bytes=200) == 0
        files.append(_read(path))
    assert files[1] == files[0]
    idx = np.concatenate([_indices(n=30), np.array([[2, 6, 5], [3, 0, 0], [4, 11, 9]])])
    got = tcontainer.load_bytes(files[1], device="cpu")
    want = jcontainer.load_bytes(files[0])
    assert type(got).__name__ == "PatchedEncoded" and got.codec_name == "ttd"
    np.testing.assert_array_equal(got.decode_at(idx), want.decode_at(idx))
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    assert got.payload_bytes() == want.payload_bytes()
    flat = np.ravel_multi_index(tuple(idx.T), SHAPE)
    inside = (flat >= 300) & (flat < 600)
    assert inside.any() and (~inside).any()
    np.testing.assert_allclose(got.decode_at(idx)[inside], 1.5, rtol=1e-6)
    np.testing.assert_array_equal(got.decode_at(idx)[~inside], ref.decode_at(idx)[~inside])
    # the base chunks keep the routing index; the overlay is a suffix
    path = str(tmp_path / f"{tstream.__name__}.tcdc")
    _, base = tcontainer.chunk_index(path)
    oc = tcontainer.open_container(path)
    try:
        assert oc.base_chunks == base and len(oc.chunks) > len(base) and oc.n_base == len(base)
    finally:
        oc.close()
    with pytest.raises(NotImplementedError):
        got.to_bytes()
    with pytest.raises(ValueError, match="exceeds"):
        tstream.append_patch(path, overlay, (0, x.size + 1), "ttd")


# ---------------------------------------------------------------------------
# the NTTD stream fitter
# ---------------------------------------------------------------------------
def test_nttd_stream_fitter_matches_reference_from_carried_params():
    """Three slabs (the first without replay, then half replay): host state
    exactly the reference's, params at rtol 1e-4 / atol 1e-6, and the
    payload's decode too."""
    src = _sources(jstream)
    ref, port = _fitter_pair(**FIT, replay_capacity=500)
    for cursor in range(3):
        slab = src.slab_at(cursor)
        ref.update(slab.indices, slab.values)
        port.update(slab.indices, slab.values)
    assert (port._mean, port._std) == (ref._mean, ref._std)
    assert (port._rfill, port.entries_seen, port.slabs_seen) == (
        ref._rfill, ref.entries_seen, ref.slabs_seen) == (500, 900, 3)
    np.testing.assert_array_equal(port._rpos, ref._rpos)
    np.testing.assert_array_equal(port._rval, ref._rval)
    _assert_params_close(port.params, ref.params)
    enc, jenc = port.finalize(), ref.finalize()
    assert enc.ct.device.type == "cpu" and enc.ct.cfg.kernel_impl == "ref"
    idx = _indices()
    np.testing.assert_allclose(enc.decode_at(idx), jenc.decode_at(idx), rtol=1e-4, atol=1e-5)
    assert enc.payload_bytes() == jenc.payload_bytes()
    assert port.loss is not None and port.loss.shape == ()
    assert set(port.seconds) == {"sampling", "training", "reservoir"}


def test_refine_orders_matches_reference():
    """Orders from the reservoir's estimate and from a given tensor are the
    reference's; the reservoir is remapped alike, Adam restarts and the
    params are kept; training continues in position space alike."""
    src = _sources(jstream)
    x = _materialize(src)
    ref, port = _fitter_pair(**FIT)
    for cursor in range(2):
        slab = src.slab_at(cursor)
        ref.update(slab.indices, slab.values)
        port.update(slab.indices, slab.values)
    before = {k: v.clone() for k, v in dict(_leaves(port.params)).items()}
    for arg in (None, x):
        got, want = port.refine_orders(arg), ref.refine_orders(arg)
        assert [list(p) for p in got] == [list(p) for p in want]
        np.testing.assert_array_equal(port._rpos, ref._rpos)
    for key, leaf in _leaves(port.params):
        assert torch.equal(leaf, before[key])
    assert int(port._opt_state.step) == 0
    slab = src.slab_at(2)
    ref.update(slab.indices, slab.values)
    port.update(slab.indices, slab.values)
    np.testing.assert_array_equal(port._rpos, ref._rpos)
    _assert_params_close(port.params, ref.params)
    assert [list(p) for p in port.finalize().pi] == [list(p) for p in ref.finalize().pi]
    empty = tstream.NTTDStreamFitter(SHAPE, **FIT, device="cpu")
    with pytest.raises(ValueError, match="empty reservoir"):
        empty.refine_orders()
    with pytest.raises(ValueError, match="shape"):
        port.refine_orders(x[:, :, :5])


@pytest.mark.parametrize("budget", [3000, 20000])
def test_budget_translation_matches_reference(budget):
    port = tcodecs.get_codec("nttd").stream_fitter(SHAPE, budget=budget, device="cpu")
    ref = jcodecs.get_codec("nttd").stream_fitter(SHAPE, budget=budget)
    assert (port.cfg.rank, port.cfg.hidden) == (ref.cfg.rank, ref.cfg.hidden)
    assert port.cfg.rank == tcodecs.get_codec("nttd")._rank_for_budget(SHAPE, budget, {})
    assert port.cfg.kernel_impl == "auto" and port.device.type == "cpu"


def test_nttd_resume_from_cursor_bit_identical():
    src = _sources(tstream)
    codec = tcodecs.get_codec("nttd")
    full = codec.fit_stream(src, **FIT, device="cpu")
    fitter = codec.stream_fitter(src.shape, **FIT, device="cpu")
    mid = codec.fit_stream(src, stop=3, fitter=fitter)
    resumed = codec.fit_stream(src, start=3, fitter=fitter)
    assert tcodecs.save_bytes(resumed) == tcodecs.save_bytes(full)
    assert tcodecs.save_bytes(mid) != tcodecs.save_bytes(full)
    # a payload taken mid-stream is a copy: training on did not change it
    assert tcodecs.save_bytes(mid) == tcodecs.save_bytes(
        codec.fit_stream(src, stop=3, **FIT, device="cpu"))


def test_auto_route_on_the_cpu_is_the_plain_route():
    """On CPU tensors the kernels' wrappers run the plain versions, so the
    default route ("auto") fits the bytes "ref" fits."""
    src = _sources(tstream)
    auto = tstream.fit_stream("nttd", src, **FIT, device="cpu", stop=3)
    plain = tstream.fit_stream("nttd", src, **FIT, device="cpu", stop=3, kernel_impl="ref")
    assert auto.ct.cfg.kernel_impl == "auto"
    assert auto.to_bytes() == plain.to_bytes()


def test_port_stream_payload_loads_in_reference():
    src = _sources(tstream)
    enc = tstream.fit_stream("nttd", src, **FIT, device="cpu", passes=2)
    back = jcodecs.load_bytes(enc.save())
    idx = _indices()
    np.testing.assert_allclose(back.decode_at(idx), enc.decode_at(idx), rtol=1e-5, atol=1e-6)
    assert back.to_bytes() == enc.to_bytes()


def test_fit_stream_resume_rejects_new_opts():
    codec = tcodecs.get_codec("nttd")
    fitter = codec.stream_fitter(SHAPE, rank=3, hidden=6, device="cpu")
    with pytest.raises(ValueError, match="resume"):
        codec.fit_stream(_sources(tstream), 4000, fitter=fitter)
    with pytest.raises(ValueError, match="resume"):
        codec.fit_stream(_sources(tstream), fitter=fitter, lr=1.0)
    with pytest.raises(ValueError, match="slab must be"):
        fitter.update(np.zeros((4, 2), np.int64), np.zeros(4, np.float32))


@pytest.mark.parametrize("width,match", [
    (dict(hidden=300), "lstm_scan backward: hidden 300 outside 1..256"),
    (dict(rank=129), "tt_contract backward: rank 129 outside 1..128"),
])
def test_stream_fitter_refuses_widths_beyond_the_backward_kernels(monkeypatch, width, match):
    """On a CUDA device through the kernels' route, a stream fit wider than
    the backward kernels take is refused before the params are made, with
    the kernels' own messages (``device="cuda"`` is taken unchecked, so no
    card is needed); the CPU route takes the same widths."""
    def reached(*args, **kwargs):
        raise AssertionError("the fitter allocated before refusing the widths")

    opts = {**FIT, **width}
    with monkeypatch.context() as patch:
        patch.setattr(tnttd, "init_params", reached)
        with pytest.raises(ValueError, match=match):
            tstream.NTTDStreamFitter(SHAPE, **opts, device="cuda")
        with pytest.raises(ValueError, match=match):
            tcodecs.get_codec("nttd").stream_fitter(SHAPE, **opts, device="cuda")
    fitter = tstream.NTTDStreamFitter(SHAPE, **{**opts, "batch_size": 16}, device="cpu")
    slab = _sources(tstream).slab_at(0)
    fitter.update(slab.indices, slab.values)
    assert fitter.slabs_seen == 1


# ---------------------------------------------------------------------------
# TT-ICE and the accumulate fallback
# ---------------------------------------------------------------------------
def test_ttice_to_bytes_identical_to_reference():
    src = _sources(jstream, slab_entries=250)  # not a multiple of the 120-entry rows
    want = jstream.fit_stream("ttd", src, max_rank=6)
    got = tstream.fit_stream("ttd", _sources(tstream, slab_entries=250), max_rank=6)
    assert got.to_bytes() == want.to_bytes()
    assert max(got.tt.ranks) <= 6
    # extra passes are no-ops; a budget picks the reference's rank cap
    again = tstream.fit_stream("ttd", _sources(tstream, slab_entries=250), max_rank=6, passes=3)
    assert again.to_bytes() == got.to_bytes()
    assert tcodecs.get_codec("ttd").stream_fitter(SHAPE, 3000).max_rank == \
        jcodecs.get_codec("ttd").stream_fitter(SHAPE, 3000).max_rank
    fitter = tcodecs.get_codec("ttd").stream_fitter(SHAPE, max_rank=4)
    slab = src.slab_at(1)
    with pytest.raises(ValueError, match="contiguous"):
        fitter.update(slab.indices, slab.values)
    with pytest.raises(ValueError, match="budget or max_rank"):
        tcodecs.get_codec("ttd").stream_fitter(SHAPE)


def test_tucker_accumulate_fallback_equals_one_shot_fit():
    src = _sources(tstream)
    x = _materialize(src)
    enc_stream = tstream.fit_stream("tucker", src, 4000)
    enc_fit = tcodecs.get_codec("tucker").fit(x, 4000)
    assert tcodecs.save_bytes(enc_stream) == tcodecs.save_bytes(enc_fit)
    assert enc_stream.to_bytes() == jstream.fit_stream("tucker", _sources(jstream), 4000).to_bytes()
