"""Payloads across the two packages, on the CPU.

The port must decode the checked-in payloads as the JAX package does
(the four golden files at rtol 1e-5 / atol 1e-6, as ``tests/test_golden.py``; the
chunked stream payload and a JAX-fitted NTTD at 1e-5), write bytes
identical to the JAX package's for the same params, and read what the JAX
package writes (and the reverse).
"""
import io
import os
import struct
import zlib

import jax
import numpy as np
import pytest

import repro.codecs as jcodecs
from repro.codecs import container as jcontainer
from repro.core import serialization as jser
from repro_torch import codecs as tcodecs
from repro_torch import convert
from repro_torch.codecs import container as tcontainer
from repro_torch.codecs.adapters import NTTDEncoded
from repro_torch.core import serialization as tser

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "tests", "golden")
FIG5 = os.path.join(ROOT, "benchmarks", "results", "fig5_stream_payload.tcdc")
NPZ = np.load(os.path.join(GOLDEN, "expected.npz"))


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def fitted():
    """A small NTTD fitted by the JAX package."""
    x = np.random.default_rng(0).random((6, 5, 4)).astype(np.float32)
    return x, jcodecs.get_codec("nttd").fit(x, rank=4, hidden=8, epochs=2)


def _port_from_reference(enc, device="cpu"):
    ct = enc.ct
    return NTTDEncoded(convert.compressed_from_numpy(
        jax.tree.map(np.asarray, ct.params), ct.pi, ct.spec.shape, ct.spec.factors,
        ct.norm_mean, ct.norm_std, device=device,
    ))


def test_golden_v2_nttd():
    enc = tcodecs.load_bytes(_read(os.path.join(GOLDEN, "v2_nttd.bin")), device="cpu")
    np.testing.assert_allclose(
        np.asarray(enc.decode_at(NPZ["indices"]), np.float64), NPZ["v2_nttd"],
        rtol=1e-5, atol=1e-6,
    )


def test_chunked_stream_payload_matches_reference():
    data = _read(FIG5)
    port = tcodecs.load_bytes(data, device="cpu")
    ref = jcodecs.load_bytes(data)
    assert port.shape == ref.shape == (64, 32, 32)
    assert (port.ct.cfg.rank, port.ct.cfg.hidden) == (6, 12)
    np.testing.assert_allclose(port.to_dense(), ref.to_dense(), rtol=1e-5, atol=1e-5)
    idx = NPZ["indices"] % np.array(port.shape)
    np.testing.assert_allclose(port.decode_at(idx), ref.decode_at(idx), rtol=1e-5, atol=1e-5)


def test_jax_fitted_payload_decodes_equal(fitted):
    x, ref = fitted
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, n, 100) for n in x.shape], axis=1)
    want_at, want_dense, want_fit = ref.decode_at(idx), ref.to_dense(), ref.fitness(x)
    for port in (_port_from_reference(ref), tcodecs.load_bytes(ref.save(), device="cpu")):
        np.testing.assert_allclose(port.decode_at(idx), want_at, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port.to_dense(), want_dense, rtol=1e-5, atol=1e-5)
        assert port.payload_bytes() == ref.payload_bytes()
        assert abs(port.fitness(x) - want_fit) < 1e-5


def test_save_bytes_identical_to_reference(fitted):
    _, ref = fitted
    port = _port_from_reference(ref)
    assert port.to_bytes() == ref.to_bytes()                       # v2 body
    assert tcodecs.save_bytes(port) == jcontainer.save_bytes(ref)  # v3 container
    for dtype in (np.float16, np.float64):
        assert tser.save_bytes(port.ct, dtype) == jser.save_bytes(ref.ct, dtype)


def test_each_package_loads_the_others_bytes(fitted):
    _, ref = fitted
    port = _port_from_reference(ref)
    idx = NPZ["indices"] % np.array(port.shape)
    want = ref.decode_at(idx)
    for blob in (port.to_bytes(), tcodecs.save_bytes(port)):
        back = jcodecs.load_bytes(blob)  # the JAX package reads the port's bytes
        assert back.to_bytes() == ref.to_bytes()  # same params, orders and norms
    np.testing.assert_allclose(back.decode_at(idx), want, rtol=1e-5, atol=1e-5)
    for blob in (ref.to_bytes(), ref.save()):
        back = tcodecs.load_bytes(blob, device="cpu")
        np.testing.assert_allclose(back.decode_at(idx), want, rtol=1e-5, atol=1e-5)
        assert tcodecs.save_bytes(back) == ref.save()


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_serialization_files_cross_both_ways(fitted, tmp_path, dtype):
    """``core.serialization.save_file``/``load_file``: a v2 body either
    package writes to a file, the other reads, byte for byte."""
    _, ref = fitted
    port = _port_from_reference(ref)
    tpath, jpath = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    n = tser.save_file(tpath, port.ct, dtype)
    assert n == jser.save_file(jpath, ref.ct, dtype) == os.path.getsize(tpath)
    assert _read(tpath) == _read(jpath)
    back = jser.load_file(tpath)  # the JAX package reads the port's file
    assert jser.save_bytes(back, dtype) == _read(jpath)
    got = tser.load_file(jpath, device="cpu")  # and the port reads the reference's
    assert got.params["lstm"]["wi"].device.type == "cpu"
    assert tser.save_bytes(got, dtype) == _read(jpath)


def test_fp16_and_fp64_bodies_load(fitted):
    _, ref = fitted
    idx = NPZ["indices"] % np.array(ref.shape)
    for dtype in (np.float16, np.float64):
        blob = jser.save_bytes(ref.ct, dtype)
        want = jser.load_bytes(blob).decode(idx)
        got = tser.load_bytes(blob, device="cpu").decode(idx)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_v4_delta_container_not_supported():
    """Now supported (the name is kept): the golden v4 file decodes as the
    chain of its latest version to ``v4_version2``, and as the reference's
    ``load_bytes`` does."""
    data = _read(os.path.join(GOLDEN, "v4_delta.tcdc"))
    enc = tcodecs.load_bytes(data, device="cpu")
    ref = jcodecs.load_bytes(data)
    assert type(enc).__name__ == "ChainEncoded" and len(enc.components) == len(ref.components)
    got = np.asarray(enc.decode_at(NPZ["indices"]), np.float64)
    np.testing.assert_allclose(got, NPZ["v4_version2"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, ref.decode_at(NPZ["indices"]))


def test_patched_container_not_supported(fitted):
    """Now supported (the name is kept): a v3 file whose TCDP overlay
    replaces every entry decodes to the overlay, the reference's answers."""
    _, ref = fitted
    body = ref.to_bytes()
    n = int(np.prod(ref.shape))
    head = jcontainer.pack_header("nttd", flags=jcontainer.FLAG_CHUNKED)
    chunks = [
        jcontainer.ChunkEntry(len(head), len(body), zlib.crc32(body) & 0xFFFFFFFF),
        jcontainer.ChunkEntry(len(head) + len(body), len(body),
                              zlib.crc32(body) & 0xFFFFFFFF),
    ]
    patch = jcontainer.PatchEntry(0, n, 1, 2, "nttd")
    data = head + body + body + jcontainer.pack_footer(chunks, patches=[patch])
    assert tcontainer.pack_footer(
        [tcontainer.ChunkEntry(c.offset, c.length, c.crc) for c in chunks],
        patches=[tcontainer.PatchEntry(0, n, 1, 2, "nttd")]) == data[len(head) + 2 * len(body):]
    want = jcodecs.load_bytes(data)  # the reference reads it
    got = tcodecs.load_bytes(data, device="cpu")
    assert type(got).__name__ == "PatchedEncoded" and got.codec_name == "nttd"
    assert got.shape == want.shape and got.payload_bytes() == want.payload_bytes()
    idx = NPZ["indices"] % np.array(ref.shape)
    np.testing.assert_allclose(got.decode_at(idx), want.decode_at(idx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.to_dense(), want.to_dense(), rtol=1e-5, atol=1e-5)


def test_other_codecs_not_registered():
    """Now registered (the name is kept): ``available()`` is the
    reference's, and the TT payloads of ``v3_mono.tcdc`` and
    ``v3_chunked.tcdc`` decode to ``v3``."""
    assert tcodecs.available() == jcodecs.available()
    for name in ("v3_mono.tcdc", "v3_chunked.tcdc"):
        enc = tcodecs.load_bytes(_read(os.path.join(GOLDEN, name)), device="cpu")
        assert enc.codec_name == "ttd"
        np.testing.assert_allclose(np.asarray(enc.decode_at(NPZ["indices"]), np.float64),
                                   NPZ["v3"], rtol=1e-5, atol=1e-6)
    assert tcodecs.get_codec("nttd").stream_fitter((2, 2, 2), device="cpu").slabs_seen == 0


def test_corrupt_containers_raise(fitted):
    _, ref = fitted
    mono = bytearray(ref.save())
    mono[-1] ^= 0xFF
    with pytest.raises(ValueError, match="body checksum"):
        tcodecs.load_bytes(bytes(mono), device="cpu")
    chunked = bytearray(_read(FIG5))
    (_, name_len) = struct.unpack("<BB", chunked[6:8])
    chunked[8 + name_len + 40] ^= 0xFF  # a byte inside the first chunk
    with pytest.raises(ValueError, match="chunk checksum"):
        tcodecs.load_bytes(bytes(chunked), device="cpu")
    with pytest.raises(ValueError, match="not a TensorCodec"):
        tcodecs.load_bytes(b"XXXX" + bytes(mono[4:]), device="cpu")


def test_array_framing_matches_reference():
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=(3, 4)), rng.normal(size=(5,)).astype(np.float32),
              rng.integers(0, 9, size=(2, 2, 2)).astype(np.int64), np.arange(6, dtype=np.uint8),
              np.float64(2.5), rng.normal(size=(2, 3)).astype(np.float16)]
    for arr in arrays:
        port, ref = io.BytesIO(), io.BytesIO()
        tcontainer.write_array(port, arr)
        jcontainer.write_array(ref, arr)
        assert port.getvalue() == ref.getvalue()
        back = tcontainer.read_array(io.BytesIO(port.getvalue()))
        assert back.dtype == np.asarray(arr).dtype
        np.testing.assert_array_equal(back, arr)
    with pytest.raises(ValueError, match="truncated"):
        tcontainer.read_array(io.BytesIO(port.getvalue()[:-1]))


def test_decode_impl_from_environment(monkeypatch, fitted):
    _, ref = fitted
    monkeypatch.delenv("REPRO_DECODE_IMPL", raising=False)
    assert tcodecs.load_bytes(ref.save(), device="cpu").ct.cfg.kernel_impl == "auto"
    monkeypatch.setenv("REPRO_DECODE_IMPL", "cuda")
    enc = tcodecs.load_bytes(ref.save(), device="cpu")
    assert enc.ct.cfg.kernel_impl == "cuda"
    idx = NPZ["indices"] % np.array(ref.shape)
    np.testing.assert_allclose(enc.decode_at(idx), ref.decode_at(idx), rtol=1e-5, atol=1e-5)
