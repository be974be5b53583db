"""Payloads across the two packages, on the CPU.

The port must decode the checked-in payloads as the JAX package does
(golden v2 at rtol 1e-5 / atol 1e-6, as ``tests/test_golden.py``; the
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


def test_fp16_and_fp64_bodies_load(fitted):
    _, ref = fitted
    idx = NPZ["indices"] % np.array(ref.shape)
    for dtype in (np.float16, np.float64):
        blob = jser.save_bytes(ref.ct, dtype)
        want = jser.load_bytes(blob).decode(idx)
        got = tser.load_bytes(blob, device="cpu").decode(idx)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_v4_delta_container_not_supported():
    with pytest.raises(NotImplementedError, match="v4 delta"):
        tcodecs.load_bytes(_read(os.path.join(GOLDEN, "v4_delta.tcdc")), device="cpu")


def test_patched_container_not_supported(fitted):
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
    jcodecs.load_bytes(data)  # the reference reads it
    with pytest.raises(NotImplementedError, match="TCDP"):
        tcodecs.load_bytes(data, device="cpu")


def test_other_codecs_not_registered():
    assert tcodecs.available() == ["nttd"]
    with pytest.raises(ValueError, match="unknown codec id 'ttd'"):
        tcodecs.load_bytes(_read(os.path.join(GOLDEN, "v3_mono.tcdc")), device="cpu")
    with pytest.raises(NotImplementedError):
        tcodecs.get_codec("nttd").stream_fitter((2, 2, 2))


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
