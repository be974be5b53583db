"""On-disk serialization of the compressed payload D = (theta, pi): the
v2 NTTD body, byte-compatible with ``repro.core.serialization``.

Layout (little-endian):
  magic 'TCDC' | u16 version | u8 d | u8 d' | u8 dtype | u8 flags
  u32 rank | u32 hidden | f64 mean | f64 std
  d  x u64   original shape
  d*d' x u8  folding factors
  theta: arrays in sorted-key traversal order, raw bytes at `dtype`
  pi:    per mode, N_k indices bit-packed at ceil(log2 N_k) bits each

Theta is walked in STRING-sorted key order at every level: ``embed_12``
before ``embed_4``, then ``head_first``, ``head_last``, ``head_mid``,
``lstm/{b,wh,wi}``.  A different order loads a payload scrambled with no
error.  The v3 container (``repro_torch.codecs.container``) wraps this
body.
"""
from __future__ import annotations

import io
import struct

import numpy as np
import torch

from repro_torch.core import codec as codec_mod
from repro_torch.core import nttd
from repro_torch.core.folding import FoldingSpec, make_folding_spec, spec_from_factors
from repro_torch.devices import resolve_device

MAGIC = b"TCDC"
VERSION = 2
_HEADER = "<HBBBBII dd"
_DTYPES = {0: np.float16, 1: np.float32, 2: np.float64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------
def pack_permutation(perm: np.ndarray) -> bytes:
    """Pack N integers in [0, N) at ceil(log2 N) bits each."""
    n = perm.shape[0]
    if n <= 1:
        return b""
    bits = max(int(np.ceil(np.log2(n))), 1)
    total = n * bits
    buf = np.zeros((total + 7) // 8, dtype=np.uint8)
    bitpos = np.arange(n, dtype=np.int64) * bits
    for b in range(bits):
        p = bitpos + b
        bit = (perm >> (bits - 1 - b)) & 1
        np.bitwise_or.at(buf, p // 8, (bit << (7 - (p % 8))).astype(np.uint8))
    return buf.tobytes()


def unpack_permutation(data: bytes, n: int) -> np.ndarray:
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    bits = max(int(np.ceil(np.log2(n))), 1)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(n, dtype=np.int64)
    bitpos = np.arange(n, dtype=np.int64) * bits
    for b in range(bits):
        p = bitpos + b
        bit = (buf[p // 8] >> (7 - (p % 8))) & 1
        out |= bit.astype(np.int64) << (bits - 1 - b)
    return out


# ---------------------------------------------------------------------------
# theta traversal (stable order)
# ---------------------------------------------------------------------------
def _theta_items(params: nttd.Params):
    def walk(prefix: str, node):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(f"{prefix}/{k}", node[k])
        else:
            yield prefix, node

    yield from walk("", params)


def save_bytes(ct: codec_mod.CompressedTensor, dtype=np.float32) -> bytes:
    spec = ct.spec
    out = io.BytesIO()
    code = _DTYPE_CODES[np.dtype(dtype)]
    out.write(MAGIC)
    out.write(
        struct.pack(
            _HEADER,
            VERSION,
            spec.d,
            spec.d_prime,
            code,
            0,
            ct.cfg.rank,
            ct.cfg.hidden,
            ct.norm_mean,
            ct.norm_std,
        )
    )
    out.write(np.asarray(spec.shape, dtype=np.uint64).tobytes())
    out.write(spec.factors.astype(np.uint8).tobytes())
    for _, arr in _theta_items(ct.params):
        out.write(np.asarray(arr.detach().cpu().numpy(), dtype=dtype).tobytes())
    for k in range(spec.d):
        out.write(pack_permutation(ct.pi[k]))
    return out.getvalue()


def load_bytes(
    data: bytes,
    kernel_impl: str | None = None,
    device: str | torch.device | None = None,
) -> codec_mod.CompressedTensor:
    """Rebuild a CompressedTensor from its v2 body, with params on ``device``
    (CUDA unless given).

    ``kernel_impl`` picks the decode backend of the rebuilt payload (the
    wire format carries no impl); the default is ``REPRO_DECODE_IMPL`` or
    "auto".
    """
    device = resolve_device(device)
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise ValueError("not a TensorCodec payload")
    version, d, d_prime, code, _flags, rank, hidden, mean, std = struct.unpack(
        _HEADER, buf.read(struct.calcsize(_HEADER))
    )
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    shape = tuple(np.frombuffer(buf.read(8 * d), dtype=np.uint64).astype(int))
    factors = np.frombuffer(buf.read(d * d_prime), dtype=np.uint8).reshape(d, d_prime)
    spec = make_folding_spec(shape, d_prime)
    if not np.array_equal(spec.factors, factors.astype(np.int64)):
        # factor chooser changed between versions: rebuild spec from factors
        spec = _spec_from_factors(shape, factors.astype(np.int64))
    cfg = nttd.NTTDConfig(
        rank=rank, hidden=hidden, kernel_impl=kernel_impl or nttd.default_impl()
    )
    # the shape tree comes straight from the spec and config
    params = _fill(nttd.param_shapes(spec, cfg), buf, _DTYPES[code], cfg.dtype, device)
    pi = []
    for k in range(d):
        n = shape[k]
        bits = max(int(np.ceil(np.log2(n))), 1) if n > 1 else 0
        nbytes = (n * bits + 7) // 8
        pi.append(unpack_permutation(buf.read(nbytes), n))
    return codec_mod.CompressedTensor(params, pi, spec, cfg, mean, std)


def _fill(shapes, buf: io.BytesIO, dtype, param_dtype: torch.dtype, device):
    if isinstance(shapes, dict):
        return {
            k: _fill(shapes[k], buf, dtype, param_dtype, device) for k in sorted(shapes)
        }
    n = int(np.prod(shapes))
    nbytes = n * np.dtype(dtype).itemsize
    raw = buf.read(nbytes)
    if len(raw) < nbytes:
        raise ValueError("truncated payload: theta")
    arr = np.frombuffer(raw, dtype=dtype).reshape(shapes).astype(np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=param_dtype)


def _spec_from_factors(shape, factors: np.ndarray) -> FoldingSpec:
    return spec_from_factors(shape, factors)


def save_file(path: str, ct: codec_mod.CompressedTensor, dtype=np.float32) -> int:
    """Write ``ct``'s v2 body to ``path``; returns its byte count."""
    data = save_bytes(ct, dtype)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_file(path: str, device: str | torch.device | None = None) -> codec_mod.CompressedTensor:
    """Read a v2 body from ``path``, its params on ``device`` (CUDA unless
    given)."""
    with open(path, "rb") as f:
        return load_bytes(f.read(), device=device)
