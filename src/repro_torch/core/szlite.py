"""SZ-like error-bounded lossy compressor ("SZ-lite") — smooth-data
comparison point (paper competitor SZ3, simplified).

Pipeline: uniform scalar quantization of every value at a prescribed
absolute error bound -> delta encoding of the *integer* codes along the
flattened (row-major) order -> DEFLATE entropy coding (zlib = LZ77 +
Huffman; SZ3 uses Huffman + a lossless backend, same family).

The integer deltas make the scheme drift-free (cumsum of int32 diffs is
exact) while still exploiting smoothness: smooth data yields near-zero
deltas that entropy-code to a fraction of a bit each.

This is deliberately a *simplified* stand-in: it preserves the defining
property (error-bounded, smoothness-exploiting, entropy-coded) without
reproducing SZ3's full interpolation stack.  A copy of
``repro.core.szlite``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SZCompressed:
    data: bytes
    shape: tuple[int, ...]
    error_bound: float

    def payload_bytes(self) -> int:
        # data + error bound + shape header
        return len(self.data) + 8 + 8 * len(self.shape)


def compress(x: np.ndarray, error_bound: float) -> SZCompressed:
    import zlib

    flat = x.astype(np.float64).reshape(-1)
    step = 2.0 * max(error_bound, 1e-300)
    q = np.round(flat / step).astype(np.int64)
    if np.abs(q).max(initial=0) >= 2**31 - 1:
        raise ValueError("error bound too small for value range (int32 overflow)")
    dq = np.diff(q, prepend=np.int64(0)).astype(np.int32)
    data = zlib.compress(dq.tobytes(), 6)
    return SZCompressed(data, x.shape, error_bound)


def decompress(c: SZCompressed) -> np.ndarray:
    import zlib

    dq = np.frombuffer(zlib.decompress(c.data), dtype=np.int32).astype(np.int64)
    q = np.cumsum(dq)
    step = 2.0 * max(c.error_bound, 1e-300)
    return (q.astype(np.float64) * step).reshape(c.shape)


def fitness(x: np.ndarray, recon: np.ndarray) -> float:
    err = np.linalg.norm((x - recon).astype(np.float64).reshape(-1))
    return 1.0 - err / max(np.linalg.norm(x.astype(np.float64).reshape(-1)), 1e-30)
