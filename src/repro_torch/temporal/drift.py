"""Synthetic drifting tensor sequences for temporal benchmarks/tests, as in
``repro.temporal.drift``: host NumPy, bitwise the reference's arrays.

A versioned store only wins when consecutive versions are CLOSE, so the
fig10 benchmark needs a sequence with (a) shared smooth structure every
version keeps, (b) a small smooth per-version drift a tiny residual fit
can capture, and (c) a fixed unstructured noise floor that caps the
reachable fitness EQUALLY for delta chains and independent fits — making
the bytes-per-version comparison at matched fitness honest.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.codecs.indexing import flat_to_multi
from repro_torch.stream.source import SyntheticTensorSource


def drifting_versions(
    shape: tuple[int, ...],
    n_versions: int,
    *,
    drift: float = 0.04,
    noise: float = 0.03,
    seed: int = 0,
) -> list[np.ndarray]:
    """Deterministic sequence of ``n_versions`` float32 tensors.

    Version 0 is a seeded separable-harmonic tensor plus a FIXED noise
    field; version v adds ``v`` accumulated rank-1 drift steps (smooth
    per-mode sine vectors, amplitude ``drift`` each) on top.  Consecutive
    versions differ by one smooth rank-1 step, so a low-rank residual fit
    captures the change at a fraction of a full fit's bytes.
    """
    shape = tuple(int(s) for s in shape)
    if n_versions < 1:
        raise ValueError(f"n_versions must be >= 1, got {n_versions}")
    n_entries = int(np.prod(shape))
    src = SyntheticTensorSource(shape, seed=seed)
    idx = flat_to_multi(np.arange(n_entries, dtype=np.int64), shape)
    base = np.asarray(src.values_at(idx), np.float64).reshape(shape)
    rng = np.random.default_rng(seed * 7919 + 13)
    base = base + noise * rng.standard_normal(shape)

    versions = []
    x = base
    for v in range(n_versions):
        versions.append(np.asarray(x, np.float32))
        # one smooth rank-1 drift step: outer product of per-mode sines
        vecs = [
            np.sin(
                2 * np.pi * rng.integers(1, 3) * np.arange(n) / n
                + rng.uniform(0.0, 2 * np.pi)
            )
            for n in shape
        ]
        x = x + drift * functools.reduce(np.multiply.outer, vecs)
    return versions
