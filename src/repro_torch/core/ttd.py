"""Tensor-Train Decomposition baseline (Oseledets 2011) — paper competitor,
a copy of ``repro.core.ttd``.

TT-SVD with either a prescribed-accuracy eps (the classical formulation)
or fixed max rank R (the paper's size-matched comparisons).  Pure numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TTDecomposition:
    cores: list[np.ndarray]  # core k: [r_{k-1}, N_k, r_k]

    @property
    def ranks(self) -> list[int]:
        return [c.shape[0] for c in self.cores] + [self.cores[-1].shape[2]]

    @property
    def n_params(self) -> int:
        return sum(c.size for c in self.cores)

    def payload_bytes(self, bytes_per_param: int = 8) -> int:
        return self.n_params * bytes_per_param

    def to_dense(self) -> np.ndarray:
        out = self.cores[0]  # [1, N_1, r_1]
        for core in self.cores[1:]:
            out = np.tensordot(out, core, axes=([out.ndim - 1], [0]))
        return out.squeeze(axis=(0, out.ndim - 1))

    def fitness(self, x: np.ndarray) -> float:
        err = np.linalg.norm((x - self.to_dense()).astype(np.float64))
        return 1.0 - err / max(np.linalg.norm(x.astype(np.float64)), 1e-30)


def tt_svd(
    x: np.ndarray, max_rank: int | None = None, eps: float | None = None
) -> TTDecomposition:
    """TT-SVD.  If eps is given, ranks are chosen so the total error is
    <= eps * ||x||_F (delta = eps * ||x|| / sqrt(d-1) per truncation)."""
    shape = x.shape
    d = x.ndim
    delta = None
    if eps is not None:
        delta = eps * np.linalg.norm(x.astype(np.float64)) / max(np.sqrt(d - 1), 1)
    cores = []
    c = x.astype(np.float64).reshape(shape[0], -1)
    r_prev = 1
    for k in range(d - 1):
        c = c.reshape(r_prev * shape[k], -1)
        u, s, vt = np.linalg.svd(c, full_matrices=False)
        r = len(s)
        if delta is not None:
            # truncate so the tail energy is <= delta^2
            tail = np.cumsum((s**2)[::-1])[::-1]
            keep = np.nonzero(tail > delta**2)[0]
            r = int(keep[-1]) + 1 if keep.size else 1
        if max_rank is not None:
            r = min(r, max_rank)
        r = max(r, 1)
        cores.append(u[:, :r].reshape(r_prev, shape[k], r))
        c = (s[:r, None] * vt[:r])
        r_prev = r
    cores.append(c.reshape(r_prev, shape[-1], 1))
    return TTDecomposition(cores)


def tt_rank_for_budget(shape: tuple[int, ...], budget_params: int) -> int:
    """Largest uniform TT rank whose parameter count fits the budget."""
    r = 1
    while True:
        nxt = r + 1
        n = _tt_params(shape, nxt)
        if n > budget_params:
            return r
        r = nxt


def _tt_params(shape: tuple[int, ...], r: int) -> int:
    d = len(shape)
    total = shape[0] * r + shape[-1] * r
    for k in range(1, d - 1):
        total += r * shape[k] * r
    return total
