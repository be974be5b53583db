"""Tensor-Ring decomposition baseline (TR-SVD, Zhao et al.) — paper competitor,
a copy of ``repro.core.tensor_ring``.

Approximates X(i_1..i_d) = Trace( G_1(i_1) G_2(i_2) ... G_d(i_d) ) with
cores G_k in R^{r_{k-1} x N_k x r_k}, r_0 = r_d = r (ring closure).
TR-SVD: first SVD splits its rank between r_0 and r_1; the rest follows
TT-SVD.  Pure numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TRDecomposition:
    cores: list[np.ndarray]  # [r_{k-1}, N_k, r_k], ring-closed

    @property
    def n_params(self) -> int:
        return sum(c.size for c in self.cores)

    def payload_bytes(self, bytes_per_param: int = 8) -> int:
        return self.n_params * bytes_per_param

    def to_dense(self) -> np.ndarray:
        out = self.cores[0]  # [r0, N1, r1]
        for core in self.cores[1:]:
            out = np.tensordot(out, core, axes=([out.ndim - 1], [0]))
        # out: [r0, N1, ..., Nd, r0] -> trace over (first, last)
        return np.trace(out, axis1=0, axis2=out.ndim - 1)

    def fitness(self, x: np.ndarray) -> float:
        err = np.linalg.norm((x - self.to_dense()).astype(np.float64))
        return 1.0 - err / max(np.linalg.norm(x.astype(np.float64)), 1e-30)


def tr_svd(x: np.ndarray, max_rank: int) -> TRDecomposition:
    shape = x.shape
    d = x.ndim
    x64 = x.astype(np.float64)
    # first unfolding: split rank between r0 and r1
    c = x64.reshape(shape[0], -1)
    u, s, vt = np.linalg.svd(c, full_matrices=False)
    r01 = min(len(s), max_rank * max_rank)
    r0 = min(max_rank, int(np.ceil(np.sqrt(r01))))
    r1 = min(max_rank, (r01 + r0 - 1) // r0)
    r01 = r0 * r1
    u, s, vt = u[:, :r01], s[:r01], vt[:r01]
    g1 = u.reshape(shape[0], r0, r1)  # split the rank index
    cores = [np.moveaxis(g1, 0, 1)]   # [r0, N1, r1]
    c = (s[:, None] * vt).reshape(r0, r1, -1)
    c = np.moveaxis(c, 0, -1).reshape(r1, -1, 1) if False else c
    # remaining cores via TT-SVD on [r1, N2...Nd, r0]
    c = np.moveaxis(c, 0, -1)  # [r1, rest..., -> (r1, prod rest, r0)] handled below
    c = c.reshape(r1, -1, r0)
    r_prev = r1
    for k in range(1, d - 1):
        mat = c.reshape(r_prev * shape[k], -1)
        u, s, vt = np.linalg.svd(mat, full_matrices=False)
        r = min(len(s), max_rank)
        cores.append(u[:, :r].reshape(r_prev, shape[k], r))
        c = (s[:r, None] * vt[:r]).reshape(r, -1, r0)
        r_prev = r
    cores.append(c.reshape(r_prev, shape[-1], r0))
    return TRDecomposition(cores)


def tr_rank_for_budget(shape: tuple[int, ...], budget_params: int) -> int:
    r = 1
    while True:
        nxt = r + 1
        n = sum(nxt * n_k * nxt for n_k in shape)
        if n > budget_params:
            return max(r, 1)
        r = nxt
