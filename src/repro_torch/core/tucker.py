"""Tucker decomposition baseline (HOSVD init + HOOI) — paper competitor, a
copy of ``repro.core.tucker`` (pure numpy)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TuckerDecomposition:
    core: np.ndarray              # [r_1..r_d]
    factors: list[np.ndarray]     # mode k: [N_k, r_k]

    @property
    def n_params(self) -> int:
        return int(self.core.size + sum(f.size for f in self.factors))

    def payload_bytes(self, bytes_per_param: int = 8) -> int:
        return self.n_params * bytes_per_param

    def to_dense(self) -> np.ndarray:
        out = self.core
        for k, f in enumerate(self.factors):
            out = np.tensordot(out, f, axes=([0], [1]))
        # tensordot cycles axes; after d products the order is restored
        return out

    def fitness(self, x: np.ndarray) -> float:
        err = np.linalg.norm((x - self.to_dense()).astype(np.float64))
        return 1.0 - err / max(np.linalg.norm(x.astype(np.float64)), 1e-30)


def _unfold(x: np.ndarray, mode: int) -> np.ndarray:
    return np.moveaxis(x, mode, 0).reshape(x.shape[mode], -1)


def _leading_svd(m: np.ndarray, r: int) -> np.ndarray:
    if m.shape[0] <= m.shape[1]:
        u, _, _ = np.linalg.svd(m, full_matrices=False)
    else:
        # tall matrix: eig of the small gram
        g = m.T @ m
        w, v = np.linalg.eigh(g)
        v = v[:, ::-1]
        u = m @ v
        u /= np.maximum(np.linalg.norm(u, axis=0, keepdims=True), 1e-30)
    return u[:, :r]


def tucker_hooi(
    x: np.ndarray, ranks: list[int] | tuple[int, ...], iters: int = 10
) -> TuckerDecomposition:
    x64 = x.astype(np.float64)
    d = x.ndim
    ranks = [min(r, x.shape[k]) for k, r in enumerate(ranks)]
    # HOSVD init
    factors = [_leading_svd(_unfold(x64, k), ranks[k]) for k in range(d)]
    for _ in range(iters):
        for mode in range(d):
            # project on all modes except `mode`
            y = x64
            for k in range(d):
                if k == mode:
                    continue
                y = np.moveaxis(
                    np.tensordot(y, factors[k], axes=([k], [0])), -1, k
                )
            factors[mode] = _leading_svd(_unfold(y, mode), ranks[mode])
    core = x64
    for k in range(d):
        core = np.moveaxis(np.tensordot(core, factors[k], axes=([k], [0])), -1, k)
    return TuckerDecomposition(core, factors)


def tucker_ranks_for_budget(shape: tuple[int, ...], budget_params: int) -> list[int]:
    """Uniform-fraction ranks that meet the parameter budget."""
    lo, hi = 1e-4, 1.0
    best = [1] * len(shape)
    for _ in range(40):
        mid = (lo + hi) / 2
        ranks = [max(int(n * mid), 1) for n in shape]
        n = int(np.prod(ranks)) + sum(n * r for n, r in zip(shape, ranks))
        if n <= budget_params:
            best = ranks
            lo = mid
        else:
            hi = mid
    return best
