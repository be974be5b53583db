"""CP decomposition baseline (CP-ALS) — paper competitor.  Pure numpy, a
copy of ``repro.core.cpd``."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CPDecomposition:
    weights: np.ndarray          # [R]
    factors: list[np.ndarray]    # mode k: [N_k, R]

    @property
    def n_params(self) -> int:
        return int(self.weights.size + sum(f.size for f in self.factors))

    def payload_bytes(self, bytes_per_param: int = 8) -> int:
        return self.n_params * bytes_per_param

    def to_dense(self) -> np.ndarray:
        d = len(self.factors)
        subs = [f"{chr(ord('a') + k)}r" for k in range(d)]
        eq = ",".join(["r"] + subs) + "->" + "".join(chr(ord("a") + k) for k in range(d))
        return np.einsum(eq, self.weights, *self.factors, optimize=True)

    def fitness(self, x: np.ndarray) -> float:
        err = np.linalg.norm((x - self.to_dense()).astype(np.float64))
        return 1.0 - err / max(np.linalg.norm(x.astype(np.float64)), 1e-30)


def _khatri_rao(mats: list[np.ndarray]) -> np.ndarray:
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


def _unfold(x: np.ndarray, mode: int) -> np.ndarray:
    return np.moveaxis(x, mode, 0).reshape(x.shape[mode], -1)


def cp_als(
    x: np.ndarray, rank: int, iters: int = 50, seed: int = 0, tol: float = 1e-7
) -> CPDecomposition:
    rng = np.random.default_rng(seed)
    d = x.ndim
    x64 = x.astype(np.float64)
    factors = [rng.standard_normal((n, rank)) for n in x.shape]
    weights = np.ones(rank)
    norm_x = np.linalg.norm(x64)
    prev_err = np.inf
    for _ in range(iters):
        for mode in range(d):
            others = [factors[k] for k in range(d) if k != mode]
            # gram of khatri-rao product = hadamard of grams
            g = np.ones((rank, rank))
            for f in others:
                g *= f.T @ f
            # row-major unfolding (last axis fastest) -> KR in original order
            kr = _khatri_rao(others)
            mttkrp = _unfold(x64, mode) @ kr
            sol = np.linalg.lstsq(g, mttkrp.T, rcond=None)[0].T
            weights = np.linalg.norm(sol, axis=0)
            weights[weights == 0] = 1.0
            factors[mode] = sol / weights
        # convergence check on relative error
        dec = CPDecomposition(weights, factors)
        err = np.linalg.norm(x64 - dec.to_dense()) / max(norm_x, 1e-30)
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return CPDecomposition(weights, factors)


def cp_rank_for_budget(shape: tuple[int, ...], budget_params: int) -> int:
    per_rank = sum(shape) + 1
    return max(budget_params // per_rank, 1)
