"""TT-tensor folding (paper Eq. 4), as in ``repro.core.folding``.

Folds a d-order tensor of shape (N_1, ..., N_d) into a d'-order tensor whose
l-th mode has length prod_k n_{k,l}, where the factor matrix ``n[k, l]``
satisfies ``prod_l n[k, l] >= N_k``.  Original mode-k indices are decomposed
into big-endian mixed-radix digits ``i_{k,l}``; folded mode-l indices are the
big-endian mixed-radix composition of the l-th digit of every original mode.

``fold_indices`` / ``unfold_indices`` take numpy arrays or torch tensors;
for a tensor the index maps are moved to its device once and cached.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

MAX_FACTOR = 5  # paper: "modify some of them using integers at most 5"


def choose_factors(dim: int, d_prime: int) -> list[int]:
    """Pick d' factors in [1, MAX_FACTOR] with product >= dim, close to dim.

    Start from all-2, bump factors (<=5) while the product is short of
    ``dim``, then shrink 2 -> 1 from the right while the product stays
    >= dim.
    """
    if dim <= 0:
        raise ValueError(f"mode length must be positive, got {dim}")
    if MAX_FACTOR**d_prime < dim:
        raise ValueError(f"d'={d_prime} too small for mode length {dim}")
    factors = [2] * d_prime
    prod = 2**d_prime
    # Grow: bump the smallest factor (leftmost among ties) until prod >= dim.
    while prod < dim:
        j = min(range(d_prime), key=lambda t: (factors[t], t))
        if factors[j] >= MAX_FACTOR:
            raise AssertionError("unreachable: growth exhausted")
        prod = prod // factors[j] * (factors[j] + 1)
        factors[j] += 1
    # Shrink: drop 2 -> 1 from the right while we can stay >= dim.
    for j in reversed(range(d_prime)):
        if factors[j] == 2 and prod // 2 >= dim:
            factors[j] = 1
            prod //= 2
    assert prod >= dim
    return factors


def default_d_prime(shape: Sequence[int]) -> int:
    """Paper: d' > d and d' = O(log N_max)."""
    n_max = max(shape)
    return max(len(shape) + 1, math.ceil(math.log2(max(n_max, 2))))


@dataclasses.dataclass(frozen=True)
class FoldingSpec:
    """Precomputed index maps between the original and folded tensors."""

    shape: tuple[int, ...]            # original (N_1..N_d)
    factors: np.ndarray               # [d, d'] int64, n_{k,l}
    # strides[k, l] = prod_{l' > l} n[k, l']   (digit extraction, original)
    strides: np.ndarray               # [d, d'] int64
    # fstrides[k, l] = prod_{k' > k} n[k', l]  (digit composition, folded)
    fstrides: np.ndarray              # [d, d'] int64
    folded_shape: tuple[int, ...]     # (m_1..m_d'), m_l = prod_k n[k, l]
    # device -> (factors, strides, fstrides) as int64 tensors
    _maps: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @property
    def d(self) -> int:
        return len(self.shape)

    @property
    def d_prime(self) -> int:
        return len(self.folded_shape)

    @property
    def n_entries(self) -> int:
        return int(np.prod(self.shape))

    @property
    def padded_entries(self) -> int:
        return int(np.prod(self.folded_shape))

    def _index_maps(self, like):
        """(factors, strides, fstrides) in the array kind of ``like``."""
        if not isinstance(like, torch.Tensor):
            return self.factors, self.strides, self.fstrides
        maps = self._maps.get(like.device)
        if maps is None:
            maps = tuple(
                torch.as_tensor(a, dtype=torch.int64, device=like.device)
                for a in (self.factors, self.strides, self.fstrides)
            )
            self._maps[like.device] = maps
        return maps

    def fold_indices(self, idx):
        """[..., d] original indices -> [..., d'] folded indices."""
        factors, strides, fstrides = self._index_maps(idx)
        digits = (idx[..., :, None] // strides) % factors
        return (digits * fstrides).sum(-2)

    def unfold_indices(self, fidx):
        """[..., d'] folded indices -> [..., d] original indices.

        Inverse of ``fold_indices`` on the image of valid indices; for padded
        folded positions the result may exceed ``shape`` (callers mask).
        """
        factors, strides, fstrides = self._index_maps(fidx)
        digits = (fidx[..., None, :] // fstrides) % factors
        return (digits * strides).sum(-1)


def make_folding_spec(shape: Sequence[int], d_prime: int | None = None) -> FoldingSpec:
    shape = tuple(int(s) for s in shape)
    if d_prime is None:
        d_prime = default_d_prime(shape)
    factors = np.array([choose_factors(n, d_prime) for n in shape], dtype=np.int64)
    return spec_from_factors(shape, factors)


def spec_from_factors(shape: Sequence[int], factors: np.ndarray) -> FoldingSpec:
    """A spec from an explicit [d, d'] factor matrix (as stored in payloads)."""
    factors = np.asarray(factors, dtype=np.int64)
    d, d_prime = factors.shape
    strides = np.ones((d, d_prime), dtype=np.int64)
    for j in range(d_prime - 2, -1, -1):
        strides[:, j] = strides[:, j + 1] * factors[:, j + 1]
    fstrides = np.ones((d, d_prime), dtype=np.int64)
    for k in range(d - 2, -1, -1):
        fstrides[k, :] = fstrides[k + 1, :] * factors[k + 1, :]
    return FoldingSpec(
        shape=tuple(int(s) for s in shape),
        factors=factors,
        strides=strides,
        fstrides=fstrides,
        folded_shape=tuple(int(x) for x in factors.prod(axis=0)),
    )
