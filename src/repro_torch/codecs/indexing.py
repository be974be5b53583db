"""Flat <-> multi index helpers (numpy only), as in ``repro.codecs.indexing``."""
from __future__ import annotations

import numpy as np


def flat_to_multi(flat: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Row-major flat index [N] -> multi-index [N, d] (numpy)."""
    dims = np.array(shape, dtype=np.int64)
    radix = np.concatenate([np.cumprod(dims[::-1])[::-1][1:], [1]])
    return (flat[:, None] // radix) % dims


def multi_to_flat(indices: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Row-major multi-index [N, d] -> flat index [N] (numpy int64).

    Inverse of :func:`flat_to_multi`.
    """
    idx = np.asarray(indices)
    return np.ravel_multi_index(
        tuple(idx[:, k] for k in range(idx.shape[1])), shape
    ).astype(np.int64)
