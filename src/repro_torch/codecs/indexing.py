"""Flat <-> multi index helpers and query validation (numpy only), as in
``repro.codecs.indexing``."""
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


def validate_indices(
    name: str, shape: tuple[int, ...], indices: np.ndarray
) -> np.ndarray:
    """Reject a malformed query batch before it reaches any decode path.

    ``CodecService`` accepts exactly the requests the reference's does:
    [B, d] integral indices inside ``shape``.  Returns the validated array."""
    idx = np.asarray(indices)
    if idx.ndim != 2 or idx.shape[1] != len(shape):
        raise ValueError(
            f"indices for {name!r} must be [B, {len(shape)}], got {idx.shape}"
        )
    if not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"indices must be integral, got {idx.dtype}")
    if idx.size and ((idx < 0).any() or (idx >= np.asarray(shape)).any()):
        raise ValueError(f"indices out of range for shape {shape}")
    return idx
