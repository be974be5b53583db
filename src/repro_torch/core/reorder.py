"""Mode-index reordering (paper §IV-D).

* ``tsp_init``: per-mode 2-approximation of metric TSP over slices
  (pairwise Frobenius distances -> Prim MST -> preorder walk = cycle,
  drop heaviest cycle edge -> path).  Minimizes Eq. (6).
* ``update_orders``: Alg. 3 — LSH-style random-projection bucketing over a
  sampled half of the indices, XOR-paired disjoint candidate pairs, swap
  accepted iff the (sampled) true-loss delta is negative.

Conventions: ``pi[k][pos] = original index``, i.e. X_pi(pos) = X(pi(pos)),
matching the paper's definition.  As in ``repro.core.reorder``: NumPy
throughout, except that each mode's loss deltas are batched through one
prediction call over all its pairs (the port's ``nttd.make_predict``
unless given: on the card the fused decode kernel), and the NumPy
``Generator`` is consumed in the reference's order, so that both packages
draw the same pairs and samples from the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import nttd
from repro_torch.core.folding import FoldingSpec


# ---------------------------------------------------------------------------
# Eq. (6) objective and TSP-based initialization
# ---------------------------------------------------------------------------
def _slice_matrix(x: np.ndarray, mode: int) -> np.ndarray:
    """[N_k, prod other dims] matrix of vectorized mode-k slices."""
    return np.moveaxis(x, mode, 0).reshape(x.shape[mode], -1)


def order_objective(x: np.ndarray, mode: int, perm: np.ndarray) -> float:
    """Eq. (6): sum of Frobenius distances between consecutive slices."""
    m = _slice_matrix(x, mode)[perm]
    return float(np.sqrt(((m[1:] - m[:-1]) ** 2).sum(axis=1)).sum())


def _pairwise_dist(m: np.ndarray, chunk: int = 1024) -> np.ndarray:
    """Pairwise Euclidean distances via the Gram trick (f64 accumulate)."""
    m = m.astype(np.float64)
    sq = (m * m).sum(axis=1)
    n = m.shape[0]
    d2 = np.empty((n, n), dtype=np.float64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2[s:e] = sq[s:e, None] + sq[None, :] - 2.0 * (m[s:e] @ m.T)
    np.clip(d2, 0.0, None, out=d2)
    return np.sqrt(d2)


def _prim_mst(dist: np.ndarray) -> np.ndarray:
    """Prim's MST, O(N^2).  Returns parent[i] (parent[0] == -1)."""
    n = dist.shape[0]
    in_tree = np.zeros(n, dtype=bool)
    best = np.full(n, np.inf)
    parent = np.full(n, -1, dtype=np.int64)
    best[0] = 0.0
    for _ in range(n):
        u = int(np.argmin(np.where(in_tree, np.inf, best)))
        in_tree[u] = True
        upd = (~in_tree) & (dist[u] < best)
        best[upd] = dist[u][upd]
        parent[upd] = u
    return parent


def _preorder(parent: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Preorder DFS of the MST (children visited nearest-first)."""
    n = parent.shape[0]
    children: list[list[int]] = [[] for _ in range(n)]
    for v in range(1, n):
        children[parent[v]].append(v)
    for u in range(n):
        children[u].sort(key=lambda v: dist[u, v])
    order, stack = [], [0]
    while stack:
        u = stack.pop()
        order.append(u)
        stack.extend(reversed(children[u]))
    return np.array(order, dtype=np.int64)


def tsp_order_mode(x: np.ndarray, mode: int) -> np.ndarray:
    """2-approx metric-TSP order for mode-k slices -> permutation array."""
    m = _slice_matrix(x, mode)
    n = m.shape[0]
    if n <= 2:
        return np.arange(n, dtype=np.int64)
    dist = _pairwise_dist(m)
    tour = _preorder(_prim_mst(dist), dist)
    # tour is a Hamiltonian cycle (implicit wrap) — drop heaviest edge
    edge_w = dist[tour, np.roll(tour, -1)]
    cut = int(np.argmax(edge_w))
    return np.roll(tour, -(cut + 1))


def tsp_init(x: np.ndarray) -> list[np.ndarray]:
    return [tsp_order_mode(x, k) for k in range(x.ndim)]


def identity_orders(shape: tuple[int, ...]) -> list[np.ndarray]:
    return [np.arange(n, dtype=np.int64) for n in shape]


# ---------------------------------------------------------------------------
# Alg. 3: LSH-paired swap refinement
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SwapStats:
    mode: int
    pairs: int
    accepted: int
    delta_sum: float


def _build_pairs(proj: dict[int, float], n: int, rng: np.random.Generator) -> np.ndarray:
    """Lines 11-21 of Alg. 3: bucket the projected points, XOR-pair within
    buckets, randomly pair the leftovers.  Returns [P, 2] disjoint pairs."""
    num_buckets = max(n // 8, 1)
    idx = np.array(sorted(proj.keys()), dtype=np.int64)
    vals = np.array([proj[i] for i in idx])
    lo, hi = vals.min(), vals.max()
    width = (hi - lo) / num_buckets if hi > lo else 1.0
    bucket = np.minimum(((vals - lo) / width).astype(np.int64), num_buckets - 1)

    pairs: list[tuple[int, int]] = []
    leftovers: list[int] = []
    for b in np.unique(bucket):
        members = list(idx[bucket == b])
        rng.shuffle(members)
        while len(members) > 1:
            i1, i2 = members.pop(), members.pop()
            pairs.append((i1, i2 ^ 1))
            pairs.append((i1 ^ 1, i2))
        leftovers.extend(members)
    # line 19-21: leftovers plus their XOR partners, paired randomly
    rest = list({j for i in leftovers for j in (i, i ^ 1) if j < n})
    rng.shuffle(rest)
    while len(rest) > 1:
        pairs.append((rest.pop(), rest.pop()))
    # keep pairs disjoint and in-range
    seen: set[int] = set()
    out = []
    for a, b in pairs:
        if a >= n or b >= n or a == b or a in seen or b in seen:
            continue
        seen.add(a)
        seen.add(b)
        out.append((a, b))
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def _sample_half(n: int, rng: np.random.Generator) -> np.ndarray:
    """Lines 3-5: from each (2t, 2t+1) pair keep one index u.a.r."""
    base = np.arange(0, n - 1, 2, dtype=np.int64)
    return base + (rng.random(base.shape[0]) < 0.5)


def update_orders(
    x: np.ndarray,
    params: nttd.Params,
    pi: list[np.ndarray],
    spec: FoldingSpec,
    cfg: nttd.NTTDConfig,
    rng: np.random.Generator,
    samples_per_slice: int = 512,
    predict_fn=None,
    t_threshold: float = 2.0,
) -> tuple[list[np.ndarray], list[SwapStats]]:
    """One Alg. 3 sweep over all modes.  Mutates a copy of ``pi``.

    Deviation from the paper (the reference's, kept): when a slice is
    larger than ``samples_per_slice`` the loss delta is *estimated* on
    sampled entries, and a swap is accepted only if the paired t-statistic
    of the per-sample deltas clears ``t_threshold`` — plain sign acceptance
    on noisy estimates scrambles a good order early in training.  For
    slices within the sample budget the delta is exact and plain Δ<0
    acceptance (the paper's rule) is used.
    """
    d = x.ndim
    pi = [p.copy() for p in pi]
    stats: list[SwapStats] = []

    predict = predict_fn or nttd.make_predict(spec, cfg)
    device = nttd.params_device(params)

    for k in range(d):
        n_k = x.shape[k]
        if n_k < 4:
            stats.append(SwapStats(k, 0, 0, 0.0))
            continue
        # ---- project sampled slices of the *current reordered* tensor -----
        sampled = _sample_half(n_k, rng)
        slices = _slice_matrix(x, k)  # rows indexed by ORIGINAL index
        r_vec = rng.standard_normal(slices.shape[1])
        r_vec /= np.linalg.norm(r_vec) + 1e-12
        proj: dict[int, float] = {}
        for pos in sampled:
            v = slices[pi[k][pos]].astype(np.float64)
            nv = np.linalg.norm(v)
            proj[int(pos)] = float(v @ r_vec / nv) if nv > 0 else 0.0
        pairs = _build_pairs(proj, n_k, rng)
        if pairs.shape[0] == 0:
            stats.append(SwapStats(k, 0, 0, 0.0))
            continue
        # ---- sampled positions for the loss delta --------------------------
        other_dims = [x.shape[j] for j in range(d) if j != k]
        slice_size = int(np.prod(other_dims))
        s = min(samples_per_slice, slice_size)
        exact = s == slice_size
        n_pairs = pairs.shape[0]
        if exact:
            grids = np.indices(other_dims).reshape(d - 1, -1).T  # [S, d-1]
            rest = np.broadcast_to(grids, (n_pairs,) + grids.shape)
        else:
            rest = np.stack(
                [rng.integers(0, dim, size=(n_pairs, s)) for dim in other_dims],
                axis=-1,
            )  # [P, S, d-1]
        # positions (in reordered coords) for both slices of each pair
        def full_pos(slice_pos: np.ndarray) -> np.ndarray:
            out = np.empty((n_pairs, s, d), dtype=np.int64)
            oi = 0
            for j in range(d):
                if j == k:
                    out[:, :, j] = slice_pos[:, None]
                else:
                    out[:, :, j] = rest[:, :, oi]
                    oi += 1
            return out

        pos_a = full_pos(pairs[:, 0])
        pos_b = full_pos(pairs[:, 1])
        # model predictions depend only on positions (reordered coords)
        all_pos = np.concatenate([pos_a, pos_b]).reshape(-1, d)
        with torch.no_grad():
            preds = predict(params, torch.as_tensor(all_pos, device=device)).cpu().numpy()
        preds = preds.reshape(2, n_pairs, s).astype(np.float64)
        # data values under current assignment and under the swap
        def gather(positions: np.ndarray) -> np.ndarray:
            orig = np.empty_like(positions)
            for j in range(d):
                orig[:, :, j] = pi[j][positions[:, :, j]]
            return x[tuple(orig[:, :, j] for j in range(d))].astype(np.float64)

        val_a = gather(pos_a)  # X at slice a's current original index
        val_b = gather(pos_b)
        # swap exchanges the data that sits at positions a and b
        cur = (preds[0] - val_a) ** 2 + (preds[1] - val_b) ** 2
        swp = (preds[0] - val_b) ** 2 + (preds[1] - val_a) ** 2
        dsamp = swp - cur  # [P, S] per-sample deltas
        delta = dsamp.sum(axis=1)  # [P]
        if exact:
            accept = delta < 0.0
        else:
            sd = dsamp.std(axis=1) + 1e-12
            tstat = dsamp.mean(axis=1) / (sd / np.sqrt(s))
            accept = tstat < -t_threshold
        for t in np.nonzero(accept)[0]:
            a, b = pairs[t]
            pi[k][a], pi[k][b] = pi[k][b], pi[k][a]
        stats.append(
            SwapStats(k, n_pairs, int(accept.sum()), float(delta[accept].sum()))
        )
    return pi, stats
