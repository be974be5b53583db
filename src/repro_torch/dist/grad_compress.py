"""Gradient compressors with persistent error feedback, as in
``repro.dist.grad_compress``.

Both compressors follow the EF-SGD discipline (Seide et al. 2014;
Karimireddy et al. 2019): the quantization/sparsification residual is
kept per leaf and added back to the next step's gradient, so compression
error accumulates into later updates instead of being lost.

    comp = ErrorFeedbackInt8()          # or TopK(0.05)
    state = comp.init(params)           # f32 residual tree on the params' device
    grads, state = comp.transform(grads, state)

``transform`` returns *decompressed* gradients, as the reference's does.
Per leaf the arithmetic is the reference's: ``torch.round`` rounds half to
even as ``jnp.round`` does, and ``TopK`` keeps every entry at least as
large as the k-th magnitude (``torch.topk``'s k-th value is
``lax.top_k``'s), so ties keep more than k entries in both packages.

On ``DTensor`` leaves (a mesh) the int8 scale is ``max|g|`` of the whole
leaf, reduced over its shards, and top-k's threshold is over the whole
leaf: DTensor has no ``topk`` over a sharded dim, so the leaf's
magnitudes are replicated before it (an all-gather of each leaf).
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import replicate
from repro_torch.optim.optimizers import tree_map

F32 = torch.float32


def _zeros_like_f32(tree):
    return tree_map(lambda p: torch.zeros_like(p, dtype=F32), tree)


def _map_unzip(fn, grads, state):
    """Apply ``fn(g, e) -> (g', e')`` per leaf; return the two trees."""
    pairs = tree_map(fn, grads, state)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


class ErrorFeedbackInt8:
    """Symmetric per-leaf int8 quantization with error feedback.

    Each leaf is scaled by max|g|/127 and rounded to int8; the rounding
    error goes into the residual.
    """

    def init(self, params):
        return _zeros_like_f32(params)

    @staticmethod
    def _leaf(g, e):
        acc = g.to(F32) + e
        scale = replicate(torch.max(torch.abs(acc))) / 127.0
        q = torch.round(acc / torch.where(scale > 0, scale, torch.ones_like(scale)))
        q = torch.clamp(q, -127, 127).to(torch.int8)
        deq = (q.to(F32) * scale).to(g.dtype)
        # residual measured against the dtype the optimizer actually sees
        return deq, acc - deq.to(F32)

    def transform(self, grads, state):
        return _map_unzip(self._leaf, grads, state)


class TopK:
    """Keep the top ``fraction`` of entries per leaf (by magnitude); the
    rest accumulate in the residual and re-surface on later steps."""

    def __init__(self, fraction: float):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1]: {fraction}")
        self.fraction = fraction

    def init(self, params):
        return _zeros_like_f32(params)

    def _leaf(self, g, e):
        acc = g.to(F32) + e
        k = max(1, math.ceil(acc.numel() * self.fraction))
        thresh = torch.topk(replicate(torch.abs(acc)).reshape(-1), k).values[-1]
        kept = torch.where(torch.abs(acc) >= thresh, acc, torch.zeros_like(acc)).to(g.dtype)
        return kept, acc - kept.to(F32)

    def transform(self, grads, state):
        return _map_unzip(self._leaf, grads, state)
