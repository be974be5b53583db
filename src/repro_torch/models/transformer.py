"""Decoder stack assembly, port of ``repro.models.transformer``.

Only the ``dense`` layout is ported: a block is one (attention, MLP)
sublayer pair, and blocks are stacked on a leading ``[n_blocks, sub, ...]``
dim of every leaf, as in the reference.  The reference's ``lax.scan``
over blocks is a Python loop over that dim here (``torch.unbind``, whose
gradient is one stack of the blocks' gradients), and the KV cache is
written in place.

``cfg.remat`` wraps each block of the full (training) mode as the
reference wraps its scan body in ``jax.checkpoint``: "none" keeps every
activation, "full" recomputes the block in the backward pass
(``torch.utils.checkpoint``), "dots" saves only the matrix products and
recomputes the rest (a selective-checkpoint policy that saves ``aten.mm``,
the projections' and the MLP's products, as the reference's
``dots_with_no_batch_dims_saveable`` saves its dot products without batch
dims; the attention oracle's batched products are recomputed).  All three
give the same loss and gradients.  The MoE, hybrid and SSM layouts raise
``NotImplementedError`` (ROADMAP A.9).
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import ParamSpec
from repro_torch.models import attention, layers


def _not_ported(cfg: ModelConfig) -> NotImplementedError:
    return NotImplementedError(
        f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet: only 'dense' "
        "stacks are (ROADMAP A.9: MoE, Mamba and hybrid layouts come with their families)"
    )


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------
def block_layout(cfg: ModelConfig) -> list[tuple[str, str | None]]:
    if cfg.family == "dense":
        return [("attn", "mlp")]
    raise _not_ported(cfg)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
def block_specs(cfg: ModelConfig) -> dict:
    sub = len(block_layout(cfg))
    nb, d = cfg.n_blocks, cfg.d_model
    return {
        "mixer_norm": ParamSpec((nb, sub, d), ("layers", "layers", "act_embed"), init="ones"),
        "ffn_norm": ParamSpec((nb, sub, d), ("layers", "layers", "act_embed"), init="ones"),
        "attn": attention.attn_specs(cfg, stacked=(nb, sub)),
        "mlp": layers.mlp_specs(d, cfg.d_ff, stacked=(nb, sub)),
    }


def param_specs(cfg: ModelConfig) -> dict:
    return {
        "tok": layers.embed_specs(cfg.vocab, cfg.d_model, cfg.tie_embeddings),
        "blocks": block_specs(cfg),
        "final_norm": layers.rmsnorm_spec(cfg.d_model),
    }


# ---------------------------------------------------------------------------
# cache specs (serving)
# ---------------------------------------------------------------------------
def cache_specs(cfg: ModelConfig, batch: int, max_len: int, long_ctx: bool = False) -> dict:
    sub = len(block_layout(cfg))
    return {"attn": attention.cache_specs(cfg, batch, max_len, long_ctx,
                                          stacked=(cfg.n_blocks, sub))}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------
def _tree_index(tree, *idx):
    if isinstance(tree, dict):
        return {k: _tree_index(v, *idx) for k, v in tree.items()}
    return tree[idx]


def apply_block(
    bp: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: dict | None,
    cache_len: int | None,
    mode: str,  # full | prefill | decode
) -> torch.Tensor:
    """One dense block; ``cache`` (this block's ``[sub, ...]`` slice) is
    written in place in prefill and decode modes."""
    eps = cfg.norm_eps
    dt = layers.dtype_of(cfg.compute_dtype)
    for sub in range(len(block_layout(cfg))):
        h = layers.rmsnorm(x, bp["mixer_norm"][sub], eps)
        ap = _tree_index(bp["attn"], sub)
        if mode == "full":
            y = attention.self_attention(ap, h, cfg)
        elif mode == "prefill":
            y, _ = attention.prefill_attention(ap, h, cfg, _tree_index(cache["attn"], sub))
        else:
            y, _ = attention.decode_attention(ap, h, cfg, _tree_index(cache["attn"], sub),
                                              cache_len)
        x = x + y
        h = layers.rmsnorm(x, bp["ffn_norm"][sub], eps)
        x = x + layers.mlp(_tree_index(bp["mlp"], sub), h, dt)
    return x


def _unstack(tree, n: int) -> list:
    """A stacked-params tree -> ``n`` per-block trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


#: the products "dots" saves: every 2-D matrix product (the batched
#: attention products are ``bmm``)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOT_OPS else policy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: ModelConfig):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        context_fn = functools.partial(torch_checkpoint.create_selective_checkpoint_contexts,
                                       _save_dots)
    elif cfg.remat == "full":
        context_fn = torch_checkpoint.noop_context_fn
    else:
        raise ValueError(cfg.remat)
    return functools.partial(torch_checkpoint.checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


# ---------------------------------------------------------------------------
# stack (loop over blocks)
# ---------------------------------------------------------------------------
def run_stack(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: dict | None = None,
    cache_len: int | None = None,
    mode: str = "full",
) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """x: [B, S, d] hidden states -> (x, cache_or_None, aux).  The cache is
    the one passed in, updated in place; aux is 0 for dense stacks."""
    if mode not in ("full", "prefill", "decode"):
        raise ValueError(mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "full":
        body = _remat_wrap(lambda bp, h: apply_block(bp, h, cfg, None, None, "full"), cfg)
        for bp in _unstack(params["blocks"], cfg.n_blocks):
            x = body(bp, x)
        return x, None, aux
    for i in range(cfg.n_blocks):
        x = apply_block(_tree_index(params["blocks"], i), x, cfg, _tree_index(cache, i),
                        cache_len, mode)
    return x, cache, aux
