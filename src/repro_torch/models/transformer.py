"""Decoder stack assembly for all four families, port of
``repro.models.transformer``.

A *block* is the unit stacked over depth; each family defines a block
layout, a list of (mixer, ffn) sublayers:

  dense    : [(attn, mlp)]                                x n_layers
  moe e1   : [(attn, moe)]                                x n_layers   (grok)
  moe e2   : [(attn, mlp), (attn, moe)]                   x n_layers/2 (llama4)
  hybrid   : [(attn, mlp|moe), (mamba, ...) x 7]          x n_layers/8 (jamba,
             1 attention per 8 sublayers, MoE on odd sublayer indices)
  ssm      : [(mamba, None)]                              x n_layers   (mamba2)

Within a block, params of each sublayer type are stacked on a sublayer
dim and applied by a short loop; blocks are stacked on a leading
``[n_blocks, ...]`` dim of every leaf, as in the reference.  The
reference's ``lax.scan`` over blocks is a Python loop over that dim here
(``torch.unbind``, whose gradient is one stack of the blocks' gradients,
each laid out as its block's slice of the masters on a mesh),
and the caches (attention k/v, Mamba conv and ssm state) are written in
place.  ``aux`` sums the MoE load-balance losses over sublayers and blocks.

``cfg.remat`` wraps each block of the full (training) mode as the
reference wraps its scan body in ``jax.checkpoint``: "none" keeps every
activation, "full" recomputes the block in the backward pass
(``torch.utils.checkpoint``), "dots" saves only the matrix products and
recomputes the rest (a selective-checkpoint policy that saves ``aten.mm``,
the projections' and the MLP's products, as the reference's
``dots_with_no_batch_dims_saveable`` saves its dot products without batch
dims; batched products, the attention oracle's, the experts' and the
SSD's, are recomputed).  All three give the same loss and gradients.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import ParamSpec, current_ctx, layout_grad, shard, sharding_ctx
from repro_torch.models import attention, layers, mamba, moe


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------
def block_layout(cfg: ModelConfig) -> list[tuple[str, str | None]]:
    if cfg.family == "dense":
        return [("attn", "mlp")]
    if cfg.family == "moe":
        if cfg.moe_every == 1:
            return [("attn", "moe")]
        return [("attn", "moe" if i % 2 == 1 else "mlp") for i in range(cfg.moe_every)]
    if cfg.family == "hybrid":
        return [("attn" if i == 0 else "mamba",
                 "moe" if (cfg.moe_experts and i % 2 == 1) else "mlp")
                for i in range(cfg.attn_every)]
    if cfg.family == "ssm":
        return [("mamba", None)]
    raise ValueError(cfg.family)


def _counts(cfg: ModelConfig) -> dict[str, int]:
    layout = block_layout(cfg)
    return {
        "attn": sum(1 for m, _ in layout if m == "attn"),
        "mamba": sum(1 for m, _ in layout if m == "mamba"),
        "mlp": sum(1 for _, f in layout if f == "mlp"),
        "moe": sum(1 for _, f in layout if f == "moe"),
        "sub": len(layout),
        "ffn": sum(1 for _, f in layout if f),
    }


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
def block_specs(cfg: ModelConfig) -> dict:
    c = _counts(cfg)
    nb, d = cfg.n_blocks, cfg.d_model
    specs: dict[str, Any] = {
        "mixer_norm": ParamSpec((nb, c["sub"], d), ("layers", "layers", "act_embed"),
                                init="ones"),
    }
    if c["ffn"]:
        specs["ffn_norm"] = ParamSpec((nb, c["ffn"], d), ("layers", "layers", "act_embed"),
                                      init="ones")
    if c["attn"]:
        specs["attn"] = attention.attn_specs(cfg, stacked=(nb, c["attn"]))
    if c["mamba"]:
        specs["mamba"] = mamba.mamba_specs(cfg, stacked=(nb, c["mamba"]))
    if c["mlp"]:
        specs["mlp"] = layers.mlp_specs(d, cfg.d_ff, stacked=(nb, c["mlp"]))
    if c["moe"]:
        specs["moe"] = moe.moe_specs(cfg, stacked=(nb, c["moe"]))
    return specs


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
    c = _counts(cfg)
    nb = cfg.n_blocks
    out: dict[str, Any] = {}
    if c["attn"]:
        out["attn"] = attention.cache_specs(cfg, batch, max_len, long_ctx,
                                            stacked=(nb, c["attn"]))
    if c["mamba"]:
        out["mamba"] = mamba.state_specs(cfg, batch, stacked=(nb, c["mamba"]))
    return out


def cache_max_len(cache) -> int:
    """Static max length from an (abstract or real) attn cache tree."""
    return cache["attn"]["k"].shape[-3]


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
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One block -> (x, aux).  ``cache`` (this block's slice of every cache
    leaf) is written in place in prefill and decode modes; aux is None in a
    block without MoE sublayers."""
    eps = cfg.norm_eps
    dt = layers.dtype_of(cfg.compute_dtype)
    aux = None
    idx = {"attn": 0, "mamba": 0, "mlp": 0, "moe": 0}
    for sub, (mixer, ffn) in enumerate(block_layout(cfg)):
        h = layers.rmsnorm(x, bp["mixer_norm"][sub], eps)
        j = idx[mixer]
        if mixer == "attn":
            ap = _tree_index(bp["attn"], j)
            if mode == "full":
                y = attention.self_attention(ap, h, cfg)
            elif mode == "prefill":
                y, _ = attention.prefill_attention(ap, h, cfg, _tree_index(cache["attn"], j))
            else:
                y, _ = attention.decode_attention(ap, h, cfg, _tree_index(cache["attn"], j),
                                                  cache_len)
        else:
            st = _tree_index(cache["mamba"], j) if mode != "full" else None
            y, nst = mamba.mamba_forward(_tree_index(bp["mamba"], j), h, cfg,
                                         st if mode == "decode" else None)
            if st is not None:  # prefill writes the prompt's state over the slot's
                for name, leaf in st.items():
                    leaf.copy_(nst[name])
        idx[mixer] += 1
        x = shard(x + y, "batch", "seq", "act_embed")

        if ffn:
            h = layers.rmsnorm(x, bp["ffn_norm"][idx["mlp"] + idx["moe"]], eps)
            if ffn == "mlp":
                y = layers.mlp(_tree_index(bp["mlp"], idx["mlp"]), h, dt)
            else:
                y, a = moe.moe_ffn(_tree_index(bp["moe"], idx["moe"]), h, cfg)
                aux = a if aux is None else aux + a
            idx[ffn] += 1
            x = shard(x + y, "batch", "seq", "act_embed")
    return x, aux


def _unstack(tree, n: int) -> list:
    """A stacked-params tree -> ``n`` per-block trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _laid_out(tree, dtype: torch.dtype | None):
    """A block's params, each of whose gradients is laid out as the param
    (``layout_grad``: on a mesh, one reduction of the block's slice as its
    backward ends, as the reference's scan reduces each layer's, so the
    stack of the blocks' gradients is in the masters' layout, never whole
    over the data-parallel axes), then cast to ``dtype`` unless it is
    None: the reduction sums the gradient in the masters' dtype.  Made
    just before the block runs: the autograd engine runs a ready node made
    later first, so a node made with the others before the first block
    would wait for the whole backward pass, holding every block's
    unreduced gradients."""
    if isinstance(tree, dict):
        return {k: _laid_out(v, dtype) for k, v in tree.items()}
    w = layout_grad(tree)
    return w if dtype is None else w.to(dtype)


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

    def wrapped(*args):
        layout = current_ctx()

        def block(*inputs):
            # the backward pass recomputes the block on autograd's device
            # thread for CUDA tensors, where this thread's sharding context
            # is not set: enter the forward's, or its ``shard`` constraints
            # would lay the recomputed activations out otherwise
            with sharding_ctx(*layout) if layout else contextlib.nullcontext():
                return fn(*inputs)

        return torch_checkpoint.checkpoint(block, *args, use_reentrant=False,
                                           context_fn=context_fn)

    return wrapped


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
    block_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """x: [B, S, d] hidden states -> (x, cache_or_None, aux).  The cache is
    the one passed in, updated in place; aux sums the blocks' MoE losses.
    ``block_dtype`` (mode "full"): each block's params are cast to it as
    the block runs, after their gradient's layout step (``_laid_out``)."""
    if mode not in ("full", "prefill", "decode"):
        raise ValueError(mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "full":
        body = _remat_wrap(lambda bp, h: apply_block(bp, h, cfg, None, None, "full"), cfg)
        for bp in _unstack(params["blocks"], cfg.n_blocks):
            x, a = body(_laid_out(bp, block_dtype), x)
            if a is not None:
                aux = aux + a
        return x, None, aux
    for i in range(cfg.n_blocks):
        x, a = apply_block(_tree_index(params["blocks"], i), x, cfg, _tree_index(cache, i),
                           cache_len, mode)
        if a is not None:
            aux = aux + a
    return x, cache, aux
