"""Model API over the architecture zoo, port of ``repro.models.model``.

    specs  = param_specs(cfg)                          # ParamSpec tree
    params = init_params(cfg, seed, device)            # real weights
    logits, aux   = forward(params, cfg, tokens=...)   # teacher-forced
    loss, metrics = loss_fn(params, cfg, batch)
    logits, cache = prefill(params, cfg, tokens, cache)
    logits, cache = decode_step(params, cfg, token, cache, cache_len)

Params are a nested dict mirroring the JAX tree key for key.  Caches
(attention k/v, Mamba conv and ssm state) are preallocated by
``init_cache`` and updated in place by ``prefill`` and ``decode_step``,
which return the same dict.  ``[vlm]``/``[audio]`` archs take
precomputed frontend embeddings via ``embeds=``.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import resolve_device
from repro_torch.dist import sharding
from repro_torch.models import layers, transformer


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def param_specs(cfg: ModelConfig) -> dict:
    return transformer.param_specs(cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device=None, shardings=None) -> dict:
    """Random weights from ``seed``, each leaf built in ``cfg.param_dtype``
    on ``device`` (CUDA unless given); given ``shardings`` (the
    ``train.step.param_shardings`` tree), each leaf a ``DTensor`` laid out
    by them, the same values as on one device."""
    return sharding.materialize(
        seed, param_specs(cfg), layers.dtype_of(cfg.param_dtype), resolve_device(device),
        shardings)


def abstract_params(cfg: ModelConfig) -> dict:
    return sharding.tree_abstract(param_specs(cfg), layers.dtype_of(cfg.param_dtype))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, long_ctx: bool = False):
    return transformer.cache_specs(cfg, batch, max_len, long_ctx)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, long_ctx: bool = False):
    return sharding.tree_abstract(
        cache_specs(cfg, batch, max_len, long_ctx), layers.dtype_of(cfg.compute_dtype))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, long_ctx: bool = False,
               device=None) -> dict:
    """Zero cache on ``device`` (CUDA unless given): k/v and the conv state
    in ``cfg.compute_dtype``, the ssm state in f32."""
    return sharding.materialize(
        0, cache_specs(cfg, batch, max_len, long_ctx), layers.dtype_of(cfg.compute_dtype),
        resolve_device(device),
    )


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------
def _embed_in(params, cfg: ModelConfig, tokens, embeds):
    dt = layers.dtype_of(cfg.compute_dtype)
    if embeds is not None:
        x = embeds.to(dt)
    else:
        x = layers.embed_lookup(params["tok"], tokens, dt)
    return sharding.shard(x, "batch", "seq", "act_embed")


def forward(params, cfg: ModelConfig, tokens=None, embeds=None, block_dtype=None):
    """Teacher-forced full-sequence forward.  Returns (logits, aux).
    ``block_dtype``: ``transformer.run_stack``'s."""
    x = _embed_in(params, cfg, tokens, embeds)
    x, _, aux = transformer.run_stack(params, x, cfg, mode="full", block_dtype=block_dtype)
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(params["tok"], x, layers.dtype_of(cfg.compute_dtype)), aux


def loss_fn(params, cfg: ModelConfig, batch: dict, block_dtype=None):
    """batch: {'tokens' or 'embeds', 'labels'}.  Returns (loss, {'xent', 'aux'}).
    ``block_dtype``: ``transformer.run_stack``'s."""
    logits, aux = forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        block_dtype=block_dtype,
    )
    xent = layers.softmax_xent(logits, batch["labels"], valid_vocab=cfg.vocab)
    loss = xent + cfg.moe_aux_weight * aux
    return loss, {"xent": xent, "aux": aux}


def prefill(params, cfg: ModelConfig, tokens=None, cache=None, embeds=None):
    """Process the prompt, fill the cache.  Returns (last-position logits, cache)."""
    x = _embed_in(params, cfg, tokens, embeds)
    x, cache, _ = transformer.run_stack(params, x, cfg, cache=cache, mode="prefill")
    x = layers.rmsnorm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(params["tok"], x, layers.dtype_of(cfg.compute_dtype))
    return logits, cache


def decode_step(params, cfg: ModelConfig, token=None, cache=None, cache_len: int = 0,
                embeds=None):
    """One decode step.  token: [B, 1] ids (or embeds [B, 1, d]);
    cache_len: tokens already in the cache.  Returns (logits, cache)."""
    x = _embed_in(params, cfg, token, embeds)
    x, cache, _ = transformer.run_stack(
        params, x, cfg, cache=cache, cache_len=int(cache_len), mode="decode"
    )
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(params["tok"], x, layers.dtype_of(cfg.compute_dtype))
    return logits, cache


# ---------------------------------------------------------------------------
# analytic parameter counts
# ---------------------------------------------------------------------------
def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total parameters, or with ``active_only`` those a token uses: the
    total less the weights of the experts its router does not pick."""
    total = sum(math.prod(s.shape) for s in sharding.leaves(param_specs(cfg)))
    if not active_only or not cfg.moe_experts:
        return total
    n_moe = sum(1 for _, f in transformer.block_layout(cfg) if f == "moe") * cfg.n_blocks
    per_expert = 3 * cfg.d_model * cfg.d_ff
    return total - n_moe * (cfg.moe_experts - cfg.moe_top_k) * per_expert
