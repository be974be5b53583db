"""Step factories: train / prefill / decode, with sharding trees, as in
``repro.train.step``.

``make_train_step`` is the reference's step in eager PyTorch: the f32
master weights cast once to the compute dtype, the loss and its gradients
(``torch.autograd.grad`` against the masters, so every gradient comes back
in the masters' dtype as ``jax.grad`` gives it), the ``grad_transform``
hook, the optimizer and the metrics ``loss``/``xent``/``aux``/``grad_norm``.

The step updates the params and the optimizer state in place
(``Optimizer.apply_``) and returns the same tensors, so a step holds one
copy of each: the port's form of the reference's ``donate_argnums=(0, 1)``.
It gives the same bits as ``update`` followed by ``apply_updates``.

Training attention is the oracle with autograd (``cfg.attn_impl="ref"``,
the configs' default), as the reference trains through its jnp oracle: the
reference has no backward attention kernel.

The sharding trees (``effective_rules``, ``batch_shardings``,
``param_shardings``, ``opt_shardings``, ``cache_shardings``) are the
reference's, ``NamedSharding`` trees on a ``MeshShape`` or a
``DeviceMesh``; the dry-run's rule check resolves them.

The same steps run tensor- and data-parallel: inside
``sharding_ctx(mesh, rules)`` on a ``DeviceMesh``, with the params and
optimizer state laid out by ``param_shardings``/``opt_shardings`` and the
batch by ``batch_shardings`` (``dist.sharding.device_put``), every leaf is
a ``DTensor`` and DTensor's sharding rules run each operation on the
shards; the models' ``shard`` constraints lay out the activations as the
reference's do.  Each gradient reaches ``grad_transform`` and the
optimizer in its master's placements, reduced over the data-parallel axes
once and in the master's dtype (a block's slice as the block's backward
ends, ``models.transformer``; every other leaf as the backward pass
ends), and the metrics replicated.
Where DTensor has no rule, or a costly one, the
code works on each rank's shard in plain sight: the embedding table is
replicated before its gather, the cross-entropy is vocab-parallel
(``models.layers``), decode attends each rank's shard of the KV cache
(``models.attention``), and top-k compression replicates a leaf's
magnitudes (``dist.grad_compress``).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import sharding
from repro_torch.models import layers, model
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import AdamState, tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def value_and_grad(loss_fn, params, *args):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args) -> (loss, aux)``
    against every leaf of ``params``; ``aux`` is detached.  Each gradient
    is laid out as its leaf (``sharding.layout_grad``: autograd gives a
    ``DTensor`` leaf's back as a ``Partial`` sum over the mesh dims that
    split the batch, reduced there once): here for the leaves outside
    ``params["blocks"]``, whose slices ``transformer.run_stack`` lays out
    block by block.  A leaf the loss does not read (the token table of a
    model fed ``embeds``) gets a zero gradient, as ``jax.grad`` gives it."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    laid = {k: v if k == "blocks" else tree_map(sharding.layout_grad, v)
            for k, v in tree_unflatten(params, leaves).items()}
    with torch.enable_grad():
        loss, aux = loss_fn(laid, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    aux = tree_map(lambda a: a.detach(), aux)
    return (loss.detach(), aux), tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, opt, grad_transform=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    params and state updated in place.

    ``grad_transform(grads) -> grads`` hooks gradient compression (see
    ``repro_torch.dist.grad_compress``) between backprop and the optimizer.
    """
    compute_dt = layers.dtype_of(cfg.compute_dtype)
    param_dt = layers.dtype_of(cfg.param_dtype)

    def loss_with_cast(p, batch):
        if param_dt != compute_dt:
            # cast the master weights once; every use then reads the
            # compute-dtype copy, as in the reference.  A block's are cast
            # as the block runs, after their gradient's layout step, which
            # so reduces the gradient in the masters' dtype
            p = {k: v if k == "blocks" else tree_map(lambda w: w.to(compute_dt), v)
                 for k, v in p.items()}
        return model.loss_fn(p, cfg, batch, block_dtype=compute_dt)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(loss_with_cast, params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        metrics = dict(metrics)
        metrics["loss"] = loss
        # before the update: the in-place update clips the grads it is given
        metrics["grad_norm"] = optimizers.global_norm(grads)
        opt_state = opt.apply_(grads, opt_state, params)
        return params, opt_state, {k: sharding.replicate(v) for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, cache, batch):
        with torch.no_grad():
            return model.prefill(params, cfg, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"), cache=cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch, cache_len):
        with torch.no_grad():
            return model.decode_step(params, cfg, token=batch.get("tokens"),
                                     embeds=batch.get("embeds"), cache=cache,
                                     cache_len=cache_len)

    return decode_step


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors: shape and dtype, no storage)
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Abstract model inputs for one (arch x shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    ct = layers.dtype_of(cfg.compute_dtype)
    i32 = torch.int32
    if shape.kind == "train":
        batch: dict[str, Any] = {"labels": _meta((b, s), i32)}
        if cfg.input_kind == "embeddings":
            batch["embeds"] = _meta((b, s, cfg.d_model), ct)
        else:
            batch["tokens"] = _meta((b, s), i32)
        return batch
    if shape.kind == "prefill":
        if cfg.input_kind == "embeddings":
            return {"embeds": _meta((b, s, cfg.d_model), ct)}
        return {"tokens": _meta((b, s), i32)}
    # decode: one new token against a cache of length s
    if cfg.input_kind == "embeddings":
        return {"embeds": _meta((b, 1, cfg.d_model), ct)}
    return {"tokens": _meta((b, 1), i32)}


def abstract_opt_state(cfg: ModelConfig) -> AdamState:
    f32 = tree_map(lambda x: _meta(x.shape, torch.float32), model.abstract_params(cfg))
    return AdamState(step=_meta((), torch.int32), mu=f32,
                     nu=tree_map(lambda x: _meta(x.shape, torch.float32), f32))


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------
def effective_rules(mesh, shape: ShapeConfig, base: dict | None = None,
                    cfg: ModelConfig | None = None) -> dict:
    """Adjust the rules table to the cell:
    * global batch cannot fill the DP axes (long-context decode) ->
      replicate batch, spread the KV length over 'data' (SP flash-decode);
    * serving with a TP axis -> the cache's length over 'model'
      (flash-decode: no assigned arch has KV heads the 16-way axis divides);
    * head count cannot take the TP axis -> context-parallel attention
      (q/scores sharded on 'seq_attn' -> 'model'), and in training the
      residual stream's sequence too (Megatron SP)."""
    rules = dict(base or sharding.BASE_RULES)
    sizes = sharding.mesh_axes(mesh)
    dp = math.prod(sizes[a] for a in sharding.dp_axes(mesh))
    if shape.global_batch % dp != 0:
        rules["batch"] = None
        rules["kv_seq"] = "data"
    elif shape.kind in ("prefill", "decode") and "model" in sizes:
        rules["kv_seq"] = "model"
    if cfg is not None and cfg.n_heads and "model" in sizes and cfg.n_heads % sizes["model"]:
        rules["seq_attn"] = "model"
        if shape.kind == "train":
            rules["seq"] = "model"
    return rules


def batch_shardings(mesh, cfg: ModelConfig, batch_spec: dict, rules: dict) -> dict:
    def spec_for(name):
        logical = ("batch", "seq", "act_embed") if name == "embeds" else ("batch", "seq")
        return sharding.NamedSharding(mesh, sharding.logical_pspec(logical, rules, mesh))

    return {k: spec_for(k) for k in batch_spec}


def replicated(mesh) -> sharding.NamedSharding:
    return sharding.NamedSharding(mesh, sharding.PartitionSpec())


def param_shardings(mesh, cfg: ModelConfig, rules: dict):
    return sharding.tree_shardings(mesh, model.param_specs(cfg), rules)


def opt_shardings(mesh, cfg: ModelConfig, rules: dict) -> AdamState:
    ps = param_shardings(mesh, cfg, rules)
    return AdamState(step=replicated(mesh), mu=ps, nu=ps)


def cache_shardings(mesh, cfg: ModelConfig, batch: int, max_len: int, long_ctx: bool,
                    rules: dict):
    return sharding.tree_shardings(mesh, model.cache_specs(cfg, batch, max_len, long_ctx), rules)
