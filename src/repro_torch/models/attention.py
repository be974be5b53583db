"""GQA attention with RoPE: full-sequence, prefill (cache write), decode.

Port of ``repro.models.attention``.  Prefill and full-sequence attention
go through ``ops.attention`` with ``cfg.attn_impl`` (the flash kernel for
"auto"/"cuda"); decode attends the cache through the oracle with
``kv_len``, as the reference does.  The KV cache is preallocated and
written in place: prefill fills [0, S), decode writes position
``cache_len``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (ParamSpec, Shards, is_dtensor, leading_shards, matmul,
                                       shard)
from repro_torch.kernels import ops
from repro_torch.models import layers


def attn_specs(cfg: ModelConfig, stacked: tuple[int, ...] = ()) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lead = tuple("layers" for _ in stacked)
    out = {
        "wq": ParamSpec(stacked + (d, h, hd), lead + ("ffn_in", "heads", "head_dim")),
        "wk": ParamSpec(stacked + (d, kv, hd), lead + ("ffn_in", "kv_heads", "head_dim")),
        "wv": ParamSpec(stacked + (d, kv, hd), lead + ("ffn_in", "kv_heads", "head_dim")),
        "wo": ParamSpec(stacked + (h, hd, d), lead + ("heads", "head_dim", "ffn_in")),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamSpec(stacked + (h, hd), lead + ("heads", "head_dim"), init="zeros")
        out["bk"] = ParamSpec(stacked + (kv, hd), lead + ("kv_heads", "head_dim"), init="zeros")
        out["bv"] = ParamSpec(stacked + (kv, hd), lead + ("kv_heads", "head_dim"), init="zeros")
    return out


def _proj(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product.  A ``DTensor`` weight
    whose heads no mesh dim splits (a head count the mesh does not divide:
    the rules replicate it) runs on each rank's shard of x's leading dims
    against the whole weight: DTensor may split the product's h * k
    columns over a mesh dim that cannot split the h heads, which the
    unflatten into heads (or its gradient's) then refuses."""
    d, h, k = w.shape
    if is_dtensor(w) and not any(p.is_shard(1) for p in w.placements):
        shards = leading_shards(x)
        y = shards.local(x) @ shards.weight(w).to(dt).reshape(d, h * k)
        return shards.mesh_tensor(y.reshape(*y.shape[:-1], h, k))
    return matmul(x, w.to(dt).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out(o: torch.Tensor, wo: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matrix product."""
    h, k, d = wo.shape
    return matmul(o.reshape(*o.shape[:-2], h * k), wo.to(dt).reshape(h * k, d))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str,
            **kw) -> torch.Tensor:
    """``ops.attention``; on ``DTensor``s (a mesh), on each rank's shard.

    Attention is independent per sequence and per head, so a mesh dim that
    splits the batch, or the heads, of q, k and v alike keeps its split;
    every other one is replicated first (the sequence: its causal mask
    needs the whole of k).  Equal splits of q's and the KV heads keep each
    q head beside its KV head.  DTensor cannot run the oracle's einsum on
    its own where batch and heads are both split (it would flatten two
    sharded dims into one); ``kv_len`` (decode) keeps the batch whole.
    """
    if not is_dtensor(q):
        return ops.attention(q, k, v, impl=impl, **kw)
    kept = (0, 2) if kw.get("kv_len") is None else (2,)
    shards = Shards(q.device_mesh, tuple(
        pq.dim if pq == pk == pv and pq.is_shard() and pq.dim in kept else None
        for pq, pk, pv in zip(q.placements, k.placements, v.placements)))
    out = ops.attention(shards.local(q), shards.local(k), shards.local(v), impl=impl, **kw)
    return shards.mesh_tensor(out)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, dt):
    q = _proj(x, p["wq"], dt)
    k = _proj(x, p["wk"], dt)
    v = _proj(x, p["wv"], dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    # 'seq_attn' is None by default; rules map it to 'model' for archs
    # whose head count cannot take the TP axis (context-parallel attention)
    q = shard(q, "batch", "seq_attn", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def self_attention(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full causal self-attention (scoring)."""
    dt = x.dtype
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _qkv(p, x, cfg, positions, dt)
    out = _attend(q, k, v, cfg.attn_impl, causal=True)
    out = shard(out, "batch", "seq_attn", "heads", "head_dim")
    return _out(out, p["wo"], dt)


def prefill_attention(
    p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict
) -> tuple[torch.Tensor, dict]:
    """Causal attention over the prompt; writes k/v into the cache at [0, S)
    in place and returns it."""
    dt = x.dtype
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions, dt)
    out = _attend(q, k, v, cfg.attn_impl, causal=True)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    out = shard(out, "batch", "seq", "heads", "head_dim")
    return _out(out, p["wo"], dt), cache


def decode_attention(
    p: dict,
    x: torch.Tensor,   # [B, 1, d]
    cfg: ModelConfig,
    cache: dict,       # k/v: [B, S_max, KV, hd]
    cache_len: int,    # tokens already in cache
) -> tuple[torch.Tensor, dict]:
    """Single-token decode against the KV cache (written in place)."""
    dt = x.dtype
    positions = torch.full((1,), cache_len, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions, dt)
    cache["k"][:, cache_len : cache_len + 1] = k
    cache["v"][:, cache_len : cache_len + 1] = v
    kv_len = torch.full((x.shape[0],), cache_len + 1, dtype=torch.int32, device=x.device)
    # single-query path: the oracle, as in the reference
    out = _attend(q, cache["k"].to(dt), cache["v"].to(dt), "ref", causal=False, kv_len=kv_len)
    out = shard(out, "batch", "seq", "heads", "head_dim")
    return _out(out, p["wo"], dt), cache


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, long_ctx: bool = False,
                stacked: tuple[int, ...] = ()) -> dict:
    """ParamSpec tree for the attention KV cache."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    seq_axis = "long_kv" if long_ctx else "kv_seq"
    lead = tuple("layers" for _ in stacked)
    spec = ParamSpec(
        stacked + (batch, max_len, kv, hd),
        lead + ("batch", seq_axis, "kv_heads", "head_dim"),
        init="zeros",
        dtype=layers.dtype_of(cfg.compute_dtype),
    )
    return {"k": spec, "v": spec}
