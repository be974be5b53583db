"""GQA attention with RoPE: full-sequence, prefill (cache write), decode.

Port of ``repro.models.attention``.  Prefill and full-sequence attention
go through ``ops.attention`` with ``cfg.attn_impl`` (the flash kernel for
"auto"/"cuda"); decode attends the cache through the oracle with
``kv_len``, as the reference does.  The KV cache is preallocated and
written in place: prefill fills [0, S), decode writes position
``cache_len``.  On a mesh the cache stays split as its sharding lays it
out (batch, heads, and the sequence over ``kv_seq``/``long_kv``): each
rank writes and attends its own shard, and the shards of one sequence are
combined by their log-sum-exps (flash-decode), where the reference lets
XLA partition the length reduction.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import ParamSpec, Shards, is_dtensor, matmul, shard
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
    """einsum('bsd,dhk->bshk') as one matrix product (``matmul``: on a
    mesh the product's columns are split only where w's heads are)."""
    d, h, k = w.shape
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
    q head beside its KV head.  With ``kv_len`` (decode against the cache)
    the cache's layout is kept instead (``_decode_on_shards``).
    """
    if not is_dtensor(q):
        return ops.attention(q, k, v, impl=impl, **kw)
    if kw.get("kv_len") is not None:
        return _decode_on_shards(q, k, v, impl, **kw)
    shards = Shards(q.device_mesh, tuple(
        pq.dim if pq == pk == pv and pq.is_shard() and pq.dim in (0, 2) else None
        for pq, pk, pv in zip(q.placements, k.placements, v.placements)))
    out = ops.attention(shards.local(q), shards.local(k), shards.local(v), impl=impl, **kw)
    return shards.mesh_tensor(out)


def _decode_on_shards(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str, *,
                      kv_len: torch.Tensor, **kw) -> torch.Tensor:
    """Decode attention on ``DTensor``s that keeps the cache where it is.

    Each rank attends its own shard of the cache (k and v alike; any other
    split of theirs is replicated): its batch rows, with ``kv_len`` (a
    plain [B] tensor, whole on every rank) sliced to them; its heads; and
    its piece of the sequence, for which q (one token a sequence, its RoPE
    at the global position) is replicated and ``kv_len`` taken relative to
    the piece's start, clamped to [0, piece length].  q is laid out to
    match.  Pieces of one sequence are combined as in
    flash-decode: each gives its normalised output and its log-sum-exp
    (``ops.attention(..., return_lse=True)``: -inf and 0 for a piece with
    no valid position), then an all-reduce (max) of the log-sum-exps, the
    outputs weighted by ``exp(lse - max)`` and two all-reduces (sum) of the
    weighted outputs and of the weights, in f32.  Each row needs
    ``kv_len`` >= 1.  No collective moves the cache."""
    import torch.distributed as dist

    shards = Shards(q.device_mesh, tuple(
        pk.dim if pk == pv and pk.is_shard() and pk.dim in (0, 1, 2) else None
        for pk, pv in zip(k.placements, v.placements)))
    kl, vl = shards.local(k), shards.local(v)
    ql = shards.local(q, {1: None})  # q whole along the cache's sequence
    b0, s0 = shards.start(0, k.shape[0]), shards.start(1, k.shape[1])
    kv_len = kv_len.to(kl.device)[b0:b0 + kl.shape[0]]
    if not shards.mesh_dims(1):
        return shards.mesh_tensor(ops.attention(ql, kl, vl, impl=impl, kv_len=kv_len, **kw),
                                  {1: None})
    kv_len = (kv_len - s0).clamp(0, kl.shape[1])
    out, lse = ops.attention(ql, kl, vl, impl=impl, kv_len=kv_len, return_lse=True,
                             **kw)
    top = shards.all_reduce(lse.clone(), dist.ReduceOp.MAX, 1)
    w = torch.exp(lse - top)
    num = shards.all_reduce(out * w[..., None], dist.ReduceOp.SUM, 1)
    den = shards.all_reduce(w, dist.ReduceOp.SUM, 1)
    return shards.mesh_tensor((num / den[..., None]).to(q.dtype), {1: None})


def _write_cache(cache: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``cache[:, start:start + n] = new`` in place (n = ``new.shape[1]``).
    On a ``DTensor`` cache each rank writes into its own shard the
    positions that the shard holds, from ``new`` laid out as the cache is
    along batch and heads (whole along the sequence): the cache neither
    moves nor changes its layout."""
    if not is_dtensor(cache):
        cache[:, start:start + new.shape[1]] = new
        return
    shards = Shards(cache.device_mesh, tuple(p.dim if p.is_shard() else None
                                             for p in cache.placements))
    piece = shards.local(new, {1: None})  # every rank: a collective may run
    local = cache.to_local()
    s0 = shards.start(1, cache.shape[1])
    lo, hi = max(start, s0), min(start + new.shape[1], s0 + local.shape[1])
    if lo < hi:
        local[:, lo - s0:hi - s0] = piece[:, lo - start:hi - start]


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
    _write_cache(cache["k"], k, 0)
    _write_cache(cache["v"], v, 0)
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
    _write_cache(cache["k"], k, cache_len)
    _write_cache(cache["v"], v, cache_len)
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
