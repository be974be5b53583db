"""Mixture-of-Experts FFN: top-k router + grouped sort-based dispatch, port
of ``repro.models.moe``.

Tokens are processed in G = batch groups (one per sequence), each with its
own capacity C = max(int(S*k/E * factor), k).  Within a group the routed
slots are stably sorted by expert id, ranked within their expert, and
scattered into a [G, E*C, d] buffer; a slot ranked past the capacity goes
to one spare row past the buffer, which is cut off (the reference's
out-of-bounds scatter with ``mode="drop"``).  The experts' SwiGLU runs as
batched products over the expert dim, and the combine gathers each slot's
output back, weighs it by its gate and adds the k slots of a token.

The router's top-k takes the lower expert index among equal
probabilities, as ``jax.lax.top_k`` does (``torch.topk`` does not promise
it), so both packages route the same tokens to the same experts.

Decode (S == 1): each group is a single token whose k routed experts are
distinct, so C = k drops nothing and decode agrees with teacher forcing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import ParamSpec, batch_shards, matmul, replicate, shard


def moe_specs(cfg: ModelConfig, stacked: tuple[int, ...] = ()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    lead = tuple("layers" for _ in stacked)
    return {
        "router": ParamSpec(stacked + (d, e), lead + ("ffn_in", "experts")),
        "w_gate": ParamSpec(
            stacked + (e, d, f), lead + ("experts", "expert_in", "expert_mlp")
        ),
        "w_up": ParamSpec(
            stacked + (e, d, f), lead + ("experts", "expert_in", "expert_mlp")
        ),
        "w_down": ParamSpec(
            stacked + (e, f, d), lead + ("experts", "expert_mlp", "expert_in")
        ),
    }


def group_capacity(group_tokens: int, cfg: ModelConfig) -> int:
    if group_tokens == 1:
        return cfg.moe_top_k  # decode: exact, zero drops
    cap = int(
        group_tokens * cfg.moe_top_k / cfg.moe_experts * cfg.moe_capacity_factor
    )
    return max(cap, cfg.moe_top_k)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last dim and their indices, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The router: (probs [B,S,E] f32, gate values [B,S,K] normalised,
    expert ids [B,S,K])."""
    logits = matmul(x, p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, cfg.moe_top_k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx


def dispatch(gate_idx: torch.Tensor, cap: int, e: int):
    """Grouped sort-based dispatch plan for ids [G, S, K]: the slot order
    ``order`` [G, Tg] (stable by expert), each sorted slot's token
    ``tok_s``, its buffer row ``slot`` (``e * cap`` when dropped) and
    ``in_cap``."""
    g, s, k = gate_idx.shape
    tg = s * k
    eids = gate_idx.reshape(g, tg)
    tok = torch.div(torch.arange(tg, device=eids.device), k,
                    rounding_mode="floor").expand(g, tg)
    order = torch.argsort(eids, dim=1, stable=True)
    eids_s = eids.gather(1, order)
    tok_s = tok.gather(1, order)
    counts = torch.zeros((g, e), dtype=torch.long, device=eids.device)
    counts.scatter_add_(1, eids, torch.ones_like(eids))        # [G, E]
    seg_start = counts.cumsum(1) - counts
    rank = torch.arange(tg, device=eids.device) - seg_start.gather(1, eids_s)
    in_cap = rank < cap
    slot = torch.where(in_cap, eids_s * cap + rank, e * cap)
    return order, tok_s, slot, in_cap


def _shard_experts(t: torch.Tensor, g: int, last: str) -> torch.Tensor:
    """The reference's constraint on its [G, E, C, X] expert tensors, with
    the same four logical axes, on the port's [E, G*C, X] layout of them
    (seen as [E, G, C, X], a view without a transpose)."""
    e, gc, x = t.shape
    return shard(t.reshape(e, g, gc // g, x),
                 "experts", "moe_group", "capacity", last).reshape(e, gc, x)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y: [B, S, d], aux_loss scalar f32).

    Under a mesh (``DTensor`` x) the routing, dispatch and combine, which
    are per group, run on each rank's batch shard (``dist.sharding.Shards``;
    DTensor's own scatter and gather rules fail on some torch releases);
    the expert products run on ``DTensor``s under the reference's
    constraints, through ``matmul`` (each expert weight gathered over the
    DP axes where the rules split it there)."""
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    g = b                       # one group per sequence
    cap = group_capacity(s, cfg)
    shards = batch_shards(x)
    router = p["router"]
    if shards is not None:
        x, router = shards.local(x), shards.weight(router)
    g_l = x.shape[0]            # this rank's groups

    probs, gate_vals, gate_idx = route({"router": router}, x, cfg)

    # ---- load-balance auxiliary loss (Switch: the first choice only) -----------
    first = F.one_hot(gate_idx[..., 0], e).to(torch.float32)
    if shards is not None:  # the means are over every rank's tokens
        probs, first = shards.mesh_tensor(probs), shards.mesh_tensor(first)
    # each mean is reduced whole ([E], in the forward pass): the gradient to
    # the probabilities then needs no reduction
    aux = e * torch.sum(replicate(probs.mean(dim=(0, 1))) * replicate(first.mean(dim=(0, 1))))

    # ---- grouped sort-based dispatch ----------------------------------------------
    order, tok_s, slot, in_cap = dispatch(gate_idx, cap, e)
    gates_s = gate_vals.reshape(g_l, s * k).gather(1, order)
    gidx = torch.arange(g_l, device=x.device)[:, None]
    xs = x[gidx, tok_s]                                        # [G, Tg, d]
    # one spare row past the buffer takes every dropped slot, then goes
    buf = x.new_zeros((g_l, e * cap + 1, d)).index_put((gidx, slot), xs)
    xe = buf[:, : e * cap].reshape(g_l, e, cap, d).transpose(0, 1).reshape(e, g_l * cap, d)
    if shards is not None:
        xe = shards.mesh_tensor(xe, {0: 1})
    # under EP rules this constraint is the token all-to-all: xe leaves the
    # moe_group sharding and lands expert-sharded
    xe = _shard_experts(xe, g, "expert_in")

    # ---- expert SwiGLU: products batched over the experts ----------------------------
    h = matmul(xe, p["w_gate"].to(dt))
    u = matmul(xe, p["w_up"].to(dt))
    h = _shard_experts(F.silu(h) * u, g, "expert_mlp")
    ye = _shard_experts(matmul(h, p["w_down"].to(dt)), g, "expert_in")  # [E, G*C, d]
    if shards is not None:
        ye = shards.local(ye, {0: 1})
    ye = ye.reshape(e, g_l, cap, d).transpose(0, 1).reshape(g_l, e * cap, d)

    # ---- combine (un-sort + gate-weighted sum over the k slots) ----------------
    y_s = ye[gidx, torch.clamp_max(slot, e * cap - 1)]
    y_s = y_s * (gates_s * in_cap)[:, :, None].to(dt)
    flat = (gidx * s + tok_s).reshape(-1)
    y = x.new_zeros((g_l * s, d)).index_add(0, flat, y_s.reshape(-1, d))
    y = y.reshape(g_l, s, d)
    if shards is not None:
        y = shards.mesh_tensor(y)
    return shard(y, "batch", "seq", "act_embed"), aux
