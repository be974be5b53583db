"""Mamba2 block (state-space duality, arXiv:2405.21060), port of
``repro.models.mamba``.

Training and prefill use the chunked SSD parallel form: the sequence is
split into chunks of Q tokens; within a chunk the output is a masked
quadratic "attention" with cumulative decay weights, and the inter-chunk
recurrence is a short loop over chunk states (S/Q steps).  Decode is the
exact recurrence on the [B, H, P, N] state.

Block structure (in_proj -> causal conv -> SSD -> gated RMSNorm ->
out_proj) follows the reference, with its cast points: the intra-chunk
weights cast to the compute dtype, the state and inter-chunk products and
the SSM state in f32.  The conv state carries the last (k-1) inputs of the
conv (pre-conv ``xbc``) for decode.  A prompt shorter than k-1 tokens
leaves the conv state left-padded with zeros, the causal conv's own
padding, so decode continues it exactly (the reference slices fewer than
k-1 rows there and its next decode step fails: ROADMAP C.8).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (ParamSpec, Shards, batch_shards, is_dtensor, matmul,
                                       on_batch_shards, shard)
from repro_torch.models import layers

F32 = torch.float32


def dims(cfg: ModelConfig) -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "d_in": d_in,
        "n_heads": n_heads,
        "conv_dim": conv_dim,
        "proj_out": 2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + n_heads,
    }


def mamba_specs(cfg: ModelConfig, stacked: tuple[int, ...] = ()) -> dict:
    d = dims(cfg)
    lead = tuple("layers" for _ in stacked)
    return {
        # in_proj packs [z (d_in), x (d_in), B (G*N), C (G*N), dt (H)]
        "in_proj": ParamSpec(
            stacked + (cfg.d_model, d["proj_out"]), lead + ("ffn_in", "ssm_inner")
        ),
        "conv_w": ParamSpec(
            stacked + (cfg.ssm_conv, d["conv_dim"]), lead + ("conv_k", "ssm_inner")
        ),
        "conv_b": ParamSpec(stacked + (d["conv_dim"],), lead + ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec(stacked + (d["n_heads"],), lead + ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec(stacked + (d["n_heads"],), lead + ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec(stacked + (d["n_heads"],), lead + ("ssm_heads",), init="zeros"),
        "norm_w": ParamSpec(stacked + (d["d_in"],), lead + ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec(
            stacked + (d["d_in"], cfg.d_model), lead + ("ssm_inner", "ffn_in")
        ),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    d = dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state
    z, xbc, dt = torch.split(proj, [d["d_in"], d["d_in"] + 2 * gn, d["n_heads"]], dim=-1)
    return z, xbc, dt  # xbc = [x, B, C] goes through the conv


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    d = dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state
    return torch.split(xbc, [d["d_in"], gn, gn], dim=-1)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros appended along dim 1 of a [B, S, ...] tensor."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)


def _ssd_chunked(
    x: torch.Tensor,   # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (post-softplus, f32)
    a: torch.Tensor,   # [H] negative decay rates
    b: torch.Tensor,   # [B, S, G, N]
    c: torch.Tensor,   # [B, S, G, N]
    cfg: ModelConfig,
    h0: torch.Tensor | None = None,  # [B, H, P, N] initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y [B,S,H,P], final state [B,H,P,N] f32)."""
    bs, s_in, nh, hp = x.shape
    g = b.shape[2]
    q = min(cfg.ssm_chunk, s_in)
    pad = (-s_in) % q
    if pad:
        # dt=0 on padding: zero state contribution AND unit decay, so the
        # final state is exact; padded outputs are sliced off below.
        x, dt, b, c = (_pad_seq(t, pad) for t in (x, dt, b, c))
    s = s_in + pad
    nc = s // q
    rep = nh // g

    # chunk views; each group's B and C repeated in place over its heads
    xc = x.reshape(bs, nc, q, nh, hp)
    dtc = dt.reshape(bs, nc, q, nh)
    bc = b.reshape(bs, nc, q, g, -1).repeat_interleave(rep, dim=3)   # [B,NC,Q,H,N]
    cc = c.reshape(bs, nc, q, g, -1).repeat_interleave(rep, dim=3)

    da = dtc * a                                       # [B,NC,Q,H] log-decay
    cums = torch.cumsum(da, dim=2)                     # within-chunk cumulative

    # ---- intra-chunk (quadratic with decay mask) ----------------------------
    # L[i,j] = exp(cums_i - cums_j) for i >= j else 0, the mask inside the
    # exp too: for i < j the difference is positive and can overflow, and
    # the gradient of the outer where alone would carry the overflow (NaN)
    rel = cums[:, :, :, None, :] - cums[:, :, None, :, :]      # [B,NC,Qi,Qj,H]
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    l_mask = torch.where(causal, torch.exp(torch.where(causal, rel, 0.0)), 0.0)
    scores = torch.einsum("bnihd,bnjhd->bnijh", cc, bc)        # C_i . B_j
    w = scores * l_mask * dtc[:, :, None, :, :]                # weight x_j by dt_j
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", w.to(x.dtype), xc)

    # ---- chunk summary states -------------------------------------------------
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)        # [B,NC,Q,H]
    state_contrib = torch.einsum(
        "bnqhd,bnqhp->bnhpd",
        bc.to(F32),
        xc.to(F32) * (decay_to_end * dtc)[..., None],
    )  # [B,NC,H,P,N]
    chunk_decay = torch.exp(torch.sum(da, dim=2))              # [B,NC,H]

    # ---- inter-chunk recurrence (loop over chunks) ----------------------------
    h = h0.to(F32) if h0 is not None else x.new_zeros((bs, nh, hp, b.shape[-1]), dtype=F32)
    h_enter = []
    for n in range(nc):
        h_enter.append(h)  # the state *entering* chunk n
        h = h * chunk_decay[:, n, :, None, None] + state_contrib[:, n]
    h_enter = torch.stack(h_enter, dim=1)                      # [B,NC,H,P,N]

    # ---- inter-chunk output ------------------------------------------------------
    decay_from_start = torch.exp(cums)                         # [B,NC,Q,H]
    y_inter = torch.einsum("bnqhd,bnhpd->bnqhp", cc.to(F32), h_enter)
    y_inter = y_inter * decay_from_start[..., None]
    y = (y_intra.to(F32) + y_inter).reshape(bs, s, nh, hp)
    if pad:
        y = y[:, :s_in]
    return y.to(x.dtype), h


def _ssd_on_shards(x, dt, a, b, c, cfg: ModelConfig):
    """``_ssd_chunked`` of ``DTensor`` operands on each rank's shard: the
    SSD is independent per sequence and per head, so the mesh dims that
    split x's batch or heads keep their split (dt and a alike; each
    group's B and C repeated over its heads, then split alike) and every
    other one is replicated.  DTensor's own rules for the chunked einsums
    fail on some torch releases."""
    shards = Shards(x.device_mesh, tuple(p.dim if p.is_shard() and p.dim in (0, 2) else None
                                         for p in x.placements))
    rows = batch_shards(b)
    rep = x.shape[2] // b.shape[2]

    def per_head(t):  # [B, S, G, N] -> this rank's [B, S, H, N] shard
        return shards.local(rows.mesh_tensor(rows.local(t).repeat_interleave(rep, dim=2)))

    y, h = _ssd_chunked(shards.local(x), shards.local(dt), shards.local(a, {0: None, 2: 0}),
                        per_head(b), per_head(c), cfg)
    return shards.mesh_tensor(y), shards.mesh_tensor(h, {2: 1})


def _readout(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The decode's y [B, H, P] = h [B, H, P, N] . c [B, H, N]; ``DTensor``s
    on each rank's shard of the batch and heads (the product flattens
    both, which DTensor refuses where both are split)."""
    if not is_dtensor(h):
        return (h @ c[:, :, :, None])[..., 0]
    shards = Shards(h.device_mesh, tuple(p.dim if p.is_shard() and p.dim in (0, 1) else None
                                         for p in h.placements))
    return shards.mesh_tensor(_readout(shards.local(h), shards.local(c)))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, C] with kernel [K, C]; a
    ``DTensor`` xbc on each rank's batch shard."""
    if is_dtensor(xbc):
        return on_batch_shards(_causal_conv, xbc, w, b)
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def _conv_tail(xbc: torch.Tensor, k: int) -> torch.Tensor:
    """The last k-1 conv inputs of [B, S, C], zeros before the first; a
    ``DTensor`` xbc on each rank's batch shard."""
    if is_dtensor(xbc):
        return on_batch_shards(lambda t: _conv_tail(t, k), xbc)
    s = xbc.shape[1]
    if s < k - 1:
        xbc = F.pad(xbc, (0, 0, k - 1 - s, 0))
    return xbc[:, xbc.shape[1] - (k - 1):, :]


def mamba_forward(
    p: dict,
    xin: torch.Tensor,  # [B, S, d_model]
    cfg: ModelConfig,
    state: dict | None = None,  # decode: {'conv': [B,K-1,convdim], 'ssm': [B,H,P,N]}
) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward (train/prefill: state=None -> chunked SSD) or
    single-step decode (state given, S must be 1).  Returns (out, new state)."""
    dt_c = xin.dtype
    d = dims(cfg)
    proj = matmul(xin, p["in_proj"].to(dt_c))
    z, xbc, dt_raw = _split_proj(proj, cfg)
    a = -torch.exp(p["a_log"].to(F32))
    bs = xin.shape[0]

    if state is None:
        s = xin.shape[1]
        conv_out = _causal_conv(xbc, p["conv_w"].to(dt_c), p["conv_b"].to(dt_c))
        x, b, c = _split_xbc(conv_out, cfg)
        x = shard(x.reshape(bs, s, d["n_heads"], cfg.ssm_head_dim),
                  "batch", "seq", "ssm_heads", "ssm_head_dim")
        b = b.reshape(bs, s, cfg.ssm_groups, cfg.ssm_state)
        c = c.reshape(bs, s, cfg.ssm_groups, cfg.ssm_state)
        dt = F.softplus(dt_raw.to(F32) + p["dt_bias"].to(F32))
        ssd = _ssd_on_shards if is_dtensor(x) else _ssd_chunked
        y, h_final = ssd(x, dt, a, b, c, cfg)
        y = y + x * p["d_skip"].to(dt_c)[:, None]
        y = y.reshape(bs, s, d["d_in"])
        new_state = {"conv": _conv_tail(xbc, cfg.ssm_conv).to(dt_c), "ssm": h_final}
    else:
        # ---- exact recurrence, one token ------------------------------------
        conv_in = torch.cat([state["conv"].to(dt_c), xbc], dim=1)
        w = p["conv_w"].to(dt_c)
        conv_out = sum(conv_in[:, i : i + 1, :] * w[i] for i in range(cfg.ssm_conv))
        conv_out = F.silu(conv_out + p["conv_b"].to(dt_c))
        x, b, c = _split_xbc(conv_out, cfg)
        x = x.reshape(bs, d["n_heads"], cfg.ssm_head_dim).to(F32)
        rep = d["n_heads"] // cfg.ssm_groups
        bh = b.reshape(bs, cfg.ssm_groups, cfg.ssm_state).repeat_interleave(rep, dim=1).to(F32)
        ch = c.reshape(bs, cfg.ssm_groups, cfg.ssm_state).repeat_interleave(rep, dim=1).to(F32)
        dt = F.softplus(dt_raw[:, 0].to(F32) + p["dt_bias"].to(F32))  # [B,H]
        decay = torch.exp(dt * a)                                       # [B,H]
        h = state["ssm"] * decay[:, :, None, None] + (
            (x * dt[:, :, None])[:, :, :, None] * bh[:, :, None, :])
        y = _readout(h, ch)                                             # [B,H,P]
        y = y + x * p["d_skip"].to(F32)[:, None]
        y = y.reshape(bs, 1, d["d_in"]).to(dt_c)
        new_state = {"conv": conv_in[:, 1:, :].to(dt_c), "ssm": h}

    # gated RMSNorm + out_proj
    y = layers.rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return matmul(y, p["out_proj"].to(dt_c)), new_state


def state_specs(cfg: ModelConfig, batch: int, stacked: tuple[int, ...] = ()) -> dict:
    d = dims(cfg)
    lead = tuple("layers" for _ in stacked)
    return {
        "conv": ParamSpec(
            stacked + (batch, cfg.ssm_conv - 1, d["conv_dim"]),
            lead + ("batch", None, "ssm_inner"),
            init="zeros",
            dtype=layers.dtype_of(cfg.compute_dtype),
        ),
        "ssm": ParamSpec(
            stacked + (batch, d["n_heads"], cfg.ssm_head_dim, cfg.ssm_state),
            lead + ("batch", "ssm_heads", "ssm_head_dim", "ssm_state"),
            init="zeros",
            dtype=F32,
        ),
    }
