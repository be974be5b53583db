"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embedding/unembedding.

Port of ``repro.models.layers``.  Plain functions over a params dict that
mirrors the JAX tree key for key.  Compute runs in ``compute_dtype``;
norms, rotary angles and the loss accumulate in f32.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import ParamSpec, Shards, is_dtensor, matmul, shard

F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_spec(d: int, stacked: tuple[int, ...] = ()) -> ParamSpec:
    lead = tuple("layers" for _ in stacked)
    return ParamSpec(stacked + (d,), lead + ("act_embed",), init="ones")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [S] or [B, S] absolute positions."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device) / half))
    ang = positions[..., None].to(F32) * freqs  # [S, half] or [B, S, half]
    if ang.ndim == 2:  # [S, half] -> broadcast over batch
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]  # [B_or_1, S, 1, half]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_specs(d: int, f: int, stacked: tuple[int, ...] = ()) -> dict:
    lead = tuple("layers" for _ in stacked)
    return {
        "w_gate": ParamSpec(stacked + (d, f), lead + ("ffn_in", "mlp")),
        "w_up": ParamSpec(stacked + (d, f), lead + ("ffn_in", "mlp")),
        "w_down": ParamSpec(stacked + (f, d), lead + ("mlp", "ffn_in")),
    }


def mlp(p: dict, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    h = matmul(x, p["w_gate"].to(compute_dtype))
    u = matmul(x, p["w_up"].to(compute_dtype))
    h = shard(torch.nn.functional.silu(h) * u, "batch", "seq", "mlp")
    return matmul(h, p["w_down"].to(compute_dtype))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
VOCAB_PAD = 128  # Megatron-style: pad vocab so TP always divides


def padded_vocab(vocab: int) -> int:
    return ((vocab + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def embed_specs(vocab: int, d: int, tie: bool) -> dict:
    pv = padded_vocab(vocab)
    out = {"embed": ParamSpec((pv, d), ("vocab", "embed"), init="embed")}
    if not tie:
        out["unembed"] = ParamSpec((d, pv), ("embed", "vocab"))
    return out


def embed_lookup(p: dict, tokens: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    # gather the rows, then cast them: the same values as casting the whole
    # [vocab, d] table first, as the reference does
    if is_dtensor(p["embed"]):
        return _embed_lookup_on_mesh(p["embed"], tokens).to(compute_dtype)
    return p["embed"][tokens].to(compute_dtype)


def _embed_lookup_on_mesh(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The gather from a vocab-sharded ``DTensor`` table.  DTensor's own
    rules fail here: a gather from the sharded table makes a MaskPartial
    whose backward fails, and from a replicated table the gradient's
    ``index_put`` has no working rule on every torch release.  So the table
    is replicated (an all-gather of it, and a reduce-scatter of its
    gradient: the simplest exact route; a masked local gather plus an
    all-reduce would move only the rows) and each rank gathers its own
    tokens' rows (``dist.sharding.Shards``): the rows keep the tokens'
    split, and the table's gradient sums over it."""
    mesh = table.device_mesh
    if is_dtensor(tokens):
        split = tuple(p.dim if p.is_shard() else None for p in tokens.placements)
        tokens = tokens.to_local()
    else:  # a plain tensor under a mesh is the same on every rank
        split = (None,) * mesh.ndim
    shards = Shards(mesh, split)
    return shards.mesh_tensor(shards.weight(table)[tokens])


def unembed(p: dict, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    if "unembed" in p:
        w = p["unembed"].to(compute_dtype)
    else:
        w = p["embed"].to(compute_dtype).T
    return shard(matmul(x, w), "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_xent(
    logits: torch.Tensor, labels: torch.Tensor, valid_vocab: int | None = None
) -> torch.Tensor:
    """Mean token cross-entropy; logits promoted to f32.  ``valid_vocab``
    masks padded vocabulary columns out of the partition function.
    ``DTensor`` logits run vocab-parallel (``_xent_on_mesh``)."""
    if is_dtensor(logits):
        return _xent_on_mesh(logits, labels, valid_vocab)
    logits = logits.to(F32)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        mask = torch.arange(logits.shape[-1], device=logits.device) < valid_vocab
        logits = torch.where(mask, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def _xent_on_mesh(logits: torch.Tensor, labels: torch.Tensor,
                  valid_vocab: int | None) -> torch.Tensor:
    """``softmax_xent`` of ``DTensor`` logits [B, S, V], on each rank's
    plain shard (``Shards``; DTensor's own rules clone a vocab-wide
    gradient in the backward): Megatron's vocab-parallel cross-entropy.
    The labels are laid out as the logits' batch and sequence.  The loss
    comes back replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = logits.device_mesh
    logits = logits.redistribute(mesh, [Replicate() if p.is_partial() else p
                                        for p in logits.placements])
    shards = Shards(mesh, tuple(p.dim if p.is_shard() else None for p in logits.placements))
    if not is_dtensor(labels):  # a plain tensor under a mesh is the same on every rank
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    loss = _VocabParallelXent.apply(shards.local(logits), shards.local(labels, {2: None}),
                                    shards, logits.shape, valid_vocab)
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim, run_check=False)


class _VocabParallelXent(torch.autograd.Function):
    """The mean cross-entropy of the [B, S, V] logits of which ``x`` is this
    rank's shard (``shards``' split), ``labels`` its batch and sequence
    shard of the labels.  Forward: the local max, then an all-reduce (max)
    over the mesh dims that split the vocabulary; the local sum of
    ``exp(x - max)``, then an all-reduce (sum); the gold logit, read on the
    rank whose columns hold the label, then an all-reduce (sum); the sum of
    the tokens' losses over the mesh dims that split batch and sequence,
    over B * S.  Columns from ``valid_vocab`` on (global index) are masked
    to -1e30 as in the plain path.  Backward: ``(softmax - onehot) / (B *
    S)`` on the local shard alone, with no collective and no vocab-wide
    tensor."""

    @staticmethod
    def forward(ctx, x, labels, shards, shape, valid_vocab):
        import torch.distributed as dist

        cols, idx, hit = _local_columns(x, labels, shards, shape[-1], valid_vocab)
        xf = x.to(F32)
        if cols is not None:
            xf = torch.where(cols, xf, -1e30)
        top = shards.all_reduce(xf.amax(-1), dist.ReduceOp.MAX, 2)
        z = shards.all_reduce(torch.exp(xf - top[..., None]).sum(-1), dist.ReduceOp.SUM, 2)
        logz = top + torch.log(z)
        gold = torch.gather(xf, -1, idx[..., None])[..., 0]
        gold = shards.all_reduce(torch.where(hit, gold, 0.0), dist.ReduceOp.SUM, 2)
        total = (logz - gold).sum()
        for d in (0, 1):
            shards.all_reduce(total, dist.ReduceOp.SUM, d)
        ctx.save_for_backward(x, labels, logz)
        ctx.shards, ctx.shape, ctx.valid_vocab = shards, shape, valid_vocab
        return total / (shape[0] * shape[1])

    @staticmethod
    def backward(ctx, g):
        x, labels, logz = ctx.saved_tensors
        cols, idx, hit = _local_columns(x, labels, ctx.shards, ctx.shape[-1], ctx.valid_vocab)
        grad = x.to(F32, copy=True).sub_(logz[..., None]).exp_()
        if cols is not None:
            grad.masked_fill_(~cols, 0.0)
        grad.scatter_add_(-1, idx[..., None], -hit.to(F32)[..., None])
        grad.mul_(g / (ctx.shape[0] * ctx.shape[1]))
        return grad.to(x.dtype), None, None, None, None


def _local_columns(x, labels, shards, vocab: int, valid_vocab: int | None):
    """(the valid-column mask of the local shard, or None where every column
    is valid; each label's local column, clamped into the shard; whether the
    shard holds it)."""
    start = shards.start(2, vocab)
    cols = None
    if valid_vocab is not None and valid_vocab < vocab:
        cols = torch.arange(start, start + x.shape[-1], device=x.device) < valid_vocab
    local = labels.long() - start
    hit = (local >= 0) & (local < x.shape[-1])
    return cols, local.clamp(0, x.shape[-1] - 1), hit
