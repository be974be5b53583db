"""Plain PyTorch versions of every CUDA kernel in this package, and the
LM's attention oracles.

Each wrapper (``decode_tile``, ``lstm``, ``tt_contract``, ``attention``)
runs its plain version here for a tensor on the CPU, and ``chip_smoke.py``
holds each kernel against it on the card.  They are ports of
``repro.kernels.ref``: every function computes in f32 whatever the input
dtype and casts the result back, as the kernels do.  ``flash_attention``
is the flash kernel's plain version; ``mha_attention`` and
``mha_attention_chunked`` are the oracles the LM's ``ref`` route runs.
The backward kernels' plain versions (``lstm_scan_bwd``,
``tt_contract_bwd``) are autograd of the plain forwards, as the
reference's gradients are ``jax.grad`` of its oracles.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

F32 = torch.float32


def tt_contract(first: torch.Tensor, mid: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Chain product  T1 @ T2 @ ... @ Td  per batch element.

    first: [B, R]; mid: [B, K, R, R] (K may be 0); last: [B, R] -> [B]
    in ``first.dtype``.  Contracted in f32 like the kernel (the JAX oracle
    contracts in the input dtype; the two agree exactly in f32).
    """
    v = first.to(F32)
    midf = mid.to(F32)
    for k in range(mid.shape[1]):
        v = torch.einsum("br,brs->bs", v, midf[:, k])
    return (v * last.to(F32)).sum(-1).to(first.dtype)


def tt_contract_unrolled(first: torch.Tensor, mid: torch.Tensor,
                         last: torch.Tensor) -> torch.Tensor:
    """``tt_contract`` with the K loop unrolled, the route of
    ``impl="ref_unrolled"``.  The reference unrolls it so that XLA fuses
    the chain instead of running a while loop; eager PyTorch already runs
    the loop in Python, so the two plain versions are the same
    computation."""
    return tt_contract(first, mid, last)


def lstm_scan(
    x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Single-layer LSTM over a short sequence.

    x: [B, T, H]; wi, wh: [H, 4H]; b: [4H] -> hidden states [B, T, H] in
    ``x.dtype``.  Gate layout along 4H is (i, f, g, o); carries and gate
    math run in f32 regardless of ``x.dtype``.
    """
    bsz, t_steps, hid = x.shape
    xf, wif, whf, bf = (a.to(F32) for a in (x, wi, wh, b))
    h = torch.zeros((bsz, hid), dtype=F32, device=x.device)
    c = torch.zeros((bsz, hid), dtype=F32, device=x.device)
    outs = []
    for t in range(t_steps):
        gates = xf[:, t] @ wif + h @ whf + bf
        i, f, g, o = torch.split(gates, hid, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    if not outs:
        return torch.empty((bsz, 0, hid), dtype=x.dtype, device=x.device)
    return torch.stack(outs, dim=1).to(x.dtype)


def lstm_unrolled(
    x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """``lstm_scan`` with the time loop unrolled, the route of
    ``impl="ref_unrolled"``: as ``tt_contract_unrolled``, the same
    computation as the plain version, whose loop is already Python's."""
    return lstm_scan(x, wi, wh, b)


def _grad_of(fn, inputs: tuple[torch.Tensor, ...], dout: torch.Tensor):
    """Gradients of ``fn(*inputs)`` against ``dout``, w.r.t. every input
    (zeros for an input the output does not reach: mid when K == 0)."""
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_() for t in inputs)
        grads = torch.autograd.grad(fn(*leaves), leaves, dout, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads))


def tt_contract_bwd(
    first: torch.Tensor, mid: torch.Tensor, last: torch.Tensor, dout: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the ``tt_contract`` backward kernel: autograd of
    ``tt_contract`` -> (dfirst [B, R], dmid [B, K, R, R], dlast [B, R])."""
    return _grad_of(tt_contract, (first, mid, last), dout)


def lstm_scan_bwd(
    x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor, dhs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the ``lstm_scan`` backward kernel: autograd of
    ``lstm_scan`` against ``dhs`` [B, T, H] -> (dx, dwi, dwh, db)."""
    return _grad_of(lstm_scan, (x, wi, wh, b), dhs)


def nttd_decode_tile(
    idx: torch.Tensor,
    emb: torch.Tensor,
    wi: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    w_first: torch.Tensor,
    b_first: torch.Tensor,
    w_mid: torch.Tensor,
    b_mid: torch.Tensor,
    w_last: torch.Tensor,
    b_last: torch.Tensor,
) -> torch.Tensor:
    """Oracle for ``decode_tile.decode_tile``: embedding gather -> T-step
    LSTM -> first/mid/last head projections -> R-wide chain contraction.

    idx: [B, T] int folded indices; emb: [T, M, H] stacked per-step tables
    (zero-padded to M rows).  An index outside [0, M) gathers a zero row,
    as the reference kernel's one-hot gather does.  Returns [B] in
    ``emb.dtype``; all math in f32, the chain contracted step-interleaved.
    """
    bsz, t_steps = idx.shape
    if t_steps < 2:
        raise ValueError(f"nttd_decode_tile needs T >= 2 steps, got {t_steps}")
    rank = b_first.shape[0]
    m_rows, hid = emb.shape[1], emb.shape[2]
    embf, wif, whf, bf = (a.to(F32) for a in (emb, wi, wh, b))
    idx = idx.long()
    valid = (idx >= 0) & (idx < m_rows)
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    h = torch.zeros((bsz, hid), dtype=F32, device=idx.device)
    c = torch.zeros((bsz, hid), dtype=F32, device=idx.device)
    v = out = None
    for t in range(t_steps):
        xt = embf[t][safe[:, t]] * valid[:, t, None]  # [B, H]
        gates = xt @ wif + h @ whf + bf
        i = torch.sigmoid(gates[:, :hid])
        f = torch.sigmoid(gates[:, hid : 2 * hid])
        g = torch.tanh(gates[:, 2 * hid : 3 * hid])
        o = torch.sigmoid(gates[:, 3 * hid :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        if t == 0:
            v = h @ w_first.to(F32) + b_first.to(F32)
        elif t == t_steps - 1:
            last = h @ w_last.to(F32) + b_last.to(F32)
            out = (v * last).sum(-1)
        else:
            mid = (h @ w_mid.to(F32) + b_mid.to(F32)).reshape(bsz, rank, rank)
            v = (v[:, :, None] * mid).sum(1)
    return out.to(emb.dtype)


# ----------------------------------------------------------------------------
# Causal GQA attention (LM serving path)
# ----------------------------------------------------------------------------
NEG_INF = -1e30  # the flash kernel's masked-score sentinel (repro.kernels.attention)


def mha_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_len: torch.Tensor | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Grouped-query attention oracle.

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0] (decode: cache length so far).
    ``kv_len``: optional [B] valid kv lengths (entries beyond are masked).
    Softmax in f32; masked logits are f32's lowest value, so a fully
    masked row is a uniform softmax.  Output in ``q.dtype``.

    ``return_lse=True`` returns ``(out, lse)`` instead, for combining the
    attention of several pieces of one kv sequence (flash-decode): ``out``
    in f32, not cast, and ``lse`` [B, Sq, Hq], the log-sum-exp of each
    row's scaled, unmasked scores.  A row with no unmasked position has
    ``lse = -inf`` and an output of 0, so it weighs nothing in the
    combination.  Every other row's output is the same as without the
    flag, before the cast.
    """
    bq, sq, hq, dim = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.to(F32) / torch.sqrt(torch.tensor(dim, dtype=F32))
    qg = qf.reshape(bq, sq, hkv, group, dim)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(F32))
    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        mask = (qpos[:, None] >= kpos[None, :])[None, None, None]
    if kv_len is not None:
        valid = torch.arange(skv, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
        valid = valid[:, None, None, None, :]
        mask = valid if mask is None else mask & valid
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(F32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(F32))
    if not return_lse:
        return out.reshape(bq, sq, hq, dim).to(q.dtype)
    lse = torch.logsumexp(logits, dim=-1)  # [B, Hkv, G, Sq]
    if mask is not None:
        empty = ~mask.expand(bq, 1, 1, sq, skv).any(-1)  # [B, 1, 1, Sq]
        lse = lse.masked_fill(empty, -torch.inf)
        out = out.masked_fill(empty.permute(0, 3, 1, 2)[..., None], 0.0)
    return (out.reshape(bq, sq, hq, dim),
            lse.permute(0, 3, 1, 2).reshape(bq, sq, hq))


def mha_attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """Memory-bounded exact attention: ``mha_attention`` over q chunks,
    each rematerialised.

    The [B, H, chunk, Skv] score block is the peak transient instead of
    [B, H, Sq, Skv], in the backward pass too: with autograd on, each full
    chunk runs under a non-reentrant ``torch.utils.checkpoint``, which
    keeps only the chunk's inputs and recomputes its scores and
    probabilities when its gradient is taken, as the reference wraps its
    scan body in ``jax.checkpoint``.  A ragged tail (Sq % chunk) is
    attended as its own chunk, outside the checkpoint, as in the
    reference.  The output is the same with autograd on or off.
    """
    sq = q.shape[1]
    if sq <= chunk:
        return mha_attention(q, k, v, causal=causal, q_offset=q_offset)
    aligned = sq - sq % chunk
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for s in range(0, aligned, chunk):
        fn = functools.partial(mha_attention, causal=causal, q_offset=q_offset + s)
        qc = q[:, s : s + chunk]
        outs.append(torch.utils.checkpoint.checkpoint(
            fn, qc, k, v, use_reentrant=False, preserve_rng_state=False)
            if remat else fn(qc, k, v))
    if aligned < sq:
        outs.append(mha_attention(q[:, aligned:], k, v, causal=causal,
                                  q_offset=q_offset + aligned))
    return torch.cat(outs, dim=1)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """Plain version of the flash kernel (``attention.flash_attention``).

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D], already padded to the tile.
    Computes the kernel's function, not the oracle's: q is scaled by
    1/sqrt(D) in f32 before the product, masked scores (columns >=
    ``kv_valid``; when ``causal``, qpos + q_offset < kpos) are the -1e30
    sentinel, and the softmax is taken over the whole padded kv grid.  A
    row whose every column is masked therefore gets p = 1 everywhere and
    becomes the mean of v over all Skv columns (the ``l == 0`` guard of the
    kernel never fires).  Output in ``q.dtype``.
    """
    bq, sq, hq, dim = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = (q.to(F32) * (1.0 / dim**0.5)).reshape(bq, sq, hkv, group, dim)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(F32))
    kpos = torch.arange(skv, device=q.device)
    keep = None
    if causal:
        qpos = torch.arange(sq, device=q.device)
        keep = qpos[:, None] + q_offset >= kpos[None, :]
    if kv_valid is not None:
        pad_keep = (kpos < kv_valid)[None, :]
        keep = pad_keep if keep is None else keep & pad_keep
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(F32)) / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(bq, sq, hq, dim).to(q.dtype)
