"""Plain PyTorch oracles for every CUDA kernel in this package.

Each wrapper (``decode_tile``, ``lstm``, ``tt_contract``) runs the function
of the same name here for a tensor on the CPU, and ``chip_smoke.py``
holds each kernel against it on the card.  They are ports of
``repro.kernels.ref``: every function computes in f32 whatever the input
dtype and casts the result back, as the kernels do.
"""
from __future__ import annotations

import torch

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
