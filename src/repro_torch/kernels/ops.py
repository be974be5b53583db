"""Backend-dispatching wrappers around the CUDA kernels.

``impl`` selects the execution path, as in ``repro.kernels.ops``:
  * "ref"     — the plain PyTorch oracle (``ref.py``), on whatever device
                the tensors are on.  ``chip_smoke.py`` holds the kernels
                against it on the card this way.
  * "ref_unrolled" — ``lstm_scan`` and ``tt_contract`` only: the oracles
                with their loops unrolled (``ref.lstm_unrolled``,
                ``ref.tt_contract_unrolled``), the same computation as "ref"
                in eager PyTorch.
  * "chunked" — ``attention`` only: the q-chunked oracle.
  * "cuda"    — the kernel (the reference's unfused "pallas" path).
  * "fused"   — the kernel; for ``nttd_decode_tile`` the one-launch decode.
  * "auto"    — the kernel.
Every name but "ref", "ref_unrolled" and "chunked" goes to the kernel's
wrapper, which launches the kernel on a CUDA tensor or raises, and runs
the plain version on a CPU tensor.  So "auto" and "fused" resolve by the tensors' device.
No path falls back from the kernel to the plain version: ``attention``
pads any length to the kernel's tile instead.

Gradients: on CUDA tensors ``lstm_scan`` and ``tt_contract`` are
``torch.autograd.Function``s whose backward passes are the hand-written
backward kernels (``lstm.lstm_scan_bwd``, ``tt_contract.tt_contract_bwd``);
the K == 0 row dot and every "ref" route are differentiated by autograd.
``nttd_decode_tile`` is forward only for every impl but "ref": asking it
for a gradient raises.

``launch_counts`` / ``reset_launch_counts`` read and clear the wrappers'
launch counters, the backward kernels' (``lstm_scan_bwd``,
``tt_contract_bwd``) included; the reset clears
``decode_tile.simt_launches``, ``lstm.simt_launches``,
``tt_contract.wide_launches`` and ``attention.tf32x3_launches`` too.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import attention as _attention
from repro_torch.kernels import decode_tile as _dt
from repro_torch.kernels import lstm as _lstm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tt_contract as _tt

IMPLS = ("ref", "cuda", "fused", "auto")
#: the impls of the unfused route's two kernels
SCAN_IMPLS = IMPLS + ("ref_unrolled",)
_KERNELS = {"decode_tile": _dt, "lstm_scan": _lstm, "tt_contract": _tt,
            "flash_attention": _attention}


def _check_impl(impl: str, impls: tuple[str, ...] = IMPLS) -> None:
    if impl not in impls:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of {impls}")


_BWD_KERNELS = {"lstm_scan_bwd": _lstm, "tt_contract_bwd": _tt}


def launch_counts() -> dict[str, int]:
    counts = {name: mod.launches for name, mod in _KERNELS.items()}
    counts.update({name: mod.bwd_launches for name, mod in _BWD_KERNELS.items()})
    return counts


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
    for mod in _BWD_KERNELS.values():
        mod.bwd_launches = 0
    _dt.simt_launches = _lstm.simt_launches = _tt.wide_launches = 0
    _attention.tf32x3_launches = 0


def tt_contract(
    first: torch.Tensor, mid: torch.Tensor, last: torch.Tensor, *, impl: str = "auto"
) -> torch.Tensor:
    _check_impl(impl, SCAN_IMPLS)
    if impl == "ref":
        return _ref.tt_contract(first, mid, last)
    if impl == "ref_unrolled":
        return _ref.tt_contract_unrolled(first, mid, last)
    if mid.shape[1] == 0:
        # degenerate 2-core chain: no mid tensor for the kernel; the
        # contraction is a plain row dot
        return (first.float() * last.float()).sum(-1).to(first.dtype)
    return _tt.tt_contract(first, mid, last)


def lstm_scan(
    x: torch.Tensor,
    wi: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    _check_impl(impl, SCAN_IMPLS)
    if impl == "ref":
        return _ref.lstm_scan(x, wi, wh, b)
    if impl == "ref_unrolled":
        return _ref.lstm_unrolled(x, wi, wh, b)
    return _lstm.lstm_scan(x, wi, wh, b)


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
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Fused NTTD decode of a [B, T] tile of folded indices -> [B] values.

    See ``decode_tile.decode_tile`` for the operand layout.  B == 0
    short-circuits to an empty tensor of ``emb.dtype``; T < 2 raises.

    Every non-empty call runs inside an ``obs.span("kernel_decode", impl=,
    b=)``, as in the reference.  It is a host span: on the card it times
    the launch's dispatch, not the kernel, and it never synchronises the
    device, so answers and timing are the same with tracing on or off.
    """
    _check_impl(impl)
    if idx.shape[0] == 0:
        return torch.zeros((0,), dtype=emb.dtype, device=idx.device)
    heads = (w_first, b_first, w_mid, b_mid, w_last, b_last)
    with obs.span("kernel_decode", impl=impl, b=int(idx.shape[0])):
        if impl == "ref":
            return _ref.nttd_decode_tile(idx, emb, wi, wh, b, *heads)
        operands = (idx, emb, wi, wh, b, *heads)
        if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
            return _ForwardOnlyDecode.apply(*operands)
        return _dt.decode_tile(*operands)


class _ForwardOnlyDecode(torch.autograd.Function):
    """The fused decode (``decode_tile.decode_tile``), which has no
    backward: a gradient asked of it raises instead of leaving the
    operands' gradients quietly unset."""

    @staticmethod
    def forward(ctx, *operands):
        return _dt.decode_tile(*operands)

    @staticmethod
    def backward(ctx, dout):
        raise RuntimeError(
            "nttd_decode_tile (the fused decode) is forward only; train through the "
            "unfused kernels (impl 'cuda'), whose lstm_scan and tt_contract have backward "
            "kernels"
        )


CHUNKED_THRESHOLD = 2048  # the oracle switches to q-chunked attention here


def _pad_seq(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[1]) % mult
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x.contiguous()


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_len: torch.Tensor | None = None,
    impl: str = "auto",
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Causal GQA attention, q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D].

    "ref"/"chunked" and any call with ``kv_len`` (decode) run the oracle,
    which turns q-chunked from Sq >= ``CHUNKED_THRESHOLD``.  Every other
    impl pads q and kv to the kernel's 128 tile, masks the padded kv
    columns with ``kv_valid``, runs the flash kernel's wrapper and slices
    the padded rows off.

    ``return_lse`` (with ``kv_len`` only) returns the oracle's ``(out,
    lse)``: ``out`` in f32 and each row's log-sum-exp, -inf where ``kv_len``
    leaves no position (``ref.mha_attention``).
    """
    _check_impl(impl, IMPLS + ("chunked",))
    if return_lse:
        if kv_len is None:
            raise ValueError("attention: return_lse needs kv_len (the decode route)")
        return _ref.mha_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                                  return_lse=True)
    if impl in ("ref", "chunked") or kv_len is not None:
        if kv_len is None and (impl == "chunked" or q.shape[1] >= CHUNKED_THRESHOLD):
            return _ref.mha_attention_chunked(q, k, v, causal=causal, q_offset=q_offset)
        return _ref.mha_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    sq, skv = q.shape[1], k.shape[1]
    kv_valid = skv if skv % _attention.TILE_KV else None
    out = _attention.flash_attention(
        _pad_seq(q, _attention.TILE_Q), _pad_seq(k, _attention.TILE_KV),
        _pad_seq(v, _attention.TILE_KV), causal=causal, q_offset=q_offset,
        kv_valid=kv_valid,
    )
    return out[:, :sq] if out.shape[1] != sq else out
