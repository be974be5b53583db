"""Backend-dispatching wrappers around the CUDA kernels.

``impl`` selects the execution path, as in ``repro.kernels.ops``:
  * "ref"   — the plain PyTorch oracle (``ref.py``), on whatever device
              the tensors are on.  ``chip_smoke.py`` holds the kernels
              against it on the card this way.
  * "cuda"  — the kernel (the reference's unfused "pallas" path).
  * "fused" — the kernel; for ``nttd_decode_tile`` the one-launch decode.
  * "auto"  — the kernel.
Every name but "ref" goes to the kernel's wrapper, which launches the
kernel on a CUDA tensor or raises, and runs the plain version on a CPU
tensor.  So "auto" and "fused" resolve by the tensors' device.  No path
falls back from the kernel to the plain version.

``launch_counts`` / ``reset_launch_counts`` read and clear the wrappers'
launch counters.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_tile as _dt
from repro_torch.kernels import lstm as _lstm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tt_contract as _tt

IMPLS = ("ref", "cuda", "fused", "auto")
_KERNELS = {"decode_tile": _dt, "lstm_scan": _lstm, "tt_contract": _tt}


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of {IMPLS}")


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def tt_contract(
    first: torch.Tensor, mid: torch.Tensor, last: torch.Tensor, *, impl: str = "auto"
) -> torch.Tensor:
    _check_impl(impl)
    if impl == "ref":
        return _ref.tt_contract(first, mid, last)
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
    _check_impl(impl)
    if impl == "ref":
        return _ref.lstm_scan(x, wi, wh, b)
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
    """
    _check_impl(impl)
    if idx.shape[0] == 0:
        return torch.zeros((0,), dtype=emb.dtype, device=idx.device)
    heads = (w_first, b_first, w_mid, b_mid, w_last, b_last)
    if impl == "ref":
        return _ref.nttd_decode_tile(idx, emb, wi, wh, b, *heads)
    return _dt.decode_tile(idx, emb, wi, wh, b, *heads)
