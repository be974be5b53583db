"""Wrapper of the LSTM scan kernel (``csrc/lstm.cu``), forward only.

Counterpart of ``repro.kernels.lstm``.  On a CUDA tensor it launches the
hand-written kernel on the current stream or raises; on a CPU tensor it
runs the plain version ``ref.lstm_scan``.  ``launches`` counts kernel
launches, nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (
    DTYPE_CODES,
    check_cuda_operands,
    check_shape,
    check_smem,
)

THREADS = 64  # kLstmThreads in csrc/lstm.cu
launches = 0


def lstm_scan(
    x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """x: [B, T, H], wi: [H, 4H], wh: [H, 4H], b: [4H] -> hs [B, T, H]
    in ``x.dtype``."""
    global launches
    if x.device.type == "cpu":
        return ref.lstm_scan(x, wi, wh, b)
    lib = _build.library()
    bsz, t_steps, hid = x.shape
    device = check_cuda_operands(
        "lstm_scan", {"x": x, "wi": wi, "wh": wh, "b": b}, x.dtype
    )
    check_shape("lstm_scan", "wi", wi, (hid, 4 * hid))
    check_shape("lstm_scan", "wh", wh, (hid, 4 * hid))
    check_shape("lstm_scan", "b", b, (4 * hid,))
    check_smem("lstm_scan", THREADS, 4 * hid)
    out = torch.empty_like(x)
    if bsz == 0 or t_steps == 0:
        return out
    with torch.cuda.device(device):
        err = lib.repro_lstm_scan(
            x.data_ptr(), wi.data_ptr(), wh.data_ptr(), b.data_ptr(), out.data_ptr(),
            bsz, t_steps, hid, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, "lstm_scan", err)
    launches += 1
    return out
