"""Checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# per-block dynamic shared memory a kernel may opt into on Hopper
MAX_SMEM_BYTES = 232_448
SIMT_TILE_STEP = 8  # kSimtEntries in csrc/simt_tile.cuh: entries of a thread's tile


def check_cuda_operands(name: str, tensors: dict[str, torch.Tensor], dtype: torch.dtype):
    """Every operand on one CUDA device, contiguous, and of ``dtype``."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    device = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected a CUDA device")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, others on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")
    return device


def check_shape(name: str, key: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shape}")


def check_smem(name: str, threads: int, floats_per_thread: int) -> None:
    need = threads * floats_per_thread * 4
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: needs {need} bytes of shared memory per block, "
            f"more than the {MAX_SMEM_BYTES} a Hopper block can have"
        )


def simt_stage_floats(hid: int, rank: int = 0) -> int:
    """Floats of one weight stage of a simt body (``simt_stage_floats`` in
    ``csrc/simt_tile.cuh``): 16 gate rows of 4H, at most 8192, and at least
    one K row of every product."""
    return max(min(64 * hid, 8192), 4 * hid + 8, rank)


def largest_simt_tile(smem_bytes) -> int:
    """The largest multiple of ``SIMT_TILE_STEP`` entries whose block,
    ``smem_bytes(tile)`` bytes (affine in the tile), fits a block's shared
    memory; below ``SIMT_TILE_STEP`` when none does."""
    fixed = smem_bytes(0)
    return (MAX_SMEM_BYTES - fixed) // (smem_bytes(1) - fixed) // SIMT_TILE_STEP * SIMT_TILE_STEP
