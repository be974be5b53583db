"""Checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# per-block dynamic shared memory a kernel may opt into on Hopper
MAX_SMEM_BYTES = 232_448


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


def threads_for_smem(name: str, floats_per_thread: int, most: int = 64) -> int:
    """Threads per block of a simt body whose threads each keep
    ``floats_per_thread`` f32 of state in shared memory: the most, up to
    ``most``, that fit a block's; raises when one thread's state does not."""
    fit = MAX_SMEM_BYTES // (4 * floats_per_thread)
    if fit < 1:
        raise ValueError(
            f"{name}: one thread's {4 * floats_per_thread} bytes of shared memory exceed "
            f"the {MAX_SMEM_BYTES} a Hopper block can have"
        )
    return min(most, fit)
