#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention kernel in f32
(``csrc/flash_attention.cu`` and its wrapper) at ``chip_smoke.py``'s f32
timing cases, on one GPU.

    python3 scripts/torch_flash.py [--root DIR] [--cases "B,S,H,D,X;..."]

``--root`` names a checkout whose ``src/repro_torch`` is timed (default:
the one holding this script), so two versions are compared on one card by
running the script once per checkout in one call, in the order A, B, B, A.
Per (B, S, H, D, qk_scale) of ``chip_smoke.FLASH_F32_SHAPES``, or of
``--cases`` (causal MHA, q, k and v f32 from ``torch.randn``, seed 0, q
and k times qk_scale), it prints ``chip_smoke.flash_f32_case``'s reading
(kernel, plain and SDPA ms, the bound and the FP32-FMA floor, errors
against the plain version element by element) as one JSON line, with
``kernel_ms`` and ``library_kernel_ms`` the device time of one call, the
median of ``REPEATS`` calls, each framed by idle host time and preceded by
a write of ``FLUSH_BYTES`` that evicts the 50 MB L2, every call of the run
in one ``torch.profiler`` session (``chip_smoke.device_kernels``), and
``device_ops``, the kernels of the flash call.

The last line is the card's name and power limit from ``nvidia-smi``.  It
exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPEATS = 5
FLUSH_BYTES = 256 << 20
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--cases", default=None,
                        help='"B,S,H,D,qk_scale;...": the cases to time')
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_flash: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    shapes = None if args.cases is None else [
        (*(int(v) for v in case.split(",")[:4]), float(case.split(",")[4]))
        for case in args.cases.split(";")]
    calls = smoke.flash_f32_calls(torch, torch.device("cuda"), shapes, seed=0)
    scratch = torch.empty(FLUSH_BYTES // 4, device="cuda")
    seen = smoke.device_kernels(torch, [fn for call in calls for key in ("kernel", "library")
                                        for _ in range(REPEATS)
                                        for fn in (scratch.zero_, call[key])], times=True)[1::2]

    def reading(n: int) -> tuple[float, list[str]]:
        profiled = seen[n * REPEATS:(n + 1) * REPEATS]
        ms = statistics.median(sum(us for _, us in ops) for ops in profiled) / 1e3
        return ms, [name for name, _ in profiled[0]]

    for n, call in enumerate(calls):
        kernel_ms, kernel_ops = reading(2 * n)
        library_ms, library_ops = reading(2 * n + 1)
        row = {"root": os.path.relpath(root, HERE),
               **smoke.flash_f32_case(torch, call, kernel_ms, library_ms, library_ops),
               "device_ops": [name[:80] for name in kernel_ops]}
        print(json.dumps(row), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
