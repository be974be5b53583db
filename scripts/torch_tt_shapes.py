#!/usr/bin/env python3
"""Time the PyTorch port's TT chain contraction (``tt_contract``) over the
ranks the codec runs, on one GPU.

    python3 scripts/torch_tt_shapes.py [--root DIR]

``--root`` names a checkout whose ``src/repro_torch`` is timed (default:
the one holding this script), so two versions are compared on one card by
running the script once per checkout in one call, in the order A, B, B, A.

Per (B, K, R) in ``SHAPES`` and dtype (f32, bf16) it makes first [B, R],
mid [B, K, R, R] and last [B, R] on the card from seed 0 (mid scaled by
0.5 / sqrt(R), as the reference's tests) and prints one JSON line:

* ``ms``: ``ops.tt_contract(impl="cuda")``; CUDA events, mean of 20
  launches after 2 warm-ups; ``max_abs_err`` against the plain version on
  the card.
* ``bound_ms``, ``bound_by``, ``share``: first, mid and last read once and
  the output written once over 3.35 TB/s (``chip_smoke.tt_bytes``), and
  that bound over ``ms``.
* ``library_ms``: one ``torch.einsum`` over the whole chain (f32 only, 5
  launches), ``chip_smoke.py``'s yardstick.

Timing, bound and yardstick are ``chip_smoke.py``'s own, from the checkout
this script lies in.  The last line is the card's name and power limit
from ``nvidia-smi``.  It exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, K, R, where the repo runs it); K 8 is PEMS-SF's d' 10 less the two
# end cores; at R 128 B is cut so that mid stays 4.3 GB in f32
SHAPES = (
    (65_536, 8, 8, "chip_smoke.py's timing shape, the default rank"),
    (65_536, 8, 16, "fleet/repair.py refit"),
    (65_536, 8, 32, "a register decode bucket's rank"),
    (65_536, 8, 34, "the budget rule at 1 MB (PEMS-SF, Uber)"),
    (65_536, 8, 57, "the budget rule at 4 MB"),
    (8_192, 8, 128, "the budget rule's largest rank"),
)


def measure(torch, smoke, b: int, k: int, r: int, dtype) -> dict:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    first = torch.randn((b, r), generator=gen, device="cuda").to(dtype)
    mid = (torch.randn((b, k, r, r), generator=gen, device="cuda") * (0.5 / r**0.5)).to(dtype)
    last = torch.randn((b, r), generator=gen, device="cuda").to(dtype)

    def kernel():
        return ops.tt_contract(first, mid, last, impl="cuda")

    err = float((kernel().float() - ref.tt_contract(first, mid, last).float()).abs().max())
    ms = smoke.time_ms(torch, kernel, 20)
    row = {"ms": ms, "max_abs_err": err,
           **smoke.bound(2 * b * k * r * r + 2 * b * r,
                         smoke.tt_bytes(b, k, r, first.element_size()), smoke.PEAK_FP32)}
    row["share"] = row["bound_ms"] / ms
    row["library_ms"] = None
    if dtype == torch.float32:
        equation = smoke.chain_equation(k)
        mids = mid.unbind(1)
        row["library_ms"] = smoke.time_ms(
            torch, lambda: torch.einsum(equation, first, *mids, last), 5)
    del first, mid, last
    torch.cuda.empty_cache()
    return row


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--label", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_tt_shapes: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    for b, k, r, source in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            row = {"label": args.label or root, "B": b, "K": k, "R": r,
                   "dtype": str(dtype).split(".")[-1], "source": source,
                   **measure(torch, smoke, b, k, r, dtype)}
            print(json.dumps(row), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
