#!/usr/bin/env python3
"""Time the PyTorch port's fused NTTD decode at the codec's own
architectures, on one GPU.

    python3 scripts/torch_decode_configs.py [--root DIR] [--label NAME]

``--root`` names a checkout whose ``src/repro_torch`` is timed (default:
the one holding this script), so two versions are compared on one card by
running the script once per checkout in one call, in the order A, B, B, A.

Per (hidden, rank) in ``CONFIGS`` it builds a PEMS-SF-shaped (963 x 144 x
440, paper Table II) payload at that architecture with random weights from
seed 0, on the card, and prints one JSON line:

* ``kernel_ms``: ``decode_tile`` on one 65,536-entry request (T 10), on the
  operands the payload's request path hands it; CUDA events, mean of 20
  launches after 2 warm-ups.  ``bucket`` is the instantiation that ran.
* ``max_abs_err``: that request against the plain version on the card.
* ``request_ms_median``: host-clock median of 10 ``CompressedTensor.decode``
  calls of 65,536 random entries (indices in, values on the host out),
  after 2 warm-ups; ``launches_per_request`` the kernel launches of one.
* ``to_dense_entries_per_s``: one full reconstruction of 61,015,680
  entries.

The last line is the card's name and power limit from ``nvidia-smi``.  It
exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (963, 144, 440)  # PEMS-SF
REQUEST = 65_536
# (hidden, rank, where the repo runs it)
CONFIGS = (
    (12, 6, "configs/tensorcodec_paper.py SMALL, examples/quickstart.py, fig3/4/7/9"),
    (16, 8, "core/nttd.py NTTDConfig default, kernels_bench, compressed_checkpoint"),
    (18, 10, "configs/tensorcodec_paper.py MEDIUM"),
    (24, 12, "fleet/repair.py refit (rank 12, hidden 2 x rank)"),
    (8, 8, "benchmarks/common.py NTTD_FIT_OPTS"),
    (5, 5, "benchmarks/fig8_expressiveness.py"),
)


def time_ms(torch, fn, iters: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def measure(torch, hid: int, rank: int) -> dict:
    import numpy as np

    from repro_torch.core import nttd
    from repro_torch.core.codec import CompressedTensor
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.kernels import ops

    device = torch.device("cuda")
    spec = make_folding_spec(SHAPE)
    cfg = nttd.NTTDConfig(rank=rank, hidden=hid)
    params = nttd.init_params(torch.Generator().manual_seed(0), spec, cfg, device)
    rng = np.random.default_rng(0)
    ct = CompressedTensor(params, [rng.permutation(n) for n in SHAPE], spec, cfg)
    # the operands the request path hands the kernel (a checkout without a
    # per-payload cache builds them on every call)
    ws = getattr(ct, "decode_operands", None) or nttd.fused_decode_inputs(params, spec, cfg)
    pos = torch.stack([torch.as_tensor(rng.integers(0, n, REQUEST), device=device)
                       for n in SHAPE], dim=1)
    folded = spec.fold_indices(pos).to(torch.int32).contiguous()
    got = ops.nttd_decode_tile(folded, *ws, impl="cuda")
    want = ops.nttd_decode_tile(folded, *ws, impl="ref")
    err = float((got - want).abs().max())
    kernel_ms = time_ms(torch, lambda: ops.nttd_decode_tile(folded, *ws, impl="cuda"))

    requests = [np.stack([rng.integers(0, n, REQUEST) for n in SHAPE], axis=1)
                for _ in range(12)]
    req_ms = []
    ops.reset_launch_counts()
    for i, idx in enumerate(requests):
        t = time.perf_counter()
        ct.decode(idx)
        if i >= 2:
            req_ms.append((time.perf_counter() - t) * 1e3)
    launches = ops.launch_counts()["decode_tile"] / len(requests)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dense = ct.to_dense()
    dense_s = time.perf_counter() - t
    if not np.isfinite(dense).all():
        raise RuntimeError(f"non-finite to_dense output at hidden {hid}, rank {rank}")
    return {"kernel_ms": kernel_ms, "weights_hidden_rank": [int(ws[0].shape[2]),
                                                            int(ws[5].shape[0])],
            "max_abs_err": err, "request_ms_median": statistics.median(req_ms),
            "request_ms": req_ms, "launches_per_request": launches,
            "to_dense_s": dense_s, "to_dense_entries_per_s": dense.size / dense_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default=None, help="name printed on every line")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_configs: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    label = args.label or os.path.relpath(root, HERE)
    for hid, rank, source in CONFIGS:
        row = {"label": label, "hidden": hid, "rank": rank, "source": source,
               **measure(torch, hid, rank)}
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
