#!/usr/bin/env python3
"""Where a training step of the port's fit goes, on the card.

    python3 scripts/torch_fit_profile.py [--steps 20] [--impl auto]

Builds the paper's MEDIUM NTTD (rank 10, hidden 18) on PEMS-SF's index
space (963 x 144 x 440, d' 10) from the codec's init, and runs the fit's
training step (``repro_torch.core.codec._make_train_step`` with the
training impl of ``--impl``) on batches of 8192 random entries: a few
warm-up steps, then ``--steps`` steps timed with the host clock ending in a
synchronise, then the same count under ``torch.profiler`` (host and
device).  Prints JSON lines: the step's wall ms, the device's busy ms a
step (the sum of its kernels' and copies' time) and idle share, the
launches a step, and the operators that take the most host time and the
kernels that take the most device time.  The card's name and power limit
come first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPE = (963, 144, 440)  # PEMS-SF, paper Table II
RANK, HIDDEN, BATCH, LR = 10, 18, 8192, 1e-2  # the paper's MEDIUM


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--impl", default="auto")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import codec, nttd
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.optim import optimizers

    if not torch.cuda.is_available():
        print("torch_fit_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda")
    spec = make_folding_spec(SHAPE)
    cfg = nttd.NTTDConfig(rank=RANK, hidden=HIDDEN, kernel_impl=codec.training_impl(args.impl))
    params = nttd.init_params(torch.Generator().manual_seed(0), spec, cfg, device)
    opt = optimizers.adam(LR)
    state = opt.init(params)
    step = codec._make_train_step(spec, cfg, opt)
    rng = np.random.default_rng(0)
    n = args.warmup + 2 * args.steps
    pos = torch.as_tensor(np.stack([rng.integers(0, d, (n, BATCH)) for d in SHAPE], -1),
                          device=device)
    vals = torch.as_tensor(rng.normal(size=(n, BATCH)).astype(np.float32), device=device)

    for i in range(args.warmup):
        params, state, _ = step(params, state, pos[i], vals[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.warmup, args.warmup + args.steps):
        params, state, _ = step(params, state, pos[i], vals[i])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.warmup + args.steps, n):
            params, state, _ = step(params, state, pos[i], vals[i])
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    on_device = [e for e in prof.events() if e.device_type == cuda]
    device_us = sum(e.time_range.elapsed_us() for e in on_device)
    launches = len(on_device)
    per_kernel: dict[str, list[float]] = {}
    for e in on_device:
        acc = per_kernel.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    host = [e for e in prof.key_averages() if e.device_type != cuda]
    top_host = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    top_device = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)[:12]
    print(json.dumps({
        "impl": args.impl, "train_impl": cfg.kernel_impl, "batch": BATCH, "steps": args.steps,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": device_us / 1e3 / args.steps,
        "device_idle_share": 1 - device_us / 1e3 / args.steps / wall_ms,
        "device_ops_per_step": launches / args.steps,
        "top_host_ms_per_step": [[e.key, e.self_cpu_time_total / 1e3 / args.steps,
                                  e.count / args.steps] for e in top_host],
        "top_device_ms_per_step": [[name, us / 1e3 / args.steps, count / args.steps]
                                   for name, (us, count) in top_device],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
