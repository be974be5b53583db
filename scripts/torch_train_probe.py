#!/usr/bin/env python3
"""LM training at full width on the card: learning rates, remat modes, the
in-place Adam update and one profiled step.

    python3 scripts/torch_train_probe.py [--arch minicpm-2b] [--steps 8] \
        [--lrs 3e-4,1e-4,5e-5] [--remats none,full] [--profile]

Runs ``repro_torch.launch.train.run`` at the config's full width and depth
(batch 8 x seq 128, WSD) once per learning rate of ``--lrs`` (remat as
configured), then once per remat mode of ``--remats`` at the first of
``--lrs``' values below 3e-4; one JSON line per run: losses, step ms
(host clock, each step ending in its loss's read) and peak device memory.
Then it times one in-place Adam update (``Optimizer.apply_``) over the full
params with CUDA events, and with ``--profile`` one step under
``torch.profiler``: its wall ms, the sum of its kernels' device time, the
device's idle share against the profiled step and against the median of
the unprofiled steps before it, and the kernels that take the most time.  The
card's name and power limit come first.  ~2 minutes on an H100.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


WARM_STEPS = 4  # unprofiled steps before the profiled one


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def one_run(torch, configs, train, argv, remat):
    real = configs.get

    def with_remat(arch):
        return dataclasses.replace(real(arch), remat=remat)

    if remat:
        configs.get = with_remat
    try:
        torch.cuda.reset_peak_memory_stats()
        run = train.run(argv)
        torch.cuda.synchronize()
    finally:
        configs.get = real
    emit({"argv": argv, "remat": remat or real(argv[1]).remat, "losses": run.losses,
          "step_ms": [t * 1e3 for t in run.step_seconds],
          "peak_bytes": torch.cuda.max_memory_allocated()})
    del run
    gc.collect()
    torch.cuda.empty_cache()


def adam_and_profile(torch, arch, lr, profile):
    from repro_torch import configs
    from repro_torch.data.pipeline import PipelineConfig, SyntheticSource
    from repro_torch.models import model
    from repro_torch.optim import optimizers, schedules
    from repro_torch.train import step as step_lib

    cfg = configs.get(arch)
    params = model.init_params(cfg, 0, "cuda")
    opt = optimizers.adamw(schedules.wsd(lr, 100), weight_decay=0.1, max_grad_norm=1.0)
    state = opt.init(params)
    grads = optimizers.tree_map(lambda p: torch.randn_like(p) * 1e-3, params)
    ms = []
    for _ in range(3):
        g = optimizers.tree_map(torch.clone, grads)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state = opt.apply_(g, state, params)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        del g
    n = sum(p.numel() for p in optimizers.tree_leaves(params))
    emit({"adam_apply_ms": ms, "params": n})
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    if not profile:
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    step = step_lib.make_train_step(cfg, opt)
    src = SyntheticSource(PipelineConfig(8, 128, cfg.vocab))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in src.batch_at(s).items()}
               for s in range(WARM_STEPS + 1)]
    unprofiled = []
    for b in batches[:WARM_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        float(m["loss"])
        torch.cuda.synchronize()
        unprofiled.append((time.perf_counter() - t0) * 1e3)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[3])
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("Command Buffer")]
    by_name: dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e.name[:100], [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    # the profiler's own host work lengthens the profiled step: the idle
    # share is also given against the median unprofiled step (the first
    # warm-up step left out)
    median = float(np.median(unprofiled[1:]))
    emit({"profiled_step_ms": wall, "unprofiled_step_ms": unprofiled,
          "unprofiled_median_ms": median, "kernels": len(kernels), "device_busy_ms": busy,
          "idle_share_profiled": 1 - busy / wall, "idle_share_unprofiled": 1 - busy / median,
          "top": [[k, c, t] for k, (c, t) in top]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lrs", default="3e-4,1e-4,5e-5")
    ap.add_argument("--remats", default="none,full")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.launch import train

    emit({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip(), "torch": torch.__version__})
    base = ["--arch", args.arch, "--steps", str(args.steps), "--log-every", str(args.steps)]
    lrs = [float(x) for x in args.lrs.split(",")]
    for lr in lrs:
        one_run(torch, configs, train, base + ["--lr", str(lr)], None)
    low = next((lr for lr in lrs if lr < 3e-4), lrs[0])
    for remat in filter(None, args.remats.split(",")):
        one_run(torch, configs, train, base + ["--lr", str(low)], remat)
    adam_and_profile(torch, args.arch, low, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
