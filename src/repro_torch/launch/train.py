"""Training launcher, port of ``repro.launch.train``, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --resume auto

The reference's flags, plus ``--device`` (CUDA unless given; without a
card and without ``--device cpu`` it raises).  Includes: WSD/cosine
schedules, grad clipping, async checkpointing with auto-resume, SIGTERM ->
final checkpoint, the straggler watchdog, optional gradient compression
(``--grad-compress int8|topk``) and an mmap token file (``--data``).

The step updates the params and the optimizer state in place (the
reference donates both to its jitted step), so a full-width step holds one
copy of the f32 masters, their gradients, Adam's two moments and the bf16
compute copy.  One device only: ``--mesh`` other than ``1x1`` raises
(ROADMAP A.9).  A final checkpoint that the last periodic save already
wrote is not written again.

``main(argv)`` returns the losses, as the reference's does; ``run(argv)``
returns them with the step times, the final params and optimizer state.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import threading
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.pipeline import MMapSource, PipelineConfig, SyntheticSource
from repro_torch.devices import resolve_device
from repro_torch.models import model
from repro_torch.optim import optimizers, schedules
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import step as step_lib


class StragglerWatchdog:
    """Flags steps slower than ``factor`` x the trailing median."""

    def __init__(self, window: int = 50, factor: float = 2.0):
        self.times: list[float] = []
        self.window = window
        self.factor = factor
        self.flagged = 0

    def record(self, dt: float) -> bool:
        hist = self.times[-self.window :]
        slow = len(hist) >= 10 and dt > self.factor * float(np.median(hist))
        self.times.append(dt)
        if slow:
            self.flagged += 1
        return slow


@dataclasses.dataclass
class TrainRun:
    losses: list[float]
    step_seconds: list[float]    # host clock, each ending in the loss's read
    start_step: int
    last_step: int               # steps done, resumed ones included
    stopped: bool                # SIGTERM ended the run
    params: dict
    opt_state: optimizers.AdamState
    stragglers: int


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="wsd", choices=["wsd", "cosine", "constant"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--data", default=None, help="path to int32 token file (mmap)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None, help="DxM; only 1x1 (one device) is ported")
    ap.add_argument("--device", default=None, help="CUDA unless given")
    return ap.parse_args(argv)


def _make_step(cfg, opt, comp):
    if comp is None:
        return step_lib.make_train_step(cfg, opt)

    def step_with_comp(params, opt_state, comp_state, batch):
        # the reference's compressed step: the loss on the masters as given
        (loss, metrics), grads = step_lib.value_and_grad(
            lambda p, b: model.loss_fn(p, cfg, b), params, batch)
        grads, comp_state = comp.transform(grads, comp_state)
        opt_state = opt.apply_(grads, opt_state, params)
        return params, opt_state, comp_state, {**metrics, "loss": loss}

    return step_with_comp


def run(argv=None) -> TrainRun:
    args = parse_args(argv)
    if args.mesh not in (None, "1x1"):
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes wait for ROADMAP A.9")
    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)

    warmup = min(20, args.steps // 10)
    sched = {
        "wsd": lambda: schedules.wsd(args.lr, args.steps, warmup=warmup),
        "cosine": lambda: schedules.cosine(args.lr, args.steps, warmup=warmup),
        "constant": lambda: schedules.constant(args.lr),
    }[args.schedule]()
    opt = optimizers.adamw(sched, weight_decay=0.1, max_grad_norm=1.0)

    comp = None
    if args.grad_compress != "none":
        from repro_torch.dist import grad_compress

        comp = (grad_compress.ErrorFeedbackInt8() if args.grad_compress == "int8"
                else grad_compress.TopK(0.05))

    params = model.init_params(cfg, 0, device)
    opt_state = opt.init(params)
    comp_state = comp.init(params) if comp else None
    train_step = _make_step(cfg, opt, comp)

    pcfg = PipelineConfig(batch_size=args.batch, seq_len=args.seq, vocab=cfg.vocab, seed=0)
    source = MMapSource(args.data, pcfg) if args.data else SyntheticSource(pcfg)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = ckpt_lib.Checkpointer(args.ckpt_dir)
        if args.resume == "auto":
            state, start_step = ckpt_lib.auto_resume(ckpt, {"params": params, "opt": opt_state})
            if state is not None:
                params, opt_state = state["params"], state["opt"]
                print(f"resumed from step {start_step}")

    stop = {"flag": False}
    previous = None
    if threading.current_thread() is threading.main_thread():
        previous = signal.signal(signal.SIGTERM, lambda signum, frame: stop.update(flag=True))

    watchdog = StragglerWatchdog()
    losses: list[float] = []
    step = start_step - 1
    saved = None
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device) for k, v in source.batch_at(step).items()}
            if comp is None:
                params, opt_state, metrics = train_step(params, opt_state, batch)
            else:
                params, opt_state, comp_state, metrics = train_step(
                    params, opt_state, comp_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            if watchdog.record(dt):
                print(f"[watchdog] step {step} straggled: {dt:.3f}s")
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step}: loss={loss:.4f} ({dt*1000:.0f} ms)")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
                saved = step + 1
            if stop["flag"]:
                print(f"SIGTERM: final checkpoint at step {step + 1}")
                break
        last = step + 1 if stop["flag"] else max(args.steps, start_step)
        if ckpt:
            if last != saved:
                ckpt.save(last, {"params": params, "opt": opt_state})
            ckpt.wait()
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    if losses:
        print(f"done. first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return TrainRun(losses=losses, step_seconds=watchdog.times, start_step=start_step,
                    last_step=last, stopped=stop["flag"], params=params,
                    opt_state=opt_state, stragglers=watchdog.flagged)


def main(argv=None) -> list[float]:
    return run(argv).losses


if __name__ == "__main__":
    main()
