"""Training launcher, port of ``repro.launch.train``, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --resume auto

The reference's flags, plus ``--device`` (CUDA unless given; without a
card and without ``--device cpu`` it raises).  Includes: WSD/cosine
schedules, grad clipping, async checkpointing with auto-resume, SIGTERM ->
final checkpoint, the straggler watchdog, optional gradient compression
(``--grad-compress int8|topk``) and an mmap token file (``--data``).

Meshes.  Inside an initialized process group (the caller's own, or one
the launcher starts from ``torchrun``'s environment: NCCL on CUDA, gloo
on the CPU) it trains on ``--mesh DxM``, a ``launch.mesh.make_debug_mesh``
of (data, model) axes, by default (world, 1): every rank data-parallel, as
the reference's default.  The params are drawn straight into their
``param_shardings`` under ``BASE_RULES``, the optimizer state laid out by
``opt_shardings`` and every batch by ``batch_shardings`` (each rank
builds the same global batch and keeps its chunk); the step, gradient
compression, checkpoints (auto-resume restores onto the mesh, whatever
mesh wrote them) and SIGTERM run on that mesh, and rank 0 prints.  A
SIGTERM to any rank stops every rank after the same step.  A mesh whose
size is not the world size raises ``ValueError``.  Without a process
group it trains on one device, and ``--mesh`` other than ``1x1`` raises.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --mesh 2x2 --steps 8

The step updates the params and the optimizer state in place (the
reference donates both to its jitted step), so a full-width step holds one
copy of the f32 masters, their gradients, Adam's two moments and the bf16
compute copy.  A final checkpoint that the last periodic save already
wrote is not written again.

``main(argv)`` returns the losses, as the reference's does; ``run(argv)``
returns them with the step times, the final params and optimizer state.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.pipeline import MMapSource, PipelineConfig, SyntheticSource
from repro_torch.devices import resolve_device
from repro_torch.dist import sharding
from repro_torch.launch.mesh import make_debug_mesh
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
    ap.add_argument("--mesh", default=None,
                    help="DxM, e.g. 2x2, inside a process group of D*M ranks "
                         "(default: all ranks data-parallel)")
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
        # replicated, as the plain step's: a partial sum read by float()
        # would be this rank's share alone
        metrics = {**metrics, "loss": loss}
        return params, opt_state, comp_state, {k: sharding.replicate(v)
                                               for k, v in metrics.items()}

    return step_with_comp


def _start_group(device: torch.device) -> bool:
    """Join the process group ``torchrun``'s environment describes, if
    there is one and no group is up yet; True when this call started it."""
    if dist.is_initialized() or "TORCHELASTIC_RUN_ID" not in os.environ:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


def make_mesh(spec: str | None, device: torch.device):
    """The (data, model) ``DeviceMesh`` of ``--mesh`` over the process
    group, or None without one (one device)."""
    if not dist.is_initialized():
        if spec not in (None, "1x1"):
            raise ValueError(f"--mesh {spec}: start the launcher under a process group of "
                             f"that size (e.g. torchrun --nproc-per-node N)")
        return None
    world = dist.get_world_size()
    d, m = (int(x) for x in spec.split("x")) if spec else (world, 1)
    if d * m != world:
        raise ValueError(f"--mesh {spec} has {d * m} devices; the process group has {world}")
    return make_debug_mesh(d, m, device=device)


def _agree(flag: bool, device: torch.device) -> bool:
    """True on every rank when ``flag`` is True on any."""
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def run(argv=None) -> TrainRun:
    args = parse_args(argv)
    device = resolve_device(args.device)
    started = _start_group(device)
    try:
        return _run(args, device)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, device: torch.device) -> TrainRun:
    mesh = make_mesh(args.mesh, device)
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
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

    rules = sharding.BASE_RULES
    shardings = None
    if mesh is not None:
        shardings = {"params": step_lib.param_shardings(mesh, cfg, rules),
                     "opt": step_lib.opt_shardings(mesh, cfg, rules)}
    params = model.init_params(cfg, 0, device, shardings["params"] if shardings else None)
    opt_state = opt.init(params)
    if mesh is not None:
        opt_state = sharding.device_put(opt_state, shardings["opt"])
    comp_state = comp.init(params) if comp else None
    train_step = _make_step(cfg, opt, comp)

    pcfg = PipelineConfig(batch_size=args.batch, seq_len=args.seq, vocab=cfg.vocab, seed=0)
    source = MMapSource(args.data, pcfg) if args.data else SyntheticSource(pcfg)

    def batch_at(step: int) -> dict:
        batch = {k: torch.from_numpy(v).to(device) for k, v in source.batch_at(step).items()}
        if mesh is None:
            return batch
        return sharding.device_put(batch, step_lib.batch_shardings(mesh, cfg, batch, rules))

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = ckpt_lib.Checkpointer(args.ckpt_dir)
        if args.resume == "auto":
            state, start_step = ckpt_lib.auto_resume(ckpt, {"params": params, "opt": opt_state},
                                                     shardings)
            if state is not None:
                params, opt_state = state["params"], state["opt"]
                say(f"resumed from step {start_step}")

    stop = {"flag": False}
    watchdog = StragglerWatchdog()
    losses: list[float] = []
    step = start_step - 1
    saved = None
    with contextlib.ExitStack() as stack:
        if threading.current_thread() is threading.main_thread():
            previous = signal.signal(signal.SIGTERM, lambda signum, frame: stop.update(flag=True))
            stack.callback(signal.signal, signal.SIGTERM, previous)
        if mesh is not None:
            stack.enter_context(sharding.sharding_ctx(mesh, rules))
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = batch_at(step)
            if comp is None:
                params, opt_state, metrics = train_step(params, opt_state, batch)
            else:
                params, opt_state, comp_state, metrics = train_step(
                    params, opt_state, comp_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            if watchdog.record(dt):
                say(f"[watchdog] step {step} straggled: {dt:.3f}s")
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step}: loss={loss:.4f} ({dt*1000:.0f} ms)")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
                saved = step + 1
            if mesh is not None:  # a SIGTERM to any rank stops them all here
                stop["flag"] = _agree(stop["flag"], device)
            if stop["flag"]:
                say(f"SIGTERM: final checkpoint at step {step + 1}")
                break
        last = step + 1 if stop["flag"] else max(args.steps, start_step)
        if ckpt:
            if last != saved:
                ckpt.save(last, {"params": params, "opt": opt_state})
            ckpt.wait()
            if mesh is not None:  # rank 0 wrote it: no rank reads before it is there
                dist.barrier()
    if losses:
        say(f"done. first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return TrainRun(losses=losses, step_seconds=watchdog.times, start_step=start_step,
                    last_step=last, stopped=stop["flag"], params=params,
                    opt_state=opt_state, stragglers=watchdog.flagged)


def main(argv=None) -> list[float]:
    return run(argv).losses


if __name__ == "__main__":
    main()
