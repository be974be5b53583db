"""End-to-end training driver on the PyTorch port: a ~10M-param dense LM
for a few hundred steps on synthetic data with the full production loop
(WSD schedule, clipping, async checkpointing, auto-resume), as
``examples/train_lm.py`` does with the JAX package.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] [--steps 200]

Trains on ``--device``, CUDA unless given; checkpoints go to a new
temporary directory, whose path it prints.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch import train as train_launch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="CUDA unless given")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    every = max(1, args.steps // 2)
    losses = train_launch.main([
        "--arch", "minicpm-2b", "--smoke",
        "--steps", str(args.steps), "--batch", "8", "--seq", "128",
        "--lr", "3e-3", "--schedule", "wsd",
        "--ckpt-dir", ckpt_dir, "--ckpt-every", str(every),
        "--log-every", str(max(1, args.steps // 8)),
    ] + (["--device", args.device] if args.device else []))
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
    print(f"checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
