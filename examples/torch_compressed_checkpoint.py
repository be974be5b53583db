"""TensorCodec as checkpoint codec on the PyTorch port: train a small LM a
few steps, then ship its checkpoint through the NTTD compressor and
measure size and quality, as ``examples/compressed_checkpoint.py`` does
with the JAX package.

    PYTHONPATH=src python examples/torch_compressed_checkpoint.py [--device cpu] \
        [--steps 20] [--epochs 25]

Runs on ``--device``, CUDA unless given: there the codec's fits train
through the ``lstm_scan`` and ``tt_contract`` kernels and their backward
kernels, and the decompression decodes through ``decode_tile``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch

from repro_torch import configs
from repro_torch.compress import checkpoint_codec as cc
from repro_torch.data.pipeline import PipelineConfig, SyntheticSource
from repro_torch.devices import resolve_device
from repro_torch.models import model
from repro_torch.optim import optimizers
from repro_torch.train import step as step_lib


def _embeds(seed: int, d_model: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((8, 64, d_model), generator=gen) * 0.1).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="CUDA unless given")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=25)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_smoke("musicgen-medium")
    params = model.init_params(cfg, seed=0, device=device)
    opt = optimizers.adamw(3e-3)
    ost = opt.init(params)
    step = step_lib.make_train_step(cfg, opt)
    src = SyntheticSource(PipelineConfig(batch_size=8, seq_len=64, vocab=cfg.vocab))
    for i in range(args.steps):
        labels = torch.as_tensor(src.batch_at(i)["labels"], device=device)
        params, ost, m = step(params, ost, {"embeds": _embeds(1000 + i, cfg.d_model, device),
                                            "labels": labels})
    print(f"trained {args.steps} steps, loss {float(m['loss']):.3f}")

    payload, stats = cc.compress_tree(
        params,
        cc.CodecCheckpointConfig(min_elements=4096, min_fitness=0.6,
                                 rank=8, hidden=16, epochs=args.epochs),
        device=device,
    )
    print(f"checkpoint: {stats['raw_bytes']/1e6:.1f} MB raw -> "
          f"{stats['compressed_bytes']/1e6:.2f} MB "
          f"({stats['ratio']:.1f}x), {stats['leaves_codec']} leaves NTTD-coded, "
          f"{stats['leaves_raw']} raw")

    restored = cc.decompress_tree(payload, params, device=device)
    batch = {"embeds": _embeds(7, cfg.d_model, device),
             "labels": torch.as_tensor(src.batch_at(99)["labels"], device=device)}
    with torch.no_grad():
        loss_orig, _ = model.loss_fn(params, cfg, batch)
        loss_rest, _ = model.loss_fn(restored, cfg, batch)
    print(f"eval loss: original {float(loss_orig):.4f} vs decompressed "
          f"{float(loss_rest):.4f} (lossy-codec delta "
          f"{float(loss_rest - loss_orig):+.4f})")


if __name__ == "__main__":
    main()
