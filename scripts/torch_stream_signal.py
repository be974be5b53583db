#!/usr/bin/env python3
"""How much signal the port's NTTD stream fit learns at a learning rate.

    python3 scripts/torch_stream_signal.py [--lr 5e-3] [--shape 16384,64,64]
        [--steps-per-slab 2] [--every 32] [--device cuda|cpu]

Streams ``SyntheticTensorSource(shape, slab_entries=2^18, seed=1)`` through
``get_codec("nttd").stream_fitter`` at the reference's fig5 streaming
setting (rank 6, hidden 12, batch 8192, seed 0; ``--lr`` and
``--steps-per-slab`` as given) and, every ``--every`` slabs and after the
last, prints one JSON line: the slabs seen, the seconds so far, the last
slab's summed loss, and the correlation of ``decode_at`` with the source's
``values_at`` over 65,536 entries drawn from seed 0.  The tensor is never
materialised.  On the CPU the fit runs the plain versions; on the card
(the default) the kernels.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np

    from repro_torch.codecs import get_codec
    from repro_torch.stream import SyntheticTensorSource

    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--shape", default="16384,64,64")
    ap.add_argument("--steps-per-slab", type=int, default=2)
    ap.add_argument("--every", type=int, default=32)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    shape = tuple(int(n) for n in args.shape.split(","))
    source = SyntheticTensorSource(shape, slab_entries=1 << 18, seed=1)
    fitter = get_codec("nttd").stream_fitter(
        shape, rank=6, hidden=12, steps_per_slab=args.steps_per_slab, batch_size=8192,
        lr=args.lr, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, n, 1 << 16) for n in shape], axis=1)
    truth = source.values_at(idx)
    t0 = time.perf_counter()
    for cursor in range(source.n_slabs):
        slab = source.slab_at(cursor)
        fitter.update(slab.indices, slab.values)
        if (cursor + 1) % args.every == 0 or cursor + 1 == source.n_slabs:
            decoded = fitter.finalize().decode_at(idx)
            print(json.dumps({
                "shape": list(shape), "lr": args.lr, "steps_per_slab": args.steps_per_slab,
                "device": str(fitter.device), "slabs": cursor + 1,
                "seconds": time.perf_counter() - t0, "loss": float(fitter.loss),
                "correlation": float(np.corrcoef(truth, decoded)[0, 1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
