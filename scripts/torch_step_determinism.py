#!/usr/bin/env python3
"""Whether a training step of the port's NTTD stream fit gives the same
bits every time, on one GPU.

    python3 scripts/torch_step_determinism.py [--slabs 8]

At the stream phase's shape (``chip_smoke.STREAM_SHAPE``, rank 6, hidden
12, one batch of 8192 entries of slab 3, inputs from seed 0) it prints one
JSON line per check, each repeated three times on the same inputs:

* ``value_and_grad``: the step's loss and every leaf's gradient, bitwise;
* ``embedding``: the tables' gradients through PyTorch's
  ``F.embedding`` backward and through the port's ``nttd._TableRows``
  (one-hot products), bitwise, with the largest difference between calls;
* ``kernels``: the ``lstm_scan`` and ``tt_contract`` kernels, forward and
  backward, bitwise;
* ``fitters``: two stream fitters from one seed over ``--slabs`` slabs,
  the first slab after which their params differ (null: none).

The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def repeats(fn, n=3):
    """``fn()``'s tensors on ``n`` calls: (bitwise equal to the first call,
    largest difference from it) for each tensor."""
    runs = [fn() for _ in range(n)]
    return [[bool(all(a.equal(b) for a, b in zip(runs[0], r))) for r in runs[1:]],
            max(float((a - b).abs().max()) for r in runs[1:] for a, b in zip(runs[0], r))]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.codecs import get_codec
    from repro_torch.core import codec as codec_lib
    from repro_torch.core import nttd
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops
    from repro_torch.kernels import tt_contract as _tt
    from repro_torch.stream import SyntheticTensorSource

    ap = argparse.ArgumentParser()
    ap.add_argument("--slabs", type=int, default=8)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    source = SyntheticTensorSource(smoke.STREAM_SHAPE, slab_entries=smoke.STREAM_SLAB,
                                   seed=smoke.STREAM_SOURCE_SEED)
    fitter = get_codec("nttd").stream_fitter(source.shape, **smoke.STREAM_OPTS)
    spec, params = fitter.spec, fitter.params
    slab = source.slab_at(3)
    pick = np.random.default_rng(smoke.SEED).integers(0, len(slab.values), 8192)
    pos = torch.as_tensor(slab.indices[pick], device=device)
    vals = torch.as_tensor((slab.values[pick] - slab.values.mean()) / slab.values.std(),
                           device=device)

    train_cfg = nttd.NTTDConfig(rank=fitter.cfg.rank, hidden=fitter.cfg.hidden,
                                kernel_impl="cuda")
    value_and_grad = codec_lib._make_value_and_grad(spec, train_cfg)

    def step():
        loss, grads = value_and_grad(params, pos, vals)
        return [loss] + [g for _, g in leaves(grads)]

    emit({"check": "value_and_grad", "leaves": ["loss"] + [k for k, _ in leaves(params)],
          "same_and_max_diff": repeats(step)})

    folded = spec.fold_indices(pos)
    tables = sorted(k for k in params if k.startswith("embed_"))
    gen = torch.Generator(device=device).manual_seed(smoke.SEED)
    douts = {}

    def table_grads(lookup):
        def run():
            grads = []
            for key in tables:
                m = int(key.split("_")[1])
                cols = [j for j, n in enumerate(spec.folded_shape) if n == m]
                table = params[key].detach().requires_grad_()
                x = lookup(table, folded[:, cols])
                if key not in douts:
                    douts[key] = torch.randn(x.shape, generator=gen, device=device)
                grads.append(torch.autograd.grad(x, table, douts[key])[0])
            return grads
        return run

    emit({"check": "embedding", "tables": tables,
          "F.embedding": repeats(table_grads(
              lambda t, i: torch.nn.functional.embedding(i, t))),
          "_TableRows": repeats(table_grads(nttd._TableRows.apply))})

    x = nttd._embed(params, folded, spec).contiguous()
    lw = (params["lstm"]["wi"], params["lstm"]["wh"], params["lstm"]["b"])
    hs = ops.lstm_scan(x, *lw, impl="cuda")
    dhs = torch.randn(hs.shape, generator=gen, device=device)
    b, t, h, r = smoke.STREAM_STEP
    first, mid, last, dout = smoke.training_inputs(
        torch, torch.Generator().manual_seed(smoke.SEED), b, t, h, r, device)[1]
    emit({"check": "kernels",
          "lstm_scan": repeats(lambda: [ops.lstm_scan(x, *lw, impl="cuda")]),
          "lstm_scan_bwd": repeats(lambda: _lstm.lstm_scan_bwd(x, *lw, hs, dhs)),
          "tt_contract": repeats(lambda: [ops.tt_contract(first, mid, last, impl="cuda")]),
          "tt_contract_bwd": repeats(lambda: _tt.tt_contract_bwd(first, mid, last, dout))})

    fitters = [get_codec("nttd").stream_fitter(source.shape, **smoke.STREAM_OPTS)
               for _ in range(2)]
    first_diff = None
    for cursor in range(args.slabs):
        slab = source.slab_at(cursor)
        for f in fitters:
            f.update(slab.indices, slab.values)
        differ = [k for (k, a), (_, b2) in zip(leaves(fitters[0].params),
                                                leaves(fitters[1].params)) if not a.equal(b2)]
        if differ and first_diff is None:
            first_diff = {"slab": cursor, "leaves": differ}
    emit({"check": "fitters", "slabs": args.slabs, "first_diff": first_diff})
    return 0


if __name__ == "__main__":
    sys.exit(main())
