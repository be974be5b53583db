#!/usr/bin/env python3
"""Time the PyTorch port's LSTM scan at every hidden width the repo runs,
through both of its CUDA bodies, on one GPU.

    python3 scripts/torch_lstm_buckets.py

Per hidden width in ``WIDTHS`` it makes x [BATCH, STEPS, H] and the
weights from seed 0 on the card (f32, ``chip_smoke.lstm_inputs``) and
prints one JSON line:

* ``ms``: ``ops.lstm_scan(impl="cuda")``, the body ``lstm_body`` picks
  (``body``, ``bucket``), CUDA events, mean of 20 launches after 2 warm-ups;
  ``max_abs_err`` against the plain version on the card.
* ``simt_ms``: the simt body (products over a tile of sequences, which
  takes any H up to 1304) on the same inputs at its tile ``simt_tile``,
  through the library's C entry point, so the two bodies are compared
  within one call; ``simt_max_abs_err`` likewise.
* ``tiles``: above the largest bucket, the simt body's ms at two tile
  rules: the wrapper's (``lstm.simt_tile``, the largest tile that fits)
  and ``round_tile`` (the tile that fills whole rounds of the gate
  product's 512 thread tiles).
* ``library_ms``: cuDNN ``torch.nn.LSTM`` on the same inputs (TF32 off).
* ``bound_ms``, ``bound_by``: as ``chip_smoke.py``'s ``lstm_scan`` row.

Timing, inputs, bound and the cuDNN yardstick are ``chip_smoke.py``'s own,
from the checkout this script lies in.  The last line is the card's name
and power limit from ``nvidia-smi``.  It exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, STEPS = 65_536, 10  # chip_smoke.py's lstm_scan timing shape
# (hidden, where the repo runs it); 68 and up are above the largest bucket
WIDTHS = (
    (5, "benchmarks/fig8_expressiveness.py"),
    (8, "benchmarks/common.py NTTD_FIT_OPTS"),
    (12, "configs/tensorcodec_paper.py SMALL"),
    (16, "core/nttd.py NTTDConfig default, chip_smoke.py's main path"),
    (18, "configs/tensorcodec_paper.py MEDIUM"),
    (20, "a bucket width"),
    (24, "fleet/repair.py refit"),
    (32, "a bucket width"),
    (64, "the largest tested shape"),
    (68, "the budget rule at 1 MB (PEMS-SF, Uber), chip_smoke.py's wide phase"),
    (96, "above the largest bucket: the simt body"),
    (114, "the budget rule at 4 MB"),
    (256, "the budget rule's widest"),
)
THREADS = 512  # kSimtThreads in csrc/simt_tile.cuh


def round_tile(hid: int) -> int:
    """Of the tiles that fit (multiples of 8 up to ``lstm.simt_tile``), the
    one with the most sequences a round of the gate product, whose threads
    each own 8 sequences x 2 units (the larger tile on a tie)."""
    from repro_torch.kernels import lstm

    pairs = -(-hid // 2)
    tiles = range(8, lstm.simt_tile(hid) + 1, 8)
    return max(tiles, key=lambda tb: (tb / -(-(tb // 8) * pairs // THREADS), tb))


def measure(torch, smoke, hid: int) -> dict:
    from repro_torch.kernels import _build, lstm, ops, ref

    gen = torch.Generator().manual_seed(0)
    x, (wi, wh, b) = smoke.lstm_inputs(torch, gen, BATCH, STEPS, hid, torch.float32,
                                       torch.device("cuda"))
    want = ref.lstm_scan(x, wi, wh, b)
    lib = _build.library()

    def simt(tile=lstm.simt_tile(hid)):
        out = torch.empty_like(x)
        err = lib.repro_lstm_scan(x.data_ptr(), wi.data_ptr(), wh.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), BATCH, STEPS, hid, tile, 0,
                                  torch.cuda.current_stream().cuda_stream)
        _build.check(lib, "lstm_scan (simt)", err)
        return out

    cudnn = smoke.cudnn_lstm(torch, wi, wh, b)

    def kernel():
        return ops.lstm_scan(x, wi, wh, b, impl="cuda")

    body = lstm.lstm_body(hid)
    tiles = {}
    if body == "simt":
        for tile in sorted({lstm.simt_tile(hid), round_tile(hid)}):
            tiles[tile] = {"ms": smoke.time_ms(torch, lambda: simt(tile), 20),
                           "max_abs_err": float((simt(tile) - want).abs().max())}
    return {"body": body, "bucket": lstm.bucket_for(hid) if body == "register" else None,
            "tile": lstm.simt_tile(hid), "round_tile": round_tile(hid), "tiles": tiles,
            "ms": smoke.time_ms(torch, kernel, 20),
            "max_abs_err": float((kernel() - want).abs().max()),
            "simt_ms": smoke.time_ms(torch, simt, 20),
            "simt_max_abs_err": float((simt() - want).abs().max()),
            "library_ms": smoke.time_ms(torch, lambda: cudnn(x), 20),
            **smoke.bound(*smoke.lstm_cost(BATCH, STEPS, hid), smoke.PEAK_FP32)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_lstm_buckets: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for hid, source in WIDTHS:
        row = {"hidden": hid, "batch": BATCH, "steps": STEPS, "dtype": "float32",
               "source": source, **measure(torch, smoke, hid)}
        print(json.dumps(row), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
