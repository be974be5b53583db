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
* ``simt_ms``: the simt body (the first port's kernel, which takes any H)
  on the same inputs, through the library's C entry point, so the two
  bodies are compared within one call; ``simt_max_abs_err`` likewise.
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
# (hidden, where the repo runs it); 96 is above the largest bucket
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
    (96, "above the largest bucket: the simt body"),
)


def measure(torch, smoke, hid: int) -> dict:
    from repro_torch.kernels import _build, lstm, ops, ref

    gen = torch.Generator().manual_seed(0)
    x, (wi, wh, b) = smoke.lstm_inputs(torch, gen, BATCH, STEPS, hid, torch.float32,
                                       torch.device("cuda"))
    want = ref.lstm_scan(x, wi, wh, b)
    lib = _build.library()

    def simt():
        out = torch.empty_like(x)
        err = lib.repro_lstm_scan(x.data_ptr(), wi.data_ptr(), wh.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), BATCH, STEPS, hid, lstm.simt_threads(hid),
                                  0, torch.cuda.current_stream().cuda_stream)
        _build.check(lib, "lstm_scan (simt)", err)
        return out

    cudnn = smoke.cudnn_lstm(torch, wi, wh, b)

    def kernel():
        return ops.lstm_scan(x, wi, wh, b, impl="cuda")

    body = lstm.lstm_body(hid)
    return {"body": body, "bucket": lstm.bucket_for(hid) if body == "register" else None,
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
