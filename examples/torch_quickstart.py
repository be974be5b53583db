"""Quickstart on the PyTorch port: compress a tensor with TensorCodec via
the unified codec API, compare against every other registered codec at
the same budget, and serve entry queries from the serialized payload, as
``examples/quickstart.py`` does with the JAX package.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] \
        [--epochs 60] [--out payload.tcdc]

The fit, the decodes, the service and the fleet run on ``--device``, CUDA
unless given (there the fit trains through the ``lstm_scan`` and
``tt_contract`` kernels and their backward kernels, and every decode is
the ``decode_tile`` kernel).  ``--out`` also writes the payload's bytes
to a file, which either package loads.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np

from repro_torch.codecs import available, get_codec, load_bytes, save_bytes
from repro_torch.data import synthetic_tensors as st
from repro_torch.devices import resolve_device
from repro_torch.fleet import FleetFrontend, collect, rebalance
from repro_torch.serve.codec_service import CodecService
from repro_torch.stream import write_chunked


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="CUDA unless given")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--fleet-entries", type=int, default=4096)
    ap.add_argument("--out", default=None, help="also write the payload's bytes here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # a synthetic "stock"-like tensor (smooth random walks, shuffled)
    x = st.load("stock", mini=True)
    print(f"input tensor {x.shape} = {x.size} entries ({x.size * 8 / 1e6:.1f} MB fp64)")

    enc = get_codec("nttd").fit(
        x, rank=6, hidden=12, epochs=args.epochs, batch_size=8192, lr=1e-2, patience=8,
        device=device,
    )
    fit = enc.fitness(x)
    payload = enc.payload_bytes()
    print(f"TensorCodec: fitness={fit:.4f} payload={payload/1e3:.1f} KB "
          f"({x.size * 8 / payload:.0f}x compression) in "
          f"{enc.log.seconds_train:.0f}s on {device}")

    # every other registered codec at the same byte budget (paper protocol)
    for name in available():
        if name == "nttd":
            continue
        try:
            rival = get_codec(name).fit(x, payload)
        except ValueError as e:  # codec cannot meet this budget
            print(f"{name} same budget: skipped ({e})")
            continue
        print(f"{name} same budget: fitness={rival.fitness(x):.4f} "
              f"payload={rival.payload_bytes()/1e3:.1f} KB")

    # container round trip + served entry queries
    blob = save_bytes(enc)
    if args.out:
        with open(args.out, "wb") as f:
            f.write(blob)
    enc2 = load_bytes(blob, device=device)
    idx = np.array([[0, 0, 0], [3, 5, 7]])
    print(f"serialized {len(blob)/1e3:.1f} KB; decode after round-trip: "
          f"{enc2.decode_at(idx).round(3)} vs original {x[0,0,0]:.3f}, {x[3,5,7]:.3f}")

    svc = CodecService(device=device)
    svc.load("stock", blob)
    t0 = svc.submit("stock", idx)
    t1 = svc.submit("stock", idx[::-1])
    out = svc.flush()
    print(f"codec service ({svc.info('stock').codec}): coalesced 2 requests -> "
          f"{out[t0].round(3)}, {out[t1].round(3)}")

    # --- fleet: 3 instances serving one chunked payload as one service ---
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stock.tcdc")
        write_chunked(path, enc, chunk_bytes=2048)  # chunk index + entry ranges
        fleet = FleetFrontend(3, cache_bytes=1 << 24, device=device)
        fleet.load_stream("stock", path, tile_entries=1024)
        rng = np.random.default_rng(0)
        big = np.stack([rng.integers(0, s, args.fleet_entries) for s in x.shape], axis=1)
        served = fleet.decode_at("stock", big)       # split by owner, reassembled
        if not np.array_equal(served, svc.decode_at("stock", big)):
            raise SystemExit("fleet answers differ from one instance's")
        m = collect(fleet)
        shards = {i: s.cache.resident_bytes for i, s in m.instances.items()}
        print(f"fleet (3 instances): bit-identical to one instance; "
              f"resident bytes per instance {shards}")

        pending = fleet.submit("stock", big)         # in flight during rebalance
        report = rebalance(fleet, remove=["i2"])     # drain -> move chunks -> evict
        out = fleet.flush()
        if fleet.failed or not np.array_equal(out[pending], served):
            raise SystemExit("rebalance lost or changed a ticket")
        print(f"rebalance 3->2: {report.total_moved} chunks/tiles moved, "
              f"{sum(report.tiles_warmed.values())} tiles handed off warm, "
              f"0 failed tickets")


if __name__ == "__main__":
    main()
