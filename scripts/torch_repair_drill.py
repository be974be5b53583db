#!/usr/bin/env python3
"""End-to-end read-repair drill over a REAL 3-worker socket fleet of the
port (``repro_torch``), as ``scripts/repair_drill.py`` runs it for the JAX
package, at its shape and with its faults.

Three ``repro_torch.fleet.worker`` OS processes serve a chunked payload
(TCDQ held-out block, canaries fully on, replication=2) through two
injected faults:

1. **corruption** — worker ``w0`` starts with ``--debug-corrupt-chunk``
   flipping chunk 1's CRC.  Drill traffic keeps answering bitwise as one
   resident ``CodecService`` with ZERO failed tickets (replica failover);
   the :class:`RepairController` restores the chunk byte-exactly from a
   donor replica and swaps the epoch, after which no quarantine is left.
2. **quality** — a deterministic fitness regression is injected into
   chunk 2's entry range on every replica (the ``inject_fault`` wire
   verb).  The canary must breach, the controller re-compresses the range
   online with ``NTTDStreamFitter`` on ``--device`` (the training kernels
   on the card) and lands it as a patch overlay, and the post-repair
   canary must CLEAR the SLO — while every entry outside the range stays
   bitwise equal throughout.

The workers, the resident service and the refit run on ``--device``
(CUDA unless given).  The trace (``repair_trace.json``, with the
``repair.*`` spans) and the numbers (``repair_drill.json``:
``time_to_repair_s`` of each repair, the refit's entries/s and fitness)
go into ``--out`` (default ``build/repair_drill`` at the root of the
checkout); nothing is written under ``benchmarks/``.

    PYTHONPATH=src python scripts/torch_repair_drill.py               # on the card
    PYTHONPATH=src python scripts/torch_repair_drill.py --device cpu --out /tmp/drill
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.codecs import container, get_codec  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    FleetFrontend,
    RepairController,
    SocketTransport,
    collect,
)
from repro_torch.obs.report import load_trace, report_dict  # noqa: E402
from repro_torch.serve.codec_service import CodecService  # noqa: E402
from repro_torch.stream import sample_heldout, write_chunked  # noqa: E402
from torch_slo_smoke import start_workers  # noqa: E402

SHAPE = (16, 12, 8)
CANARY_MIN_FITNESS = 0.95
NOISE_SIGMA = 0.4
OUT = os.path.join(ROOT, "build", "repair_drill")


class _RecordingController(RepairController):
    """Keeps each refit's range shape and folding, for the drill's report."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.refits: list[dict] = []

    def _refit(self, sub):
        enc, seen = super()._refit(sub)
        spec = enc.ct.spec
        self.refits.append({"range_shape": list(sub.shape),
                            "folded_shape": list(spec.folded_shape),
                            "middle_cores": spec.d_prime - 2,
                            "device": str(enc.ct.device)})
        return enc, seen


def _payload(tmp: str) -> str:
    # genuinely low-TT-rank truth (separable harmonics): the base fit must
    # be near-exact so the only fitness regressions are the injected ones
    i, j, k = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    x = (np.sin(0.3 * i) * np.cos(0.2 * j) * np.sin(0.15 * k)
         + 0.5 * np.cos(0.1 * i) * np.sin(0.25 * j) * np.cos(0.3 * k)).astype(np.float32)
    enc = get_codec("ttd").fit(x, max_rank=4)
    path = f"{tmp}/repair_drill.tcdc"
    write_chunked(path, enc, chunk_bytes=1024, heldout=sample_heldout(x, 128, seed=3))
    return path


def _batches(n=6, per=400):
    rng = np.random.default_rng(2)
    return [np.stack([rng.integers(0, s, per) for s in SHAPE], axis=1) for _ in range(n)]


def run(device: str | None = None, out: str = OUT) -> dict:
    """The drill; raises AssertionError on any failed check."""
    t_start = time.perf_counter()
    spawn_s: dict[str, float] = {}

    def factory(iid: str):
        # w0 carries the CRC-flip fault from birth (the CLI flag path);
        # the quality fault is injected later over the wire
        t = time.perf_counter()
        transport = SocketTransport.spawn(
            iid, timeout=60.0, canary_fraction=1.0, canary_min_fitness=CANARY_MIN_FITNESS,
            debug_corrupt_chunk=["e:1"] if iid == "w0" else None, device=device)
        transport.ping()
        spawn_s[iid] = time.perf_counter() - t
        return transport

    with tempfile.TemporaryDirectory() as tmp:
        path = _payload(tmp)
        pristine = open(path, "rb").read()
        _, chunks, _ = container.container_index(path)
        assert len(chunks) >= 3, f"drill needs >= 3 chunks, got {len(chunks)}"
        batches = _batches()
        single = CodecService(device=device)
        single.load_stream("e", path, tile_entries=256)
        reference = [single.decode_at("e", idx) for idx in batches]

        obs.enable_tracing()
        obs.clear_events()
        fleet = FleetFrontend(start_workers(factory, ["w0", "w1", "w2"]), transport_factory=factory,
                              replication=2, device=device)
        ctl = _RecordingController(fleet)
        try:
            fleet.load_stream("e", path, tile_entries=256)

            def serve_round(check_mask=None):
                """One traffic wave; every answer held against the resident
                reference (optionally on a sub-mask of entries) and zero
                tickets may fail."""
                for k, idx in enumerate(batches):
                    got = fleet.decode_at("e", idx)
                    keep = slice(None) if check_mask is None else check_mask(idx)
                    assert np.array_equal(got[keep], reference[k][keep]), (
                        f"answer {k} diverged from the resident reference")
                assert not fleet.failed, f"failed tickets: {fleet.failed}"

            # ---- phase 1: CRC-flipped chunk on w0 ------------------------
            serve_round()  # bitwise THROUGH the corruption
            corrupt = [t for t in ctl.poll() if t.kind == "corruption"]
            assert corrupt, "no corruption ticket from poll"
            assert corrupt[0].chunk == 1 and corrupt[0].payload == "e"
            assert obs.events("decode_failover"), "no failover event"
            reports = ctl.run()
            assert all(r.ok for r in reports), [r.error for r in reports]
            restore = next(r for r in reports if r.kind == "corruption")
            assert open(path, "rb").read() == pristine, "the restore is not byte-exact"
            serve_round()  # bitwise AFTER the repair
            assert not ctl.poll(), "tickets remain after corruption repair"
            assert not any(t.stats().get("quarantine") for t in fleet.transports.values())

            # ---- phase 2: fitness regression in chunk 2's range ----------
            lo, hi = int(chunks[2].entry_start), int(chunks[2].entry_stop)
            for t in fleet.transports.values():
                t.inject_fault("e", {"kind": "fitness_noise", "entry_start": lo,
                                     "entry_stop": hi, "sigma": NOISE_SIGMA, "seed": 5})

            def untouched(idx):
                flat = np.ravel_multi_index(tuple(idx.T), SHAPE)
                return (flat < lo) | (flat >= hi)

            quality = []
            for _ in range(8):  # canary sampling is per-call deterministic
                serve_round(check_mask=untouched)
                quality = [t for t in ctl.poll() if t.kind == "quality"]
                if quality:
                    break
            assert quality, "canary never fired on the injected regression"
            assert (quality[0].entry_start, quality[0].entry_stop) == (lo, hi)
            reports = ctl.run()
            refit = next(r for r in reports if r.kind == "quality")
            assert refit.ok, refit.error
            assert refit.fitness_after > refit.fitness_before, (
                refit.fitness_before, refit.fitness_after)
            serve_round(check_mask=untouched)

            # the post-repair canary must clear the SLO on every live member
            cleared, states = False, []
            for _ in range(8):
                serve_round(check_mask=untouched)
                states = [t.stats()["canary"].get("e", {})
                          for iid, t in fleet.transports.items() if iid not in fleet.excluded]
                checked = [s for s in states if s.get("checks", 0) > 0]
                if checked and all(s.get("breaches", 0) == 0
                                   and s.get("last_fitness", 0.0) >= CANARY_MIN_FITNESS
                                   for s in checked):
                    cleared = True
                    break
            assert cleared, f"post-repair canary did not clear: {states}"
            final_metrics = collect(fleet).as_dict()
        finally:
            fleet.close()
            obs.disable_tracing()

        os.makedirs(out, exist_ok=True)
        trace = os.path.join(out, "repair_trace.json")
        obs.export_chrome_trace(trace, metrics=final_metrics)
        doc = report_dict(load_trace(trace), top=5)
        stages = {r["stage"] for r in doc["stages"]}
        for want in ("repair.corruption", "repair.quality"):
            assert want in stages, f"missing {want} span in {sorted(stages)}"
        obs.get_recorder().clear()
    result = {
        "drill": "repair_drill", "shape": list(SHAPE), "device": str(fleet.device),
        "runs": [
            {"kind": "corruption", "time_to_repair_s": restore.elapsed_s,
             "chunks_restored": restore.chunks_restored, "donor": restore.donors.get(1)},
            {"kind": "quality", "time_to_repair_s": refit.elapsed_s,
             "refit_entries": refit.refit_entries,
             "refit_entries_per_sec": refit.refit_entries_per_sec,
             "fitness_before": refit.fitness_before, "fitness_after": refit.fitness_after,
             "entry_range": [lo, hi], **ctl.refits[-1]},
        ],
        "spawn_s": spawn_s, "failed_tickets": 0, "bitwise_outside_range": True,
        "slo_cleared": True,
        "trace": trace, "seconds": time.perf_counter() - t_start,
    }
    with open(os.path.join(out, "repair_drill.json"), "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="where the workers, the reference service and the refit run "
                        "(default: CUDA)")
    parser.add_argument("--out", default=OUT,
                        help="directory for repair_trace.json and repair_drill.json")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
