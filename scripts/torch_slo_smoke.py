#!/usr/bin/env python3
"""End-to-end SLO/controller drill over a REAL 3-worker socket fleet of the
port (``repro_torch``), as ``scripts/slo_smoke.py`` runs it for the JAX
package, at its shape and with its fault.

Three ``repro_torch.fleet.worker`` OS processes serve a chunked payload
(with a TCDQ held-out block, canaries fully on) while every initial
worker carries an injected ``--debug-flush-sleep-ms`` latency fault.  A
:class:`FleetController` polls real ``collect()`` samples:

1. drill traffic breaches the p99 objective -> the controller admits a
   sleep-free standby (``s0``), live, behind the drain barrier;
2. traffic stops -> the idle streak retires ``s0`` again;
3. throughout, every answer is bitwise equal to one resident
   ``CodecService`` and zero tickets fail;
4. the whole drill is traced — controller decisions must show up as
   ``controller.*`` spans in the report and as ``controller_decision``
   events — and the live fleet is scraped once through ``MetricsServer``.

Every worker and the resident service run on ``--device`` (CUDA unless
given).  ``run()`` returns the drill's numbers; the command line prints
them as one JSON line.

    PYTHONPATH=src python scripts/torch_slo_smoke.py               # on the card
    PYTHONPATH=src python scripts/torch_slo_smoke.py --device cpu
"""
import argparse
import concurrent.futures
import json
import os
import sys
import tempfile
import time
import urllib.request

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.codecs import get_codec  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    ControllerConfig,
    FleetController,
    FleetFrontend,
    SocketTransport,
    collect,
)
from repro_torch.obs.exposition import render_exposition  # noqa: E402
from repro_torch.obs.report import load_trace, report_dict  # noqa: E402
from repro_torch.obs.serve_metrics import MetricsServer  # noqa: E402
from repro_torch.serve.codec_service import CodecService  # noqa: E402
from repro_torch.stream import sample_heldout, write_chunked  # noqa: E402

SHAPE = (16, 16, 8)
SLEEP_MS = 30.0  # injected per-flush latency fault on the initial workers
N_TICKS_MAX = 12


def _payload(tmp: str) -> str:
    x = np.random.default_rng(0).random(SHAPE).astype(np.float32)
    enc = get_codec("ttd").fit(x, max_rank=4)
    path = f"{tmp}/slo_smoke.tcdc"
    write_chunked(path, enc, chunk_bytes=1024, heldout=sample_heldout(x, 128, seed=0))
    return path


def _batches(n=8, per=100):
    rng = np.random.default_rng(2)
    return [np.stack([rng.integers(0, s, per) for s in SHAPE], axis=1) for _ in range(n)]


def start_workers(factory, iids) -> dict:
    """Start workers together (each spends seconds importing
    torch and opening its CUDA context); if one fails, close the others."""
    with concurrent.futures.ThreadPoolExecutor(len(iids)) as pool:
        futures = {iid: pool.submit(factory, iid) for iid in iids}
    failed = [f.exception() for f in futures.values() if f.exception() is not None]
    if failed:
        for f in futures.values():
            if f.exception() is None:
                f.result().close()
        raise failed[0]
    return {iid: f.result() for iid, f in futures.items()}


def run(device: str | None = None) -> dict:
    """The drill; raises AssertionError on any failed check."""
    t_start = time.perf_counter()
    spawn_s: dict[str, float] = {}

    def factory(iid: str):
        # initial workers (w*) carry the latency fault; standbys (s*) do not
        t = time.perf_counter()
        transport = SocketTransport.spawn(
            iid, timeout=30.0, canary_fraction=1.0, device=device,
            debug_flush_sleep_ms=SLEEP_MS if iid.startswith("w") else 0.0,
        )
        transport.ping()
        spawn_s[iid] = time.perf_counter() - t
        return transport

    with tempfile.TemporaryDirectory() as tmp:
        path = _payload(tmp)
        batches = _batches()
        single = CodecService(device=device)
        single.load_stream("e", path, tile_entries=256)
        reference = [single.decode_at("e", idx) for idx in batches]

        obs.enable_tracing()
        obs.clear_events()
        fleet = FleetFrontend(start_workers(factory, ["w0", "w1", "w2"]), transport_factory=factory,
                              device=device)
        ctl = FleetController(fleet, ControllerConfig(
            p99_target_ms=5.0,
            breach_evals=2, clear_evals=1,
            idle_flushes_per_eval=1.0, idle_evals=2, cooldown_evals=1,
            min_instances=3, max_instances=4,
        ))
        try:
            fleet.load_stream("e", path, tile_entries=256)

            def serve_round():
                for k, idx in enumerate(batches):
                    out = fleet.decode_at("e", idx)
                    assert np.array_equal(out, reference[k]), (
                        f"answer {k} diverged from the resident reference")
                assert not fleet.failed, f"failed tickets: {fleet.failed}"

            # phase 1: drill traffic under the latency fault -> scale up
            scaled_up_at = None
            for tick in range(N_TICKS_MAX):
                serve_round()
                if ctl.step().action == "scale_up":
                    scaled_up_at = tick
                    break
            assert scaled_up_at is not None, (
                f"no scale_up in {N_TICKS_MAX} ticks: {[d.action for d in ctl.decisions]}")
            assert "s0" in fleet.transports and len(fleet.transports) == 4
            serve_round()  # answers still bitwise on the 4-wide ring

            # one live scrape through the exposition HTTP path
            snap = collect(fleet).as_dict()
            with MetricsServer(lambda: render_exposition(fleet=snap)) as srv:
                host, port = srv.address
                page = urllib.request.urlopen(
                    f"http://{host}:{port}/metrics", timeout=10).read().decode()
            assert "repro_fleet_instances 4" in page, page[:400]
            assert "repro_fleet_canary_checks" in page, page[:400]
            assert snap["canary"]["e"]["checks"] > 0

            # phase 2: stop traffic -> idle streak retires the standby
            scaled_down_at = None
            for tick in range(N_TICKS_MAX):
                if ctl.step().action == "scale_down":
                    scaled_down_at = tick
                    break
            assert scaled_down_at is not None, (
                f"no scale_down in {N_TICKS_MAX} idle ticks: "
                f"{[d.action for d in ctl.decisions]}")
            assert "s0" not in fleet.transports and len(fleet.transports) == 3
            serve_round()  # and still bitwise after the retire
            final_metrics = collect(fleet).as_dict()
        finally:
            fleet.close()
            obs.disable_tracing()

        trace = f"{tmp}/slo_smoke_trace.json"
        obs.export_chrome_trace(trace, metrics=final_metrics)
        doc = report_dict(load_trace(trace), top=5)
        stages = {r["stage"] for r in doc["stages"]}
        for want in ("controller.step", "controller.scale_up", "controller.scale_down"):
            assert want in stages, f"missing {want} span in {sorted(stages)}"
        acts = [e["action"] for e in obs.events("controller_decision")]
        assert acts.count("scale_up") == 1 and acts.count("scale_down") == 1
        obs.get_recorder().clear()
    return {"drill": "slo_smoke", "shape": list(SHAPE), "sleep_ms": SLEEP_MS,
            "scale_up_tick": scaled_up_at, "scale_down_tick": scaled_down_at,
            "decisions": acts, "canary_checks": final_metrics["canary"]["e"]["checks"],
            "decode_p99_ms": final_metrics["decode_p99_ms"], "spawn_s": spawn_s,
            "failed_tickets": 0, "bitwise": True, "spans": doc["spans"],
            "seconds": time.perf_counter() - t_start}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="where the workers and the reference service decode "
                        "(default: CUDA)")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
