"""``python -m repro_torch.obs.serve_metrics`` — scrape endpoint for repro
metrics, as ``python -m repro.obs.serve_metrics``.

:class:`MetricsServer` wraps any zero-argument PROVIDER returning
Prometheus text (usually a closure over :func:`render_exposition`) in a
threaded ``GET /metrics`` HTTP server — the piece that makes a live
fleet scrapeable:

    from repro_torch import fleet as flt, obs
    from repro_torch.obs.exposition import render_exposition
    from repro_torch.obs.serve_metrics import MetricsServer

    srv = MetricsServer(
        lambda: render_exposition(
            fleet.metrics, fleet=flt.collect(fleet).as_dict()
        ),
        port=9091,
    )
    srv.start()          # GET http://127.0.0.1:9091/metrics

The CLI serves a SNAPSHOT file instead (a fleet ``as_dict`` JSON, a
``MetricsRegistry.as_dict`` JSON, or a trace export whose
``repro_metrics`` key embeds one) — rendered once per scrape, so a
dashboard can point at benchmark artifacts:

    python -m repro_torch.obs.serve_metrics BENCH_fleet_snapshot.json --port 9091
    python -m repro_torch.obs.serve_metrics trace.json --once   # print and exit
"""
from __future__ import annotations

import argparse
import http.server
import json
import sys
import threading
from typing import Callable

from repro_torch.obs.exposition import render_exposition

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Threaded HTTP server answering ``GET /metrics`` (and ``/``) with
    whatever the provider returns; anything else is a 404."""

    def __init__(
        self,
        provider: Callable[[], str],
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.provider = provider
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = outer.provider().encode("utf-8")
                except Exception as e:  # noqa: BLE001 — scrape must not kill the server
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        """(host, bound port) — port is concrete even when 0 was asked."""
        return self._httpd.server_address[:2]

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-metrics", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def _snapshot_provider(path: str) -> Callable[[], str]:
    """Classify a snapshot file by shape and build its render closure.
    Re-reads per scrape, so pointing at a file a benchmark rewrites
    live-updates the page."""

    def render() -> str:
        with open(path) as f:
            doc = json.load(f)
        if "traceEvents" in doc:  # a trace export; metrics ride inside
            fleet = doc.get("repro_metrics")
            if not fleet:
                raise ValueError(f"{path}: trace has no repro_metrics snapshot")
            return render_exposition(fleet=fleet)
        if "counters" in doc or "gauges" in doc or "histograms" in doc:
            return render_exposition(registry=doc)
        if "instances" in doc or "fleet" in doc:
            return render_exposition(fleet=doc)
        raise ValueError(
            f"{path}: not a fleet/registry/trace metrics snapshot"
        )

    return render


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="repro_torch.obs.serve_metrics",
        description="serve a metrics snapshot file as a Prometheus endpoint",
    )
    parser.add_argument(
        "snapshot",
        help="fleet as_dict JSON, MetricsRegistry as_dict JSON, or a trace "
        "export with an embedded repro_metrics snapshot",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9091)
    parser.add_argument(
        "--once", action="store_true",
        help="print the exposition to stdout and exit (no server)",
    )
    args = parser.parse_args(argv)

    provider = _snapshot_provider(args.snapshot)
    if args.once:
        try:
            sys.stdout.write(provider())
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"repro_torch.obs.serve_metrics: {e}", file=sys.stderr)
            return 1
        return 0
    srv = MetricsServer(provider, host=args.host, port=args.port)
    host, port = srv.address
    print(f"serving {args.snapshot} at http://{host}:{port}/metrics", flush=True)
    try:
        srv.start()
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
