"""``python -m repro_torch.fleet.worker`` — one fleet member as an OS
process, as ``python -m repro.fleet.worker``.

The worker binds a TCP or Unix socket, accepts ONE frontend connection,
and runs one owned :class:`~repro_torch.serve.codec_service.CodecService` that
mmaps whatever shared container-v3 files the frontend registers over the
wire (``OP_LOAD`` carries a *path*, never payload bytes — workers on the
same host share the page cache, workers across hosts need a shared
filesystem).  It answers the transport protocol defined in
``repro_torch.fleet.transport``:

- pipelined ``OP_SUBMIT`` frames queue requests on the service (submit-
  time errors are held and reported at the next flush, keyed by the
  frontend's request id);
- ``OP_FLUSH`` resolves everything queued through the service's
  coalescing path and answers every outstanding request id exactly once
  — result array or error string — in request-id order; when the
  frontend requests tracing (``FLUSH_WANT_SPANS``) the worker's span
  recorder follows that request and its buffered spans ride the reply,
  timestamped on this process's clock for the frontend to re-base;
- the rebalance verbs (``OP_SET_OWNERSHIP``/``OP_EXPORT_TILES``/
  ``OP_ADMIT_TILE``/``OP_DROP_UNOWNED``) make cross-process warm
  handoff work identically to the in-process path.

The worker exits when the frontend disconnects (EOF), on ``OP_SHUTDOWN``,
or on a framing violation (a truncated or oversized frame is a protocol
error — the worker answers nothing it cannot parse and closes, so the
frontend's timeout converts it into an excluded instance instead of a
hang).

The service runs on ``--device`` (CUDA unless given).  It is built
before the socket is bound, so without the flag and without a card the
worker raises before it prints ``READY`` and exits non-zero, which
``SocketTransport.spawn`` reports as a failure.

    python -m repro_torch.fleet.worker --listen unix:/tmp/pod0.sock
    python -m repro_torch.fleet.worker --listen tcp:127.0.0.1:7070 --cache-bytes 268435456
    python -m repro_torch.fleet.worker --listen unix:/tmp/pod0.sock --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import time

from repro_torch import obs
from repro_torch.fleet.transport import (
    FLUSH_HAS_CTX,
    FLUSH_WANT_SPANS,
    OP_ADMIT_TILE,
    OP_DROP_UNOWNED,
    OP_EXPORT_CHUNK,
    OP_EXPORT_TILES,
    OP_FLUSH,
    OP_INJECT_FAULT,
    OP_LOAD,
    OP_PAYLOADS,
    OP_PING,
    OP_REFRESH,
    OP_SET_OWNERSHIP,
    OP_SHAPE,
    OP_SHUTDOWN,
    OP_STATS,
    OP_SUBMIT,
    OP_UNLOAD,
    ProtocolError,
    Reader,
    ST_ERROR,
    ST_OK,
    Writer,
    pack_spans,
    parse_address,
    recv_frame,
    send_frame,
    unpack_ownership,
)
from repro_torch.serve.codec_service import CodecService

#: was tracing enabled by THIS process's environment (vs a frontend
#: request)? env-enabled tracing never turns off mid-session
_ENV_TRACE = os.environ.get("REPRO_TRACE", "") not in ("", "0")


def parse_fault_flags(
    corrupt: list[str] | None, noise: list[str] | None
) -> dict[str, list[dict]]:
    """Parse the ``--debug-corrupt-chunk NAME:CHUNK`` and
    ``--debug-fitness-noise NAME:LO:HI:SIGMA[:SEED]`` CLI specs into
    payload-name-keyed ``CodecService.inject_fault`` dicts, so the drills'
    workers and an in-process service take ONE injection surface."""
    out: dict[str, list[dict]] = {}
    for spec in corrupt or []:
        name, _, cid = spec.rpartition(":")
        if not name or not cid.lstrip("-").isdigit():
            raise ValueError(
                f"bad --debug-corrupt-chunk {spec!r} (want NAME:CHUNK)"
            )
        out.setdefault(name, []).append(
            {"kind": "corrupt_chunk", "chunk": int(cid)}
        )
    for spec in noise or []:
        parts = spec.split(":")
        if len(parts) not in (4, 5):
            raise ValueError(
                f"bad --debug-fitness-noise {spec!r} "
                "(want NAME:LO:HI:SIGMA[:SEED])"
            )
        fault = {
            "kind": "fitness_noise",
            "entry_start": int(parts[1]),
            "entry_stop": int(parts[2]),
            "sigma": float(parts[3]),
        }
        if len(parts) == 5:
            fault["seed"] = int(parts[4])
        out.setdefault(parts[0], []).append(fault)
    return out


class WorkerState:
    """One connection's request state: the owned service plus the
    pipelined submits awaiting the next flush."""

    def __init__(
        self,
        service: CodecService,
        flush_sleep_s: float = 0.0,
        fault_specs: dict[str, list[dict]] | None = None,
    ):
        self.service = service
        #: request id -> service ticket, in arrival order
        self.pending: dict[int, int] = {}
        #: request id -> submit-time error message, reported at flush
        self.deferred: dict[int, str] = {}
        self.shutdown = False
        #: latency fault injector (--debug-flush-sleep-ms): every flush
        #: sleeps this long FIRST, so an SLO drill can breach a p99 target
        #: without touching the service's decode path (answers stay
        #: trivially bit-identical)
        self.flush_sleep_s = flush_sleep_s
        #: CLI fault specs (parse_fault_flags), installed on a payload the
        #: moment OP_LOAD registers it — consumed once per name; a later
        #: OP_REFRESH on the payload clears the fault for good, matching
        #: "the repair epoch starts clean"
        self.fault_specs = fault_specs or {}


def _handle(state: WorkerState, op: int, rid: int, r: Reader) -> bytes | None:
    """Dispatch one request; returns the OK-response body, or None for
    pipelined ops that answer nothing until flush."""
    svc = state.service
    if op == OP_PING:
        return b""
    if op == OP_LOAD:
        name, path, tile = r.str(), r.str(), r.i64()
        svc.load_stream(name, path, tile_entries=None if tile < 0 else tile)
        for fault in state.fault_specs.pop(name, []):
            svc.inject_fault(name, fault)
        return b""
    if op == OP_UNLOAD:
        svc.unload(r.str())
        return b""
    if op == OP_SHAPE:
        shape = svc.shape_of(r.str())
        w = Writer().u8(len(shape))
        for s in shape:
            w.u64(int(s))
        return w.bytes()
    if op == OP_SUBMIT:
        name = r.str()
        version = r.i64()  # -1 encodes version=None (single-tensor payloads)
        arr = r.array()
        ctx = (r.u64(), r.u64()) if not r.eof() else None
        try:
            with obs.remote_context(ctx):
                state.pending[rid] = svc.submit(
                    name, arr, version=None if version < 0 else version
                )
        except Exception as e:  # noqa: BLE001 — deferred to flush, per protocol
            state.deferred[rid] = f"{type(e).__name__}: {e}"
        return None
    if op == OP_FLUSH:
        if state.flush_sleep_s > 0:
            time.sleep(state.flush_sleep_s)
        flags = 0 if r.eof() else r.u8()
        ctx = (r.u64(), r.u64()) if flags & FLUSH_HAS_CTX else None
        want_spans = bool(flags & FLUSH_WANT_SPANS)
        # the worker's recorder follows the frontend's request, so tracing
        # toggled mid-session on the frontend takes effect here too;
        # REPRO_TRACE in the worker's own env keeps it on regardless
        if want_spans and not obs.enabled():
            obs.enable_tracing()
        elif not want_spans and obs.enabled() and not _ENV_TRACE:
            obs.disable_tracing()
        with obs.remote_context(ctx):
            out = svc.flush()
        results: list[tuple[int, object]] = []
        failures: list[tuple[int, str]] = list(state.deferred.items())
        for srid, ticket in state.pending.items():
            if ticket in out:
                results.append((srid, out[ticket]))
            else:
                err = svc.failed.get(ticket)
                failures.append(
                    (srid, f"{type(err).__name__}: {err}" if err else "ticket vanished")
                )
        state.pending = {}
        state.deferred = {}
        w = Writer().u32(len(results))
        for srid, values in sorted(results, key=lambda t: t[0]):
            w.u64(srid).array(values)
        w.u32(len(failures))
        for srid, msg in sorted(failures, key=lambda t: t[0]):
            w.u64(srid).str(msg)
        if want_spans:
            w.u8(1)
            pack_spans(w, obs.get_recorder().drain())
        return w.bytes()
    if op == OP_STATS:
        return Writer().blob(
            json.dumps(svc.stats()).encode("utf-8")
        ).bytes()
    if op == OP_SET_OWNERSHIP:
        name = r.str()
        svc.set_ownership(name, unpack_ownership(r))
        return b""
    if op == OP_EXPORT_TILES:
        tiles = svc.export_tiles(r.str())
        w = Writer().u32(len(tiles))
        for tid, values in tiles.items():
            w.u64(int(tid)).array(values)
        return w.bytes()
    if op == OP_ADMIT_TILE:
        name, tid = r.str(), r.u64()
        return Writer().u8(1 if svc.admit_tile(name, tid, r.array()) else 0).bytes()
    if op == OP_DROP_UNOWNED:
        return Writer().u64(svc.drop_unowned(r.str())).bytes()
    if op == OP_REFRESH:
        svc.refresh(r.str())
        return b""
    if op == OP_EXPORT_CHUNK:
        raw = svc.export_chunk(r.str(), r.u64())
        w = Writer().u8(0 if raw is None else 1)
        if raw is not None:
            w.blob(raw)
        return w.bytes()
    if op == OP_INJECT_FAULT:
        name = r.str()
        svc.inject_fault(name, json.loads(r.blob().decode("utf-8")))
        return b""
    if op == OP_PAYLOADS:
        names = svc.payloads()
        w = Writer().u16(len(names))
        for name in names:
            w.str(name)
        return w.bytes()
    if op == OP_SHUTDOWN:
        state.shutdown = True
        return b""
    raise ProtocolError(f"unknown opcode {op}")


def serve_connection(
    conn: socket.socket,
    service: CodecService,
    flush_sleep_s: float = 0.0,
    fault_specs: dict[str, list[dict]] | None = None,
) -> None:
    """Run the request loop until EOF, shutdown, or a framing violation."""
    state = WorkerState(service, flush_sleep_s, fault_specs)
    while not state.shutdown:
        try:
            payload = recv_frame(conn)
        except ProtocolError as e:
            # half a frame is unanswerable (no parseable rid) — log, close
            print(f"repro_torch.fleet.worker: protocol error: {e}", file=sys.stderr)
            return
        if payload is None:  # frontend disconnected
            return
        if len(payload) < 9:
            print("repro_torch.fleet.worker: short request frame", file=sys.stderr)
            return
        op, rid = struct.unpack("<BQ", payload[:9])
        try:
            body = _handle(state, op, rid, Reader(payload[9:]))
        except ProtocolError as e:
            print(f"repro_torch.fleet.worker: protocol error: {e}", file=sys.stderr)
            return
        except Exception as e:  # noqa: BLE001 — service error -> error response
            msg = f"{type(e).__name__}: {e}"
            send_frame(conn, struct.pack("<BQ", ST_ERROR, rid) + Writer().str(msg).bytes())
            continue
        if body is not None:
            send_frame(conn, struct.pack("<BQ", ST_OK, rid) + body)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="repro_torch.fleet.worker",
        description="one fleet member: a CodecService behind a socket",
    )
    parser.add_argument(
        "--listen", required=True, help="unix:/path or tcp:host:port (port 0 = ephemeral)"
    )
    parser.add_argument("--cache-bytes", type=int, default=None)
    parser.add_argument("--max-batch", type=int, default=65536)
    parser.add_argument(
        "--device", default=None,
        help="where the service decodes (default: CUDA; raises without it)",
    )
    parser.add_argument(
        "--prefetch",
        action="store_true",
        help="overlap chunk reads / tile-input builds with decode compute",
    )
    parser.add_argument(
        "--canary-fraction", type=float, default=0.0,
        help="fraction of decode_at calls that run an online fitness canary",
    )
    parser.add_argument("--canary-seed", type=int, default=0)
    parser.add_argument(
        "--canary-min-fitness", type=float, default=None,
        help="emit quality_breach events below this fitness",
    )
    parser.add_argument(
        "--debug-flush-sleep-ms", type=float, default=0.0,
        help="TESTING ONLY: sleep before every flush (latency fault injection)",
    )
    parser.add_argument(
        "--debug-corrupt-chunk", action="append", default=None,
        metavar="NAME:CHUNK",
        help="TESTING ONLY: fail the named payload chunk's CRC on read "
        "(repeatable; applied when the payload loads)",
    )
    parser.add_argument(
        "--debug-fitness-noise", action="append", default=None,
        metavar="NAME:LO:HI:SIGMA[:SEED]",
        help="TESTING ONLY: add seeded noise to served values in the flat "
        "entry range (repeatable; applied when the payload loads)",
    )
    args = parser.parse_args(argv)
    fault_specs = parse_fault_flags(
        args.debug_corrupt_chunk, args.debug_fitness_noise
    )

    service = CodecService(
        max_batch=args.max_batch,
        cache_bytes=args.cache_bytes,
        prefetch=args.prefetch,
        canary_fraction=args.canary_fraction,
        canary_seed=args.canary_seed,
        canary_min_fitness=args.canary_min_fitness,
        device=args.device,
    )
    family, addr = parse_address(args.listen)
    sock = socket.socket(family, socket.SOCK_STREAM)
    if family == socket.AF_INET:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(addr)
    sock.listen(1)
    bound = sock.getsockname()
    shown = f"tcp:{bound[0]}:{bound[1]}" if family == socket.AF_INET else f"unix:{bound}"
    print(f"READY {shown}", flush=True)

    try:
        conn, _ = sock.accept()
        with conn:
            serve_connection(
                conn, service,
                flush_sleep_s=args.debug_flush_sleep_ms / 1e3,
                fault_specs=fault_specs,
            )
    finally:
        sock.close()
        if family == socket.AF_UNIX:
            try:
                os.unlink(addr)
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
