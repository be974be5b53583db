"""Pluggable fleet transports: in-process, or one OS process per pod, as
in ``repro.fleet.transport``; the wire protocol is the reference's, byte
for byte, so a port frontend drives a reference worker and the other way
round.

The frontend once fanned out to ``CodecService`` objects held in its own
process; this module puts a :class:`Transport` protocol between the
frontend and the instance so each fleet member can instead run as a
separate worker process (``python -m repro_torch.fleet.worker``) that mmaps
the shared container-v3 file and owns one ``CodecService``.

Two implementations:

- :class:`LocalTransport` wraps an in-process ``CodecService`` on the
  transport's ``device`` (CUDA unless given) — zero serialization, what
  tests and single-host fleets use.
- :class:`SocketTransport` speaks a length-prefixed binary protocol
  (struct framing; arrays ride the container layer's
  ``write_array``/``read_array`` encoding so values stay bit-exact)
  over a TCP or Unix socket to one worker process.  ``submit`` frames
  are pipelined — no per-request round trip — and ``flush`` returns
  every outstanding request id with either its result array or its
  error, in request-id order, so the frontend's reassembly is identical
  to the in-process path.

Failure semantics: request-level errors on the worker (unknown payload,
decode failure) come back as :class:`RemoteError` entries in ``flush``'s
failure map — the instance stays routable.  A dead socket, truncated
frame, or per-request timeout raises :class:`TransportError` and marks
the transport dead; the frontend converts that into a routed
``excluded`` instance instead of a hang.

Wire format (little-endian)::

    frame    := u32 len | payload
    request  := u8 opcode | u64 rid | body
    response := u8 status | u64 rid | body     # status 0 ok, 1 error
    str      := u16 len | utf-8 bytes
    blob     := u32 len | bytes
    array    := container.write_array encoding (dtype | ndim | shape | raw)

Trace-context extension (all fields OPTIONAL and eof-guarded, so bodies
without them parse exactly as before)::

    OP_SUBMIT body  := str name | i64 version | array [| u64 tid | u64 sid]
    OP_FLUSH  body  := [u8 flags [| u64 tid | u64 sid]]   # see FLUSH_*
    OP_FLUSH  reply := ...results/failures... [| u8 has | span_block]
    span_block      := f64 sender_now | u32 n | span*
    span            := str name | u64 trace | u64 span | u64 parent
                       | f64 t0 | f64 t1 | str attrs_json

The (tid, sid) pair is the frontend's ambient trace context — the worker
adopts it so its ``CodecService`` stage spans parent under the
frontend's ``transport.flush`` span; the flush reply ships the worker's
drained spans back with the worker's own monotonic clock so the
frontend can re-base them onto ITS timeline (one stitched trace).
"""
from __future__ import annotations

import io
import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import time
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch import obs
from repro_torch.codecs.container import read_array, write_array
from repro_torch.serve.codec_service import CodecService, Ownership

# -- opcodes ----------------------------------------------------------------
(
    OP_PING,
    OP_LOAD,
    OP_UNLOAD,
    OP_SHAPE,
    OP_SUBMIT,
    OP_FLUSH,
    OP_STATS,
    OP_SET_OWNERSHIP,
    OP_EXPORT_TILES,
    OP_ADMIT_TILE,
    OP_DROP_UNOWNED,
    OP_PAYLOADS,
    OP_SHUTDOWN,
    OP_REFRESH,
    OP_EXPORT_CHUNK,
    OP_INJECT_FAULT,
) = range(16)

ST_OK, ST_ERROR = 0, 1

#: sanity bound on one frame — a length prefix past this is a framing bug
#: (or garbage on the socket), not a real payload
MAX_FRAME_BYTES = 1 << 31


class TransportError(ConnectionError):
    """The transport itself failed (dead worker, timeout, bad framing).
    The frontend reacts by excluding the instance from routing."""


class ProtocolError(TransportError):
    """The byte stream violated the framing rules — truncated frame,
    oversized length prefix, out-of-order response id."""


class RemoteError(RuntimeError):
    """An error raised BY the worker's service (unknown payload, decode
    failure) and shipped back over a healthy connection — the per-ticket
    failure analogue of a local exception, not a transport death."""


# ---------------------------------------------------------------------------
# framing helpers (shared by SocketTransport and repro_torch.fleet.worker)
# ---------------------------------------------------------------------------
def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes | None:
    """One length-prefixed frame; None on clean EOF at a frame boundary."""
    head = _recv_exact(sock, 4, eof_ok=True)
    if head is None:
        return None
    (n,) = struct.unpack("<I", head)
    if n > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {n} exceeds {MAX_FRAME_BYTES}")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int, eof_ok: bool = False) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if eof_ok and not buf:
                return None
            raise ProtocolError(f"truncated frame: got {len(buf)} of {n} bytes")
        buf += chunk
    return bytes(buf)


class Writer:
    """Body builder for one frame — mirrors :class:`Reader` field for field."""

    def __init__(self) -> None:
        self.buf = io.BytesIO()

    def u8(self, v: int) -> "Writer":
        self.buf.write(struct.pack("<B", v))
        return self

    def u16(self, v: int) -> "Writer":
        self.buf.write(struct.pack("<H", v))
        return self

    def u32(self, v: int) -> "Writer":
        self.buf.write(struct.pack("<I", v))
        return self

    def u64(self, v: int) -> "Writer":
        self.buf.write(struct.pack("<Q", v))
        return self

    def i64(self, v: int) -> "Writer":
        self.buf.write(struct.pack("<q", v))
        return self

    def f64(self, v: float) -> "Writer":
        self.buf.write(struct.pack("<d", v))
        return self

    def str(self, s: str) -> "Writer":
        raw = s.encode("utf-8")[:65535]
        self.buf.write(struct.pack("<H", len(raw)) + raw)
        return self

    def blob(self, raw: bytes) -> "Writer":
        self.buf.write(struct.pack("<I", len(raw)) + raw)
        return self

    def array(self, arr: np.ndarray) -> "Writer":
        write_array(self.buf, np.ascontiguousarray(arr))
        return self

    def bytes(self) -> bytes:
        return self.buf.getvalue()


class Reader:
    """Body parser for one frame; every read raises ProtocolError on
    truncation instead of returning short data."""

    def __init__(self, data: bytes) -> None:
        self.buf = io.BytesIO(data)

    def _take(self, n: int) -> bytes:
        raw = self.buf.read(n)
        if len(raw) < n:
            raise ProtocolError(f"truncated body: got {len(raw)} of {n} bytes")
        return raw

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def eof(self) -> bool:
        """True at end of body — the guard for OPTIONAL trailing fields
        (how the trace-context extension stays wire-compatible)."""
        here = self.buf.tell()
        ahead = bool(self.buf.read(1))
        self.buf.seek(here)
        return not ahead

    def str(self) -> str:
        return self._take(self.u16()).decode("utf-8")

    def blob(self) -> bytes:
        return self._take(self.u32())

    def array(self) -> np.ndarray:
        try:
            return read_array(self.buf)
        except ValueError as e:  # container helper's truncation errors
            raise ProtocolError(str(e)) from None


def pack_ownership(w: Writer, ownership: Ownership | None) -> None:
    w.u8(0 if ownership is None else 1)
    if ownership is None:
        return
    for ids in (ownership.chunk_ids, ownership.tile_ids):
        w.u8(0 if ids is None else 1)
        if ids is not None:
            w.u32(len(ids))
            for i in sorted(ids):
                w.u64(i)


def unpack_ownership(r: Reader) -> Ownership | None:
    if not r.u8():
        return None
    sets: list[frozenset[int] | None] = []
    for _ in range(2):
        if r.u8():
            sets.append(frozenset(r.u64() for _ in range(r.u32())))
        else:
            sets.append(None)
    return Ownership(chunk_ids=sets[0], tile_ids=sets[1])


# -- trace-context / span block (flush-reply extension) ---------------------
#: OP_FLUSH body flag bits
FLUSH_WANT_SPANS = 1  # worker should drain its recorder into the reply
FLUSH_HAS_CTX = 2  # a (trace id, span id) pair follows the flags byte


def pack_spans(w: Writer, spans: list[obs.Span]) -> None:
    """Append a span block: ``f64 worker_now | u32 n | span*`` where one
    span is ``str name | u64 trace | u64 span | u64 parent | f64 t0 |
    f64 t1 | str attrs-json``.  ``worker_now`` is the sender's
    ``perf_counter`` AT PACK TIME — the receiver subtracts it from its
    own clock to re-base the timestamps (transit delay only shifts every
    span by the same small amount)."""
    w.f64(time.perf_counter())
    w.u32(len(spans))
    for s in spans:
        w.str(s.name)
        w.u64(s.trace_id).u64(s.span_id).u64(s.parent_id)
        w.f64(s.t_start).f64(s.t_end)
        w.str(json.dumps(s.attrs, default=str) if s.attrs else "")


def unpack_spans(r: Reader) -> tuple[float, list[obs.Span]]:
    """Inverse of :func:`pack_spans` -> (sender's clock, spans)."""
    sender_now = r.f64()
    spans = []
    for _ in range(r.u32()):
        name = r.str()
        tid, sid, pid = r.u64(), r.u64(), r.u64()
        t0, t1 = r.f64(), r.f64()
        raw = r.str()
        spans.append(obs.Span(name, tid, sid, pid, t0, t1,
                              json.loads(raw) if raw else {}))
    return sender_now, spans


def parse_address(address: str) -> tuple[int, str | tuple[str, int]]:
    """``unix:/path`` or ``tcp:host:port`` -> (socket family, connect arg)."""
    if address.startswith("unix:"):
        return socket.AF_UNIX, address[len("unix:"):]
    if address.startswith("tcp:"):
        host, _, port = address[len("tcp:"):].rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad tcp address {address!r} (want tcp:host:port)")
        return socket.AF_INET, (host, int(port))
    raise ValueError(f"bad address {address!r} (want unix:/path or tcp:host:port)")


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------
@runtime_checkable
class Transport(Protocol):
    """What the fleet frontend, rebalancer, and metrics depend on — the
    full surface of one fleet member, location-transparent.

    ``submit`` returns a transport-local ticket and NEVER raises for a
    request-level problem (that failure arrives in ``flush``'s second
    return value, exactly once); it may raise :class:`TransportError`
    when the transport itself is dead.  ``flush`` resolves every
    outstanding ticket to either a result array or an exception.
    """

    instance_id: str

    def load_stream(self, name: str, path: str, *,
                    tile_entries: int | None = None) -> None: ...
    def unload(self, name: str) -> None: ...
    def payloads(self) -> list[str]: ...
    def shape_of(self, name: str) -> tuple[int, ...]: ...
    def submit(
        self, name: str, indices: np.ndarray, version: int | None = None
    ) -> int: ...
    def flush(self) -> tuple[dict[int, np.ndarray], dict[int, Exception]]: ...
    def drain(self) -> None: ...
    def stats(self) -> dict: ...
    def set_ownership(self, name: str, ownership: Ownership | None) -> None: ...
    def export_tiles(self, name: str) -> dict[int, np.ndarray]: ...
    def admit_tile(self, name: str, tid: int, values: np.ndarray) -> bool: ...
    def drop_unowned(self, name: str) -> int: ...
    def refresh(self, name: str) -> None: ...
    def export_chunk(self, name: str, chunk: int) -> bytes | None: ...
    def inject_fault(self, name: str, fault: dict) -> None: ...
    def close(self) -> None: ...


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------
class LocalTransport:
    """The in-process fan-out path behind the protocol: one
    ``CodecService`` on ``device`` (CUDA unless given), no serialization,
    tests stay fast."""

    def __init__(
        self,
        instance_id: str = "local",
        service: CodecService | None = None,
        *,
        cache_bytes: int | None = None,
        max_batch: int = 65536,
        prefetch: bool = False,
        canary_fraction: float = 0.0,
        canary_seed: int = 0,
        canary_min_fitness: float | None = None,
        device=None,
    ):
        self.instance_id = instance_id
        self.service = service or CodecService(
            max_batch=max_batch, cache_bytes=cache_bytes, prefetch=prefetch,
            canary_fraction=canary_fraction, canary_seed=canary_seed,
            canary_min_fitness=canary_min_fitness, device=device,
        )
        self._next_rid = 0
        self._pending: dict[int, int] = {}  # rid -> service ticket
        self._deferred: dict[int, Exception] = {}  # rid -> submit-time error

    def load_stream(self, name, path, *, tile_entries=None) -> None:
        self.service.load_stream(name, path, tile_entries=tile_entries)

    def unload(self, name) -> None:
        self.service.unload(name)

    def payloads(self) -> list[str]:
        return self.service.payloads()

    def shape_of(self, name) -> tuple[int, ...]:
        return self.service.shape_of(name)

    def submit(self, name, indices, version=None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        try:
            self._pending[rid] = self.service.submit(name, indices, version=version)
        except Exception as e:  # noqa: BLE001 — deferred, mirrors the wire
            self._deferred[rid] = e
        return rid

    def flush(self) -> tuple[dict[int, np.ndarray], dict[int, Exception]]:
        out = self.service.flush()
        failures = self._deferred
        self._deferred = {}
        results: dict[int, np.ndarray] = {}
        for rid, ticket in self._pending.items():
            if ticket in out:
                results[rid] = out[ticket]
            else:
                failures[rid] = self.service.failed.get(
                    ticket, RuntimeError("ticket vanished")
                )
        self._pending = {}
        return results, failures

    def drain(self) -> None:
        self.flush()

    def stats(self) -> dict:
        return self.service.stats()

    def set_ownership(self, name, ownership) -> None:
        self.service.set_ownership(name, ownership)

    def export_tiles(self, name) -> dict[int, np.ndarray]:
        return self.service.export_tiles(name)

    def admit_tile(self, name, tid, values) -> bool:
        return self.service.admit_tile(name, tid, values)

    def drop_unowned(self, name) -> int:
        return self.service.drop_unowned(name)

    def refresh(self, name) -> None:
        self.service.refresh(name)

    def export_chunk(self, name, chunk) -> bytes | None:
        return self.service.export_chunk(name, chunk)

    def inject_fault(self, name, fault) -> None:
        self.service.inject_fault(name, fault)

    def close(self) -> None:
        for name in list(self.service.payloads()):
            self.service.unload(name)


# ---------------------------------------------------------------------------
# cross-process
# ---------------------------------------------------------------------------
class SocketTransport:
    """One fleet member behind a TCP/Unix socket.

    ``submit`` writes a pipelined frame (no response until flush);
    every synchronous verb is one request/response round trip whose
    response must echo the request id — an out-of-order or truncated
    response is a :class:`ProtocolError`, and any transport-level
    failure marks the transport dead so every later call fails fast
    instead of hanging on a half-closed socket.
    """

    def __init__(
        self,
        instance_id: str,
        address: str,
        *,
        timeout: float = 30.0,
        connect_timeout: float = 60.0,
        retry_delay: float = 0.1,
        proc: subprocess.Popen | None = None,
    ):
        self.instance_id = instance_id
        self.address = address
        self.timeout = timeout
        self._proc = proc
        self._dead: TransportError | None = None
        self._pending: list[int] = []
        self._next_rid = 0
        #: temp dir spawn() created for the default Unix socket — removed
        #: by close() (the worker only unlinks the socket file itself)
        self._owned_dir: str | None = None
        self._sock = self._connect(connect_timeout, retry_delay)

    # -- connection ---------------------------------------------------------
    def _connect(self, connect_timeout: float, retry_delay: float) -> socket.socket:
        """Retry until the worker is listening (it may still be importing
        torch or opening its CUDA context) or the deadline passes; a worker
        that already exited fails immediately with its return code instead
        of burning the deadline."""
        family, addr = parse_address(self.address)
        deadline = time.monotonic() + connect_timeout
        last: Exception | None = None
        while True:
            if self._proc is not None and self._proc.poll() is not None:
                raise TransportError(
                    f"{self.instance_id}: worker exited with code "
                    f"{self._proc.returncode} before accepting a connection"
                )
            sock = socket.socket(family, socket.SOCK_STREAM)
            sock.settimeout(self.timeout)
            try:
                sock.connect(addr)
                return sock
            except (ConnectionError, FileNotFoundError, socket.timeout, OSError) as e:
                sock.close()
                last = e
                if time.monotonic() >= deadline:
                    raise TransportError(
                        f"{self.instance_id}: could not connect to "
                        f"{self.address} within {connect_timeout}s: {last}"
                    ) from None
                time.sleep(retry_delay)

    def _die(self, err: Exception) -> TransportError:
        self._dead = (
            err
            if isinstance(err, TransportError)
            else TransportError(f"{self.instance_id}: {err}")
        )
        try:
            self._sock.close()
        except OSError:
            pass
        raise self._dead

    def _send(self, op: int, rid: int, body: bytes = b"") -> None:
        if self._dead is not None:
            raise self._dead
        try:
            send_frame(self._sock, struct.pack("<BQ", op, rid) + body)
        except (OSError, ValueError) as e:
            self._die(e)

    def _recv_response(self, rid: int) -> Reader:
        try:
            payload = recv_frame(self._sock)
        except socket.timeout:
            self._die(
                TransportError(
                    f"{self.instance_id}: request timed out after "
                    f"{self.timeout}s — worker presumed dead"
                )
            )
        except (OSError, ProtocolError) as e:
            self._die(e)
        if payload is None:
            self._die(TransportError(f"{self.instance_id}: worker closed the connection"))
        if len(payload) < 9:
            self._die(ProtocolError(f"{self.instance_id}: short response frame"))
        status, got = struct.unpack("<BQ", payload[:9])
        if got != rid:
            self._die(
                ProtocolError(
                    f"{self.instance_id}: response id {got} != request id {rid}"
                )
            )
        r = Reader(payload[9:])
        if status == ST_ERROR:
            raise RemoteError(r.str())
        return r

    def _request(self, op: int, body: bytes = b"") -> Reader:
        rid = self._next_rid
        self._next_rid += 1
        self._send(op, rid, body)
        return self._recv_response(rid)

    # -- spawning -----------------------------------------------------------
    @classmethod
    def spawn(
        cls,
        instance_id: str,
        *,
        cache_bytes: int | None = None,
        max_batch: int = 65536,
        timeout: float = 30.0,
        connect_timeout: float = 120.0,
        address: str | None = None,
        python: str | None = None,
        prefetch: bool = False,
        canary_fraction: float = 0.0,
        canary_seed: int = 0,
        canary_min_fitness: float | None = None,
        debug_flush_sleep_ms: float = 0.0,
        debug_corrupt_chunk: list[str] | None = None,
        debug_fitness_noise: list[str] | None = None,
        device=None,
    ) -> "SocketTransport":
        """Launch ``python -m repro_torch.fleet.worker`` as a child process and
        connect to it.  Default address is a Unix socket in a fresh temp
        dir; pass ``tcp:host:port`` to cross machines.  The returned
        transport owns the process — ``close()`` shuts it down.
        ``debug_flush_sleep_ms`` (latency), ``debug_corrupt_chunk``
        (``NAME:CHUNK`` entries) and ``debug_fitness_noise``
        (``NAME:LO:HI:SIGMA[:SEED]`` entries) are the worker's fault
        injectors for SLO/repair drills; leave unset outside tests.
        ``device`` goes to the worker as ``--device``; without it the
        worker serves on CUDA and exits non-zero when there is none, which
        this call reports as a :class:`TransportError`."""
        sock_dir = None
        if address is None:
            sock_dir = tempfile.mkdtemp(prefix="repro-fleet-")
            address = f"unix:{os.path.join(sock_dir, instance_id + '.sock')}"
        src_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        cmd = [
            python or sys.executable,
            "-m",
            "repro_torch.fleet.worker",
            "--listen",
            address,
            "--max-batch",
            str(max_batch),
        ]
        if cache_bytes is not None:
            cmd += ["--cache-bytes", str(cache_bytes)]
        if device is not None:
            cmd += ["--device", str(device)]
        if prefetch:
            cmd += ["--prefetch"]
        if canary_fraction:
            cmd += ["--canary-fraction", str(canary_fraction)]
        if canary_seed:
            cmd += ["--canary-seed", str(canary_seed)]
        if canary_min_fitness is not None:
            cmd += ["--canary-min-fitness", str(canary_min_fitness)]
        if debug_flush_sleep_ms:
            cmd += ["--debug-flush-sleep-ms", str(debug_flush_sleep_ms)]
        for spec in debug_corrupt_chunk or []:
            cmd += ["--debug-corrupt-chunk", spec]
        for spec in debug_fitness_noise or []:
            cmd += ["--debug-fitness-noise", spec]
        proc = subprocess.Popen(cmd, env=env)
        try:
            t = cls(
                instance_id,
                address,
                timeout=timeout,
                connect_timeout=connect_timeout,
                proc=proc,
            )
        except TransportError:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if sock_dir is not None:
                shutil.rmtree(sock_dir, ignore_errors=True)
            raise
        t._owned_dir = sock_dir
        return t

    # -- protocol verbs -----------------------------------------------------
    def ping(self) -> None:
        self._request(OP_PING)

    def load_stream(self, name, path, *, tile_entries=None) -> None:
        body = (
            Writer()
            .str(name)
            .str(os.path.abspath(path))
            .i64(-1 if tile_entries is None else int(tile_entries))
            .bytes()
        )
        self._request(OP_LOAD, body)

    def unload(self, name) -> None:
        self._request(OP_UNLOAD, Writer().str(name).bytes())

    def payloads(self) -> list[str]:
        r = self._request(OP_PAYLOADS)
        return [r.str() for _ in range(r.u16())]

    def shape_of(self, name) -> tuple[int, ...]:
        r = self._request(OP_SHAPE, Writer().str(name).bytes())
        return tuple(r.u64() for _ in range(r.u8()))

    def submit(self, name, indices, version=None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        w = (
            Writer()
            .str(name)
            .i64(-1 if version is None else int(version))
            .array(np.asarray(indices))
        )
        if obs.enabled():
            ctx = obs.current_context()
            if ctx is not None:
                w.u64(ctx[0]).u64(ctx[1])
        self._send(OP_SUBMIT, rid, w.bytes())
        self._pending.append(rid)
        return rid

    def flush(self) -> tuple[dict[int, np.ndarray], dict[int, Exception]]:
        pending, self._pending = self._pending, []
        w, want_spans = Writer(), False
        flags = 0
        if obs.enabled():
            want_spans = True
            flags |= FLUSH_WANT_SPANS
            ctx = obs.current_context()
            if ctx is not None:
                flags |= FLUSH_HAS_CTX
        w.u8(flags)
        if flags & FLUSH_HAS_CTX:
            w.u64(ctx[0]).u64(ctx[1])
        r = self._request(OP_FLUSH, w.bytes())
        results: dict[int, np.ndarray] = {}
        failures: dict[int, Exception] = {}
        for _ in range(r.u32()):
            rid = r.u64()
            results[rid] = r.array()
        for _ in range(r.u32()):
            rid = r.u64()
            failures[rid] = RemoteError(r.str())
        for rid in pending:  # worker must answer every submitted rid
            if rid not in results and rid not in failures:
                failures[rid] = RemoteError(
                    f"{self.instance_id}: ticket vanished on worker"
                )
        if want_spans and not r.eof() and r.u8():
            worker_now, spans = unpack_spans(r)
            obs.get_recorder().ingest(
                spans,
                clock_offset=time.perf_counter() - worker_now,
                instance=self.instance_id,
            )
        return results, failures

    def drain(self) -> None:
        if self._pending:
            self.flush()

    def stats(self) -> dict:
        return json.loads(self._request(OP_STATS).blob().decode("utf-8"))

    def set_ownership(self, name, ownership) -> None:
        w = Writer().str(name)
        pack_ownership(w, ownership)
        self._request(OP_SET_OWNERSHIP, w.bytes())

    def export_tiles(self, name) -> dict[int, np.ndarray]:
        r = self._request(OP_EXPORT_TILES, Writer().str(name).bytes())
        return {r.u64(): r.array() for _ in range(r.u32())}

    def admit_tile(self, name, tid, values) -> bool:
        body = Writer().str(name).u64(int(tid)).array(np.asarray(values)).bytes()
        return bool(self._request(OP_ADMIT_TILE, body).u8())

    def drop_unowned(self, name) -> int:
        return self._request(OP_DROP_UNOWNED, Writer().str(name).bytes()).u64()

    def refresh(self, name) -> None:
        self._request(OP_REFRESH, Writer().str(name).bytes())

    def export_chunk(self, name, chunk) -> bytes | None:
        body = Writer().str(name).u64(int(chunk)).bytes()
        r = self._request(OP_EXPORT_CHUNK, body)
        return r.blob() if r.u8() else None

    def inject_fault(self, name, fault) -> None:
        body = Writer().str(name).blob(
            json.dumps(fault).encode("utf-8")
        ).bytes()
        self._request(OP_INJECT_FAULT, body)

    def close(self) -> None:
        if self._dead is None:
            try:
                self._request(OP_SHUTDOWN)
            except (TransportError, RemoteError):
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._proc is not None:
            if self._proc.poll() is None:
                self._proc.terminate()
                try:
                    self._proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    self._proc.wait()
            self._proc = None
        if self._owned_dir is not None:
            shutil.rmtree(self._owned_dir, ignore_errors=True)
            self._owned_dir = None
        if self._dead is None:
            self._dead = TransportError(f"{self.instance_id}: transport closed")
