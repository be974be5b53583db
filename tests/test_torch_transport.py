"""``repro_torch.fleet.transport`` and ``repro_torch.fleet.worker`` against
the JAX package's, on the CPU.

- The wire protocol is the reference's byte for byte: every opcode and
  status, the framing helpers' bytes (scalars, strings, blobs, arrays of
  several dtypes, ownership sets, the span block), and each package's
  ``Reader`` parsing the other's bytes.
- A port worker (``python -m repro_torch.fleet.worker --device cpu``) is
  bitwise equal to a ``LocalTransport`` over the whole verb surface, and
  a socket fleet of port workers is bitwise one ``CodecService`` on TT
  and NTTD payloads, through a rebalance that warms a joining worker.
- Mixed fleets in both directions: the port's ``FleetFrontend`` driving a
  reference worker (``python -m repro.fleet.worker``) beside an
  in-process port member, and the reference's ``FleetFrontend`` driving a
  port worker beside an in-process reference member, give answers
  bitwise equal to one service of either package on a TT payload, and a
  traced flush from the reference frontend stitches the port worker's
  spans under its ``transport.flush``.
"""
import os
import socket
import struct
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro import obs as jobs
from repro.fleet import transport as jtransport
from repro.serve import codec_service as jservice
from repro_torch import fleet as tfleet
from repro_torch import obs as tobs
from repro_torch.codecs import get_codec
from repro_torch.codecs.adapters import NTTDEncoded
from repro_torch.core import nttd
from repro_torch.core.codec import CompressedTensor
from repro_torch.core.folding import make_folding_spec
from repro_torch.fleet import transport as ttransport
from repro_torch.serve import codec_service as tservice
from repro_torch.stream import write_chunked

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
SHAPE = (16, 16, 8)


@pytest.fixture(scope="module", autouse=True)
def fused_decode_route():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_DECODE_IMPL", "fused")
        yield


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("transport")
    x = np.random.default_rng(0).random(SHAPE).astype(np.float32)
    out = {"ttd": str(tmp / "ttd.tcdc"), "nttd": str(tmp / "nttd.tcdc")}
    write_chunked(out["ttd"], get_codec("ttd").fit(x, max_rank=4), chunk_bytes=1024)
    spec = make_folding_spec(SHAPE)
    cfg = nttd.NTTDConfig(rank=4, hidden=8)
    params = nttd.init_params(torch.Generator().manual_seed(1), spec, cfg, "cpu")
    enc = NTTDEncoded(CompressedTensor(params, [np.arange(n) for n in SHAPE], spec, cfg,
                                       norm_mean=0.1, norm_std=1.5))
    write_chunked(out["nttd"], enc, chunk_bytes=1024)
    return out


def _idx(n=100, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, n) for s in SHAPE], axis=1)


def _single(path, tile_entries=64):
    svc = tservice.CodecService(device="cpu")
    svc.load_stream("t", path, tile_entries=tile_entries)
    return svc


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------
OPS = ("OP_PING", "OP_LOAD", "OP_UNLOAD", "OP_SHAPE", "OP_SUBMIT", "OP_FLUSH", "OP_STATS",
       "OP_SET_OWNERSHIP", "OP_EXPORT_TILES", "OP_ADMIT_TILE", "OP_DROP_UNOWNED",
       "OP_PAYLOADS", "OP_SHUTDOWN", "OP_REFRESH", "OP_EXPORT_CHUNK", "OP_INJECT_FAULT",
       "ST_OK", "ST_ERROR", "FLUSH_WANT_SPANS", "FLUSH_HAS_CTX", "MAX_FRAME_BYTES")


def test_protocol_constants_equal_the_reference():
    assert {k: getattr(ttransport, k) for k in OPS} == {k: getattr(jtransport, k) for k in OPS}


ARRAYS = [np.arange(24, dtype=np.float64).reshape(4, 6), np.arange(7, dtype=np.int64),
          np.zeros((0, 3), np.int32), np.linspace(0, 1, 5, dtype=np.float32),
          np.array([[1, 2], [3, 4]], dtype=np.uint8)]


def _body(mod, arrays):
    w = (mod.Writer().u8(7).u16(300).u32(1 << 20).u64(1 << 40).i64(-5).f64(0.1)
         .str("payload/α").blob(b"raw bytes"))
    for a in arrays:
        w.array(a)
    return w.bytes()


def test_framing_helpers_write_the_reference_bytes():
    body = _body(ttransport, ARRAYS)
    assert body == _body(jtransport, ARRAYS)
    for writer, reader in ((ttransport, jtransport), (jtransport, ttransport)):
        r = reader.Reader(_body(writer, ARRAYS))
        assert (r.u8(), r.u16(), r.u32(), r.u64(), r.i64(), r.f64()) == (
            7, 300, 1 << 20, 1 << 40, -5, 0.1)
        assert r.str() == "payload/α" and r.blob() == b"raw bytes"
        for a in ARRAYS:
            got = r.array()
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, a)
        assert r.eof()
    with pytest.raises(ttransport.ProtocolError, match="truncated"):
        ttransport.Reader(body[:3]).u64()


@pytest.mark.parametrize("sets", [None, (None, None), ({1, 5}, None), (set(), {0, 2, 9})])
def test_ownership_bytes_equal_the_reference(sets):
    def packed(mod, own_cls):
        w = mod.Writer()
        own = None if sets is None else own_cls(
            *(None if s is None else frozenset(s) for s in sets))
        mod.pack_ownership(w, own)
        return w.bytes()

    raw = packed(ttransport, tservice.Ownership)
    assert raw == packed(jtransport, jservice.Ownership)
    got = ttransport.unpack_ownership(ttransport.Reader(raw))
    want = jtransport.unpack_ownership(jtransport.Reader(raw))
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.chunk_ids, got.tile_ids) == (want.chunk_ids, want.tile_ids)


def test_span_block_bytes_equal_the_reference(monkeypatch):
    import time

    monkeypatch.setattr(time, "perf_counter", lambda: 123.5)
    rows = [("decode_at", 1, 2, 0, 1.0, 2.5, {"payload": "t", "entries": 4}),
            ("kernel_decode", 1, 3, 2, 1.25, 2.0, {})]
    blocks = []
    for mod, ob in ((ttransport, tobs), (jtransport, jobs)):
        w = mod.Writer()
        mod.pack_spans(w, [ob.Span(*row) for row in rows])
        blocks.append(w.bytes())
    assert blocks[0] == blocks[1]
    now, spans = ttransport.unpack_spans(ttransport.Reader(blocks[1]))
    assert now == 123.5
    assert [(s.name, s.trace_id, s.span_id, s.parent_id, s.t_start, s.t_end, s.attrs)
            for s in spans] == rows


def test_frames_and_addresses_as_the_reference():
    a, b = socket.socketpair()
    with a, b:
        ttransport.send_frame(a, b"hello frame")
        assert jtransport.recv_frame(b) == b"hello frame"
        jtransport.send_frame(a, b"back")
        assert ttransport.recv_frame(b) == b"back"
        a.sendall(struct.pack("<I", 100) + b"only a little")
        a.close()
        with pytest.raises(ttransport.ProtocolError, match="truncated frame"):
            ttransport.recv_frame(b)
    for addr in ("unix:/tmp/x.sock", "tcp:127.0.0.1:7070"):
        assert ttransport.parse_address(addr) == jtransport.parse_address(addr)
    for bad in ("http://nope", "tcp:missing-port"):
        with pytest.raises(ValueError, match="bad"):
            ttransport.parse_address(bad)


def test_fault_flags_parse_as_the_reference():
    from repro.fleet import worker as jworker
    from repro_torch.fleet import worker as tworker

    args = (["e:1", "f:0"], ["e:10:20:0.4", "e:0:5:1.5:7"])
    assert tworker.parse_fault_flags(*args) == jworker.parse_fault_flags(*args)
    with pytest.raises(ValueError, match="NAME:CHUNK"):
        tworker.parse_fault_flags(["nochunk"], None)


# ---------------------------------------------------------------------------
# port workers
# ---------------------------------------------------------------------------
def _spawn(iid, **kw):
    return tfleet.SocketTransport.spawn(iid, timeout=30.0, device="cpu", **kw)


@pytest.fixture(scope="module")
def socket_fleet(paths):
    """Two port workers behind the port's frontend, TT and NTTD loaded."""
    fleet = tfleet.FleetFrontend(["w0", "w1"], transport_factory=_spawn, device="cpu",
                                 replication=2)
    for kind, path in paths.items():
        fleet.load_stream(kind, path, tile_entries=64)
    yield fleet
    procs = [t._proc for t in fleet.transports.values()]
    fleet.close()
    assert all(p is None for p in procs) or all(p.poll() is not None for p in procs)


def test_socket_and_local_transport_bit_identical(paths, socket_fleet):
    local = tfleet.LocalTransport("l0", device="cpu")
    remote = socket_fleet.transports["w0"]
    for kind, path in paths.items():
        local.load_stream(kind, path, tile_entries=64)
        assert remote.shape_of(kind) == local.shape_of(kind) == SHAPE
    remote.set_ownership("ttd", None)
    remote.set_ownership("nttd", None)
    try:
        batches = [("ttd", _idx(n, n)) for n in (3, 57, 200)] + [("nttd", _idx(90, 4))]
        lt = [local.submit(k, b) for k, b in batches]
        rt = [remote.submit(k, b) for k, b in batches]
        l_res, l_fail = local.flush()
        r_res, r_fail = remote.flush()
        assert not l_fail and not r_fail
        for a, b in zip(lt, rt):
            assert l_res[a].dtype == r_res[b].dtype
            np.testing.assert_array_equal(l_res[a], r_res[b])
        for kind in paths:
            tiles = remote.export_tiles(kind)
            assert tiles.keys() == local.export_tiles(kind).keys() and tiles
            for tid, values in tiles.items():
                np.testing.assert_array_equal(values, local.export_tiles(kind)[tid])
        assert set(remote.stats()) == set(local.stats())
        raw = remote.export_chunk("ttd", 0)
        assert raw is not None and raw == local.export_chunk("ttd", 0)
        bad = remote.submit("nope", _idx(2))
        _, fail = remote.flush()
        assert isinstance(fail[bad], tfleet.RemoteError) and "nope" in str(fail[bad])
        with pytest.raises(tfleet.RemoteError, match="no payload"):
            remote.shape_of("ghost")
    finally:
        local.close()
        for kind in paths:  # the fleet's ownership filter back in place
            socket_fleet.apply_ownership(kind)


def test_socket_fleet_bit_identical_to_one_service(paths, socket_fleet):
    singles = {kind: _single(path) for kind, path in paths.items()}
    before = {kind: socket_fleet.decode_at(kind, _idx(300, 7)) for kind in paths}
    for kind, svc in singles.items():
        np.testing.assert_array_equal(before[kind], svc.decode_at("t", _idx(300, 7)))
    tickets = [socket_fleet.submit(kind, _idx(50, 8 + k)) for k, kind in enumerate(paths)]
    report = tfleet.rebalance(socket_fleet, add=["w2"])  # drains, warms the joiner
    out = socket_fleet.flush()
    for (k, kind), t in zip(enumerate(paths), tickets):
        np.testing.assert_array_equal(out[t], singles[kind].decode_at("t", _idx(50, 8 + k)))
    assert sum(report.tiles_warmed.values()) > 0
    for kind, svc in singles.items():
        np.testing.assert_array_equal(socket_fleet.decode_at(kind, _idx(300, 9)),
                                      svc.decode_at("t", _idx(300, 9)))
    m = tfleet.collect(socket_fleet).as_dict()
    assert sorted(m["instances"]) == ["w0", "w1", "w2"] and not socket_fleet.failed
    tfleet.rebalance(socket_fleet, remove=["w2"])
    assert sorted(socket_fleet.transports) == ["w0", "w1"]


# ---------------------------------------------------------------------------
# mixed fleets
# ---------------------------------------------------------------------------
def _worker_proc(module, address, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return subprocess.Popen([sys.executable, "-m", module, "--listen", address, *extra],
                            env=env, stdout=subprocess.DEVNULL)


def _close_all(fleet, procs):
    fleet.close()
    for p in procs:
        p.wait(timeout=30)


def test_port_frontend_drives_a_reference_worker(paths):
    sock = os.path.join(tempfile.mkdtemp(prefix="mixed-"), "r0.sock")
    proc = _worker_proc("repro.fleet.worker", f"unix:{sock}")
    remote = tfleet.SocketTransport("r0", f"unix:{sock}", timeout=60.0, proc=proc)
    fleet = tfleet.FleetFrontend({"r0": remote, "p0": tfleet.LocalTransport("p0", device="cpu")},
                                 device="cpu", replication=2)
    try:
        fleet.load_stream("t", paths["ttd"], tile_entries=64)
        port_svc = _single(paths["ttd"])
        ref_svc = jservice.CodecService()
        ref_svc.load_stream("t", paths["ttd"], tile_entries=64)
        for seed in range(4):
            got = fleet.decode_at("t", _idx(200, seed))
            np.testing.assert_array_equal(got, port_svc.decode_at("t", _idx(200, seed)))
            np.testing.assert_array_equal(got, ref_svc.decode_at("t", _idx(200, seed)))
        # the reference worker answered its share: its stats say so
        assert remote.stats()["misses"] > 0
        report = tfleet.rebalance(fleet, remove=["p0"])  # the worker takes every tile
        assert report.removed == ["p0"] and not fleet.failed
        np.testing.assert_array_equal(fleet.decode_at("t", _idx(300, 11)),
                                      port_svc.decode_at("t", _idx(300, 11)))
    finally:
        _close_all(fleet, [proc])
    assert proc.returncode is not None


def test_reference_frontend_drives_a_port_worker(paths):
    sock = os.path.join(tempfile.mkdtemp(prefix="mixed-"), "p0.sock")
    proc = _worker_proc("repro_torch.fleet.worker", f"unix:{sock}", "--device", "cpu")
    remote = jtransport.SocketTransport("p0", f"unix:{sock}", timeout=60.0, proc=proc)
    fleet = jfleet.FleetFrontend({"p0": remote, "j0": jfleet.LocalTransport("j0")},
                                 replication=2)
    rec = jobs.enable_tracing()
    rec.clear()
    try:
        fleet.load_stream("t", paths["ttd"], tile_entries=64)
        port_svc = _single(paths["ttd"])
        for seed in range(4):
            np.testing.assert_array_equal(fleet.decode_at("t", _idx(200, seed)),
                                          port_svc.decode_at("t", _idx(200, seed)))
        spans = rec.snapshot()
        flushes = {s.span_id for s in spans
                   if s.name == "transport.flush" and s.attrs.get("instance") == "p0"}
        remote = [s for s in spans if s.instance == "p0"]
        ids = {s.span_id for s in remote}
        assert flushes and remote and "decode_at" in {s.name for s in remote}
        # every worker span hangs, through worker spans, off a frontend flush
        assert {s.parent_id for s in remote if s.parent_id not in ids} <= flushes
        jobs.disable_tracing()
        report = jfleet.rebalance(fleet, remove=["j0"])
        assert report.removed == ["j0"] and not fleet.failed
        np.testing.assert_array_equal(fleet.decode_at("t", _idx(300, 11)),
                                      port_svc.decode_at("t", _idx(300, 11)))
    finally:
        jobs.disable_tracing()
        rec.clear()
        _close_all(fleet, [proc])
    assert proc.returncode is not None  # shut down (or terminated) by close()


def test_spawn_reports_a_worker_without_cuda_as_a_failure(monkeypatch):
    """Without ``device`` the worker serves on CUDA; with no card it exits
    before it listens, and ``spawn`` raises instead of hanging or falling
    back to the CPU."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(tfleet.TransportError, match="exited with code 1"):
        tfleet.SocketTransport.spawn("w0", connect_timeout=60.0)
