"""Compressed-tensor serving: batched ``decode_at`` over codec payloads, as
in ``repro.serve.codec_service``.

A service instance hosts any number of named
:class:`repro_torch.codecs.Encoded` payloads and answers entry queries at
ORIGINAL indices without ever densifying the tensors it serves (except
SZ-lite, which is a stream codec and caches one reconstruction — bounded,
see below).

Three load paths:

- ``load(name, blob_or_encoded)`` — resident payload, as before;
- ``load_stream(name, path)`` — LAZY: the container-v3 file is mmapped
  and only its header + footer chunk index are parsed; chunk bytes are
  materialized on first decode and can be evicted again under the cache
  budget, so an instance can host more payload bytes than RAM;
- ``load_stream(name, path, tile_entries=T)`` — additionally routes
  queries through a decode-tile cache: the flat index space is cut into
  T-entry tiles, each decoded once and reused across overlapping queries
  (hit/miss counters per payload, byte-budgeted with everything else).

``load_stream`` also accepts v4 DELTA containers (versioned payloads
written by ``repro_torch.temporal.VersionedStore``): queries take a
``version=`` argument (default: latest), the service resolves the
keyframe→delta chain from the file's version index, and every answer is
the float64 sum of the chain components' decodes — the same convention
as ``repro_torch.temporal.ChainEncoded``, so eager and lazy reads agree
bit-for-bit.  Per-version component payloads live in the LRU as
``("venc", name, v)`` entries; decode tiles are keyed by COMPOSITE tile
id ``version * n_tiles + tile``, so a keyframe's tiles are shared by
every version that chains through it instead of being re-decoded per
version.

``cache_bytes`` is one LRU byte budget over all droppable decode state:
materialized lazy payload bodies, SZ-lite dense reconstructions (via the
``Encoded.cache_nbytes``/``drop_caches`` hooks), and decode tiles.
Accounting happens after each decode, so the payload answering the
current query is never yanked mid-decode; ``cache_stats`` totals
hits/misses/evictions/resident bytes across the instance.

Two query paths, unchanged from the first version of this service:

- ``decode_at(name, indices)`` — direct, chunked at ``max_batch``;
- ``submit(name, indices) -> ticket`` + ``flush()`` — request coalescing:
  queued requests are grouped per payload and decoded in ONE batched
  ``decode_at`` call each, then split back per ticket.

Malformed requests (wrong index width, out-of-range indices, unknown
payload) are rejected at ``submit`` time so they can never poison a
coalesced batch; if a decode still fails at flush, only that payload's
tickets land in ``failed`` — every other queued request completes.

ONLINE FITNESS CANARIES (``canary_fraction > 0``): containers whose
footer carries a ``TCDQ`` held-out block (ground-truth original-tensor
entries recorded at fit time) are spot-checked on the serve path — a
deterministic, seeded fraction of ``decode_at`` calls re-decodes a
bounded sample of the held-out indices and scores fitness
``1 - ||truth - approx|| / ||truth||`` (the paper's §4.2 metric), feeding
a per-payload rolling gauge in ``self.metrics`` and, below
``canary_min_fitness``, a ``quality_breach`` event naming the chunk that
routes the worst entry.  Served ANSWERS are bit-identical with canaries
on or off — the check is a side decode through the same batched funnel,
never a rewrite of the response; only stats differ.  Payloads without a
``TCDQ`` block (all legacy files) and versioned payloads skip canaries
cleanly.

ON THE CARD: every payload is materialized onto the service's ``device``
(CUDA unless given; ``device="cpu"`` serves from the host): each
``from_bytes`` and ``load_bytes`` the service calls receives it, so an NTTD
payload's params live there and every NTTD decode — direct, tile fill,
coalesced, canary side decode, versioned component — is one launch of the
fused ``decode_tile`` kernel per ``decode_at`` call of the payload (at
most ``max_batch`` entries).  The host codecs (TT, Tucker, CP, TR, SZ-lite)
decode on the host, as in the reference.  A CUDA device without an index
is pinned to the constructing thread's current device, so a payload warmed
on the prefetch thread lands on the same card; the fused decode's operands
(``CompressedTensor.decode_operands``) are built at first decode, on the
query thread.  The LRU counts host bytes exactly as the reference does
(chunk bodies and tiles), so every stats dict equals the reference's; the
device copy of an evicted body is released with it.

    svc = CodecService(cache_bytes=1 << 28)     # on CUDA; device="cpu" too
    svc.load_stream("embed", "embed.tcdc")      # mmap + chunk index only
    svc.decode_at("embed", idx)                 # materializes on demand
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import zlib
from typing import Callable

import numpy as np
import torch

from repro_torch import codecs, obs
from repro_torch.codecs import container
from repro_torch.codecs.indexing import flat_to_multi, multi_to_flat, validate_indices
from repro_torch.devices import resolve_device
from repro_torch.temporal.delta import resolve_chain


@dataclasses.dataclass
class PayloadInfo:
    codec: str
    payload_bytes: int
    requests: int = 0
    entries_decoded: int = 0
    decode_calls: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    #: number of versions for a v4 delta payload; None = single tensor
    n_versions: int | None = None


@dataclasses.dataclass
class PayloadCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    resident_bytes: int = 0


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    resident_bytes: int = 0
    #: same four counters broken down by payload name — the fleet metrics
    #: roll-up consumes this to show where an instance's budget goes
    per_payload: dict[str, PayloadCacheStats] = dataclasses.field(
        default_factory=dict
    )

    def for_payload(self, name: str) -> PayloadCacheStats:
        return self.per_payload.setdefault(name, PayloadCacheStats())

    def hit(self, name: str) -> None:
        self.hits += 1
        self.for_payload(name).hits += 1

    def miss(self, name: str) -> None:
        self.misses += 1
        self.for_payload(name).misses += 1

    def as_dict(self) -> dict:
        """JSON-able snapshot — the shape the fleet transport layer ships
        across process boundaries (``Transport.stats``) and the metrics
        roll-up consumes, so remote and in-process instances report
        identically."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "resident_bytes": self.resident_bytes,
            "per_payload": {
                name: {
                    "hits": p.hits,
                    "misses": p.misses,
                    "evictions": p.evictions,
                    "resident_bytes": p.resident_bytes,
                }
                for name, p in self.per_payload.items()
            },
        }


class NotOwnedError(KeyError):
    """Raised when a query lands on an instance whose ownership filter
    excludes the whole payload — the fleet frontend routes so this never
    fires after a drain barrier; seeing it means a routing bug, not a
    corrupt payload."""


class ChunkCorruptError(ValueError):
    """A chunk's bytes failed their CRC at materialization time.

    The chunk is QUARANTINED on this instance (marked for repair, rides
    ``stats()['quarantine']``) instead of poisoning the payload forever:
    the error fails only the queries that needed the body NOW, the fleet
    frontend re-routes them to a replica that still holds a materialized
    body, and a later :meth:`CodecService.refresh` — issued by the repair
    controller once the file is fixed — clears the quarantine.  Carries
    the repair target so controllers need not parse the message."""

    def __init__(self, payload: str, chunk: int, path: str, reason: str):
        super().__init__(reason)
        self.payload = payload
        self.chunk = chunk
        self.path = path


@dataclasses.dataclass
class Ownership:
    """An instance's shard of one payload, installed by the fleet router.

    ``chunk_ids`` filters the chunk-materialization path: an instance
    owning NO chunk of a payload refuses to materialize it (so payload
    bodies only become resident on their owners).  ``tile_ids`` filters
    the decode-tile cache: unowned tiles are still decodable (decode-
    through, keeps mid-rebalance queries correct) but are never cached,
    so each instance's resident tile bytes stay its shard of the whole.
    Both are precomputed sets (the router enumerates the ring once per
    ownership epoch), so the hot decode path pays set lookups, not ring
    hashes.
    """

    chunk_ids: frozenset[int] | None = None  # None = owns every chunk
    tile_ids: frozenset[int] | None = None  # None = owns every tile

    def owns_chunk(self, i: int) -> bool:
        return self.chunk_ids is None or i in self.chunk_ids

    def owns_tile(self, tid: int) -> bool:
        return self.tile_ids is None or tid in self.tile_ids

    def owns_payload(self) -> bool:
        """May this instance materialize the payload body at all?  True
        when it owns any chunk, or serves a non-empty tile shard (tile
        decode needs the body even when every chunk hashed elsewhere)."""
        if self.chunk_ids is None or self.chunk_ids:
            return True
        return bool(self.tile_ids)


@dataclasses.dataclass
class _CanaryState:
    """Per-payload canary bookkeeping: check/breach counts plus a bounded
    window of recent fitness scores for the rolling gauge."""

    checks: int = 0
    breaches: int = 0
    last_fitness: float | None = None
    window: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=32)
    )
    #: detail of the most recent breach (fitness, worst_index, chunk,
    #: entry range) — the repair controller's polling view of the same
    #: facts the quality_breach event carries; None until a breach
    last_breach: dict | None = None

    def rolling_fitness(self) -> float | None:
        return sum(self.window) / len(self.window) if self.window else None

    def as_dict(self) -> dict:
        return {
            "checks": self.checks,
            "breaches": self.breaches,
            "last_fitness": self.last_fitness,
            "rolling_fitness": self.rolling_fitness(),
            "last_breach": self.last_breach,
        }


@dataclasses.dataclass
class _CacheEntry:
    nbytes: int
    value: np.ndarray | None  # decode tiles live here; payloads evict via fn
    on_evict: Callable[[], None] | None = None


@dataclasses.dataclass
class _StreamPayload:
    path: str
    codec: str
    chunks: list[container.ChunkEntry]
    view: memoryview
    tile_entries: int | None
    body_nbytes: int
    enc: codecs.Encoded | None = None
    ownership: Ownership | None = None
    #: v4 version index; None = plain single-tensor payload
    versions: list[container.VersionEntry] | None = None
    #: per-version component payloads (versioned payloads only), each an
    #: evictable ("venc", name, v) LRU entry
    vencs: dict[int, codecs.Encoded] = dataclasses.field(default_factory=dict)
    #: geometry learned from the first materialized component
    shape: tuple[int, ...] | None = None
    n_tiles: int | None = None
    #: held-out ground truth from the container's TCDQ block; None for
    #: legacy files — those simply never canary
    heldout: container.HeldoutEntries | None = None
    #: read-repair overlays from the container's TCDP block (empty for
    #: unpatched files); the base payload is ``chunks[:n_base]``
    patches: list[container.PatchEntry] = dataclasses.field(default_factory=list)
    #: number of BASE (non-patch) chunks; None = every chunk is base
    n_base: int | None = None
    #: chunk id -> error message for chunks whose bytes failed their CRC —
    #: set once at first failed read, cleared only by refresh(); rides
    #: stats()["quarantine"] so the repair controller can find it
    quarantine: dict[int, str] = dataclasses.field(default_factory=dict)
    #: in-flight background warm (prefetch): joined by _get before use
    warm: concurrent.futures.Future | None = None
    #: True after a background warm materialized the body: the NEXT access
    #: counts the warm's miss (and no hit), on the caller's thread, as the
    #: synchronous path counts the materialization that absorbs it
    warm_credit: bool = False


def _pinned(device: torch.device) -> torch.device:
    """``device`` with an index: a bare ``"cuda"`` names the current device
    of whichever thread uses it, and the prefetch thread's is not the
    caller's, so the service fixes it once, at construction."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _n_base(sp: _StreamPayload) -> int:
    return sp.n_base if sp.n_base is not None else len(sp.chunks)


def _hash_noise(flat: np.ndarray, sigma: float, seed: int) -> np.ndarray:
    """Deterministic per-entry pseudo-noise in ``[-sigma, sigma)`` — a pure
    function of (flat index, seed), so every replica injected with the same
    spec serves the SAME degraded values regardless of batch composition."""
    t = np.sin(flat.astype(np.float64) * 12.9898 + seed * 78.233) * 43758.5453
    return (t - np.floor(t) - 0.5) * (2.0 * sigma)


class _NoisyEncoded:
    """DEBUG-ONLY decode-side fault (``inject_fault`` kind
    ``fitness_noise``): wraps a materialized payload so served values
    inside one flat entry range pick up deterministic seeded noise.  Every
    decode path — direct, tiled, coalesced, and the canary's side decode —
    funnels through ``decode_at``, so the fitness canary observes exactly
    the degradation clients do.  The file and the payload bytes are
    untouched: ``to_bytes`` delegates to the clean inner payload."""

    def __init__(self, inner, entry_start: int, entry_stop: int,
                 sigma: float, seed: int = 0):
        self.inner = inner
        self.entry_start = int(entry_start)
        self.entry_stop = int(entry_stop)
        self.sigma = float(sigma)
        self.seed = int(seed)

    @property
    def shape(self):
        return self.inner.shape

    @property
    def codec_name(self) -> str:
        return self.inner.codec_name

    def payload_bytes(self) -> int:
        return self.inner.payload_bytes()

    def cache_nbytes(self) -> int:
        return self.inner.cache_nbytes()

    def drop_caches(self) -> None:
        self.inner.drop_caches()

    def to_bytes(self) -> bytes:
        return self.inner.to_bytes()

    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        vals = np.asarray(self.inner.decode_at(indices))
        idx = np.asarray(indices)
        if idx.shape[0] == 0:
            return vals
        shape = tuple(int(s) for s in self.shape)
        flat = np.ravel_multi_index(tuple(idx.T), shape)
        mask = (flat >= self.entry_start) & (flat < self.entry_stop)
        if not mask.any():
            return vals
        out = np.array(vals, dtype=np.float64)
        out[mask] += _hash_noise(flat[mask], self.sigma, self.seed)
        return out

    def to_dense(self) -> np.ndarray:
        x = np.array(self.inner.to_dense(), dtype=np.float64)
        flat = np.arange(self.entry_start, self.entry_stop, dtype=np.int64)
        x.reshape(-1)[flat] += _hash_noise(flat, self.sigma, self.seed)
        return x


class CodecService:
    def __init__(
        self,
        max_batch: int = 65536,
        cache_bytes: int | None = None,
        prefetch: bool = False,
        canary_fraction: float = 0.0,
        canary_seed: int = 0,
        canary_min_fitness: float | None = None,
        canary_max_entries: int = 256,
        device=None,
    ):
        self.max_batch = max_batch
        #: fraction of decode_at calls (per payload, deterministic in the
        #: call sequence) that run an online fitness canary; 0 = off
        if not 0.0 <= canary_fraction <= 1.0:
            raise ValueError(
                f"canary_fraction must be in [0, 1], got {canary_fraction}"
            )
        self.canary_fraction = float(canary_fraction)
        self.canary_seed = int(canary_seed)
        self.canary_min_fitness = canary_min_fitness
        self.canary_max_entries = int(canary_max_entries)
        #: where payloads are materialized and decoded (CUDA unless given)
        self.device = _pinned(resolve_device(device))
        #: per-payload canary call counter (sampling position) and state
        self._canary_calls: dict[str, int] = {}
        self._canary: dict[str, _CanaryState] = {}
        #: instrument registry (canary gauges today; service-local so two
        #: services in one process never share a gauge)
        self.metrics = obs.MetricsRegistry()
        #: byte budget for droppable decode state; None = unbounded (legacy)
        self.cache_bytes = cache_bytes
        #: overlap I/O with compute on a single background thread:
        #: load_stream pre-warms payload bodies (mmap page-in + CRC +
        #: parse) ahead of the query stream, chunk reads run ahead of the
        #: joining copy, and tile k+1's index block is built while tile k
        #: decodes.  Answers and cache counters are bit-identical with
        #: prefetching off — the pipeline only reorders WHEN input-side
        #: work happens, never what is decoded or how it is counted.
        self.prefetch = prefetch
        self._prefetch_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._payloads: dict[str, codecs.Encoded] = {}
        self._streams: dict[str, _StreamPayload] = {}
        self._info: dict[str, PayloadInfo] = {}
        self._cache: collections.OrderedDict[tuple, _CacheEntry] = (
            collections.OrderedDict()
        )
        self._enc_counters_seen: dict[str, tuple[int, int]] = {}
        self.cache_stats = CacheStats()
        #: per-payload DEBUG faults installed by inject_fault(); cleared by
        #: refresh().  {"corrupt_chunks": set[int], "noise": tuple | None}
        self._faults: dict[str, dict] = {}
        self._queue: list[tuple[int, str, np.ndarray, int | None]] = []
        self._next_ticket = 0
        #: tickets whose payload group raised during the LAST flush,
        #: ticket -> error (reset at the start of each flush)
        self.failed: dict[int, Exception] = {}

    # ------------------------------------------------------------------ load
    def load(self, name: str, payload: bytes | codecs.Encoded) -> PayloadInfo:
        """Register a resident payload under ``name``; bytes go through the
        container loader so the codec-id header picks the decoder."""
        enc = (
            codecs.load_bytes(payload, device=self.device)
            if isinstance(payload, bytes) else payload
        )
        self._drop_named_cache_entries(name)
        self._streams.pop(name, None)
        self._enc_counters_seen.pop(name, None)
        self._payloads[name] = enc
        self._info[name] = PayloadInfo(enc.codec_name, enc.payload_bytes())
        return self._info[name]

    def load_stream(
        self, name: str, path: str, *, tile_entries: int | None = None
    ) -> PayloadInfo:
        """Register a container v3/v4 file lazily: mmap it, parse only the
        header and footer.  Payload bodies are materialized at first
        decode and are evictable under ``cache_bytes`` thereafter.  With
        ``tile_entries``, queries go through the decode-tile cache.  v4
        delta files register as VERSIONED payloads, queried with
        ``decode_at(..., version=)``."""
        oc = container.open_container(path)
        codec_name, chunks, view = oc.codec, oc.chunks, oc.view
        try:  # reject unknown codec ids at LOAD time, exactly like load()
            codecs.get_codec(codec_name)
        except KeyError:
            view.release()
            raise ValueError(
                f"unknown codec id {codec_name!r} in container {path}"
            ) from None
        self._drop_named_cache_entries(name)
        self._enc_counters_seen.pop(name, None)
        self._payloads.pop(name, None)
        body_nbytes = sum(c.length for c in chunks)
        sp = _StreamPayload(
            path, codec_name, chunks, view, tile_entries, body_nbytes,
            versions=oc.versions, heldout=oc.heldout,
            patches=list(oc.patches), n_base=oc.n_base,
        )
        self._streams[name] = sp
        self._info[name] = PayloadInfo(
            codec_name, body_nbytes,
            n_versions=len(oc.versions) if oc.versions is not None else None,
        )
        pool = self._pool()
        if pool is not None and sp.versions is None:
            # warm the payload ahead of the query stream: chunk page-in,
            # CRC, and body parse run on the background thread while the
            # caller keeps loading/serving other payloads.  _get joins the
            # future before first use, so answers and the materialization
            # miss count are identical with prefetching off.
            sp.warm = pool.submit(self._warm_stream, name, sp)
        return self._info[name]

    def unload(self, name: str) -> None:
        self._drop_named_cache_entries(name)
        self._enc_counters_seen.pop(name, None)
        self._payloads.pop(name, None)
        sp = self._streams.pop(name, None)
        if sp is not None:
            sp.view.release()
        self._info.pop(name, None)

    def payloads(self) -> list[str]:
        return sorted(set(self._payloads) | set(self._streams))

    def info(self, name: str) -> PayloadInfo:
        return self._info[name]

    def shape_of(self, name: str) -> tuple[int, ...]:
        """Original-tensor shape of a payload.  Lazy payloads are
        materialized to read it (the fleet loader calls this exactly once,
        on the chunk-0 primary owner — an instance that keeps the body);
        the materialized body joins the LRU ledger just like a decode's
        would, so it stays accounted and evictable."""
        sp = self._streams.get(name)
        if sp is not None and sp.versions is not None:
            return self._ensure_version_geometry(name, sp)
        enc = self._get(name, count=False)
        self._account_decode_state(name, enc)
        return tuple(int(s) for s in enc.shape)

    def _get(self, name: str, count: bool = True) -> codecs.Encoded:
        """Resolve a payload, materializing lazy ones.  ``count=False``
        (validation-only paths like submit) skips the hit counter so one
        logical decode is not double-counted; a materialization is real
        work and is always counted as a miss."""
        if name in self._payloads:
            return self._payloads[name]
        sp = self._streams.get(name)
        if sp is None:
            raise KeyError(
                f"no payload {name!r}; loaded: {', '.join(self.payloads())}"
            )
        if sp.versions is not None:
            raise ValueError(
                f"payload {name!r} is versioned; query it through "
                "decode_at/submit (version=) instead"
            )
        if sp.warm is not None:
            # join the warm even when its body is already set: its
            # bookkeeping (warm_credit) lands only when it returns
            warm, sp.warm = sp.warm, None
            with obs.span("prefetch_wait", payload=name):
                warm.result()  # propagate a failed background warm verbatim
        if sp.enc is None:
            if sp.ownership is not None and not sp.ownership.owns_payload():
                raise NotOwnedError(
                    f"payload {name!r} is not owned by this instance "
                    "(ownership filter excludes every chunk)"
                )
            self._materialize(name, sp)
        elif sp.warm_credit:
            # the background warm's materialization: its miss is counted
            # here, on the caller's thread, where the same access counts it
            # with prefetching off (the warm thread counts nothing, so no
            # counter is updated from two threads)
            sp.warm_credit = False
            self._count_miss(name)
        elif count:
            self.cache_stats.hit(name)
            self._info[name].cache_hits += 1
        return sp.enc

    def _read_chunk_checked(
        self, name: str, sp: _StreamPayload, cid: int
    ) -> bytes:
        """Materialize one chunk's bytes with the quarantine discipline: a
        CRC/truncation failure (real, or injected via ``inject_fault``)
        marks the chunk quarantined — recorded once, surfaced through
        ``stats()['quarantine']``, fails fast on re-reads — and raises
        :class:`ChunkCorruptError` so callers (and the fleet frontend) can
        fail over to a replica instead of writing the payload off."""
        prior = sp.quarantine.get(cid)
        if prior is not None:
            raise ChunkCorruptError(name, cid, sp.path, prior)
        c = sp.chunks[cid]
        try:
            fault = self._faults.get(name)
            if fault is not None and cid in fault["corrupt_chunks"]:
                raise ValueError(
                    f"{sp.path}: corrupt payload: chunk checksum mismatch "
                    "(injected)"
                )
            return container.read_chunk(sp.view, c, ctx=f"{sp.path}: ")
        except ValueError as e:
            sp.quarantine[cid] = str(e)
            obs.emit_event(
                "chunk_quarantined",
                payload=name,
                chunk=cid,
                path=sp.path,
                entry_start=c.entry_start,
                entry_stop=c.entry_stop,
                error=str(e),
            )
            self.metrics.counter("chunks_quarantined", payload=name).inc()
            raise ChunkCorruptError(name, cid, sp.path, str(e)) from e

    def _count_miss(self, name: str) -> None:
        self.cache_stats.miss(name)
        self._info[name].cache_misses += 1

    def _materialize(
        self, name: str, sp: _StreamPayload, pipelined: bool = True,
        count: bool = True,
    ) -> None:
        """Read + parse a lazy payload body (counted as one miss, exactly
        like the pre-warm era).  Only BASE chunks form the body; TCDP patch
        overlays are materialized separately and wrapped around it, so
        every decode path sees repaired ranges automatically.  A chunk that
        fails its CRC is quarantined (see ``_read_chunk_checked``) instead
        of poisoning the payload.  ``pipelined=False`` reads chunks
        inline — required when already ON the single prefetch thread (the
        warm path), where submitting to the pool and waiting would
        deadlock.  ``count=False`` (the warm path) leaves the miss to the
        caller's first access (``_get``)."""
        if count:
            self._count_miss(name)
        nb = _n_base(sp)
        with obs.span("materialize", payload=name, chunks=nb):
            with obs.span("chunk_read", payload=name, chunks=nb):
                reads = (
                    self._read_chunks(name, sp)
                    if pipelined
                    else [
                        self._read_chunk_checked(name, sp, i)
                        for i in range(nb)
                    ]
                )
                body = b"".join(reads)
            enc = codecs.get_codec(sp.codec).encoded_cls.from_bytes(
                body, device=self.device
            )
            if sp.patches:
                overlays = []
                for p in sp.patches:
                    pbody = b"".join(
                        self._read_chunk_checked(name, sp, i)
                        for i in range(p.chunk_start, p.chunk_stop)
                    )
                    overlays.append(
                        (p, codecs.get_codec(p.codec).encoded_cls.from_bytes(
                            pbody, device=self.device
                        ))
                    )
                enc = container.PatchedEncoded(enc, overlays)
            fault = self._faults.get(name)
            if fault is not None and fault.get("noise") is not None:
                enc = _NoisyEncoded(enc, *fault["noise"])
            sp.enc = enc
        self._info[name].payload_bytes = sp.enc.payload_bytes()

    def _warm_stream(self, name: str, sp: _StreamPayload) -> None:
        """Background payload warm, scheduled by load_stream when prefetch
        is on.  Re-checks registration and ownership at RUN time (the fleet
        router may have installed a filter, or the name been reloaded,
        since scheduling) and silently skips when materializing would be
        wrong — the query path then does it synchronously as usual."""
        if self._streams.get(name) is not sp or sp.enc is not None:
            return
        if sp.ownership is not None and not sp.ownership.owns_payload():
            return
        self._materialize(name, sp, pipelined=False, count=False)
        sp.warm_credit = True

    # -------------------------------------------------------------- versions
    def _resolve_version(self, name: str, sp: _StreamPayload,
                         version: int | None) -> int:
        n = len(sp.versions)
        v = n - 1 if version is None else int(version)
        if not 0 <= v < n:
            raise ValueError(f"{name}: version {v} out of range [0, {n})")
        return v

    def _set_geometry(self, name: str, sp: _StreamPayload,
                      enc: codecs.Encoded) -> None:
        shape = tuple(int(s) for s in enc.shape)
        if sp.shape is None:
            sp.shape = shape
            if sp.tile_entries:
                sp.n_tiles = -(-int(np.prod(shape)) // sp.tile_entries)
        elif shape != sp.shape:
            raise ValueError(
                f"{name}: version component shape {shape} != {sp.shape}"
            )

    def _ensure_version_geometry(
        self, name: str, sp: _StreamPayload
    ) -> tuple[int, ...]:
        """Shape (and tile grid) of a versioned payload, learned from its
        version-0 component — materialized and LRU-accounted on demand."""
        if sp.shape is None:
            enc = self._get_component(name, sp, 0, count=False)
            self._account_version_state(name, sp, 0, enc)
        return sp.shape

    def _get_component(
        self, name: str, sp: _StreamPayload, v: int, count: bool = True
    ) -> codecs.Encoded:
        """Resolve ONE version's component payload (keyframe or delta),
        materializing it from the version's chunk range on a miss — the
        versioned analogue of ``_get``, with the same counting rules."""
        enc = sp.vencs.get(v)
        if enc is None:
            if sp.ownership is not None and not sp.ownership.owns_payload():
                raise NotOwnedError(
                    f"payload {name!r} is not owned by this instance "
                    "(ownership filter excludes every chunk)"
                )
            self.cache_stats.miss(name)
            self._info[name].cache_misses += 1
            ve = sp.versions[v]
            with obs.span("materialize", payload=name, version=v):
                with obs.span(
                    "chunk_read", payload=name,
                    chunks=ve.chunk_stop - ve.chunk_start,
                ):
                    body = b"".join(
                        self._read_chunk_checked(name, sp, i)
                        for i in range(ve.chunk_start, ve.chunk_stop)
                    )
                enc = codecs.get_codec(sp.codec).encoded_cls.from_bytes(
                    body, device=self.device
                )
            sp.vencs[v] = enc
            self._set_geometry(name, sp, enc)
        elif count:
            self.cache_stats.hit(name)
            self._info[name].cache_hits += 1
        return enc

    def _account_version_state(
        self, name: str, sp: _StreamPayload, v: int, enc: codecs.Encoded
    ) -> None:
        """Post-decode accounting for one version component: its chunk
        bytes (+ droppable codec state) join the LRU as ("venc", name, v),
        evictable independently of every other version."""
        ve = sp.versions[v]
        vbytes = sum(
            c.length for c in sp.chunks[ve.chunk_start : ve.chunk_stop]
        )

        def drop(sp=sp, v=v):
            dropped = sp.vencs.pop(v, None)
            if dropped is not None:
                dropped.drop_caches()

        self._cache_put(
            ("venc", name, v),
            _CacheEntry(vbytes + enc.cache_nbytes(), None, drop),
        )

    def _decode_versioned(
        self, name: str, sp: _StreamPayload, idx: np.ndarray, version: int
    ) -> tuple[np.ndarray, int]:
        """Answer a query against version ``version``: float64 sum of the
        keyframe→delta chain's component answers (keyframe first) — the
        exact :class:`repro_torch.temporal.ChainEncoded` convention,
        elementwise, so fleet batch-splitting cannot change a single bit."""
        chain = resolve_chain(sp.versions, version)
        if sp.tile_entries:
            return self._decode_versioned_tiled(name, sp, idx, chain, version)
        out = np.zeros((idx.shape[0],), dtype=np.float64)
        for v in chain:
            enc = self._get_component(name, sp, v)
            out += np.asarray(self._decode_batched(enc, idx), np.float64)
            self._account_version_state(name, sp, v, enc)
        calls = len(chain) * -(-idx.shape[0] // self.max_batch)
        return out, calls

    def _decode_versioned_tiled(
        self,
        name: str,
        sp: _StreamPayload,
        idx: np.ndarray,
        chain: list[int],
        version: int,
    ) -> tuple[np.ndarray, int]:
        """Tiled versioned decode.  Tiles cache under COMPOSITE ids
        ``v * n_tiles + tid`` so a base version's tiles are decoded once
        and shared by every version chaining through it; ownership is
        checked on the BASE tile id, keeping all versions of a tile on
        one owner (that is what makes the warm handoff and the fleet
        routing version-independent)."""
        flat = multi_to_flat(idx, sp.shape)
        if not len(flat):
            return np.zeros((0,), dtype=np.float64), 0
        tids = flat // sp.tile_entries
        uniq = [int(tid) for tid in np.unique(tids)]
        out = np.zeros((len(flat),), dtype=np.float64)
        with obs.span(
            "tile_decode", payload=name, version=version,
            chain=len(chain), tiles=len(uniq),
        ):
            decoded = self._decode_chain_tiles(
                name, sp, chain, uniq, flat, tids, out
            )
        return out, decoded

    def _decode_chain_tiles(
        self,
        name: str,
        sp: _StreamPayload,
        chain: list[int],
        uniq: list[int],
        flat: np.ndarray,
        tids: np.ndarray,
        out: np.ndarray,
    ) -> int:
        t = sp.tile_entries
        n_entries = int(np.prod(sp.shape))
        shape = sp.shape
        info = self._info[name]
        decoded = 0
        for v in chain:
            comp: codecs.Encoded | None = None
            for tid in uniq:
                ctid = v * sp.n_tiles + tid
                entry = self._cache_touch(("tile", name, ctid))
                if entry is None:
                    self.cache_stats.miss(name)
                    info.cache_misses += 1
                    if comp is None:
                        comp = self._get_component(name, sp, v, count=False)
                    start = tid * t
                    stop = min(start + t, n_entries)
                    tpos = flat_to_multi(
                        np.arange(start, stop, dtype=np.int64), shape
                    )
                    tile = self._decode_batched(comp, tpos)
                    decoded += 1
                    if sp.ownership is None or sp.ownership.owns_tile(tid):
                        self._cache_put(
                            ("tile", name, ctid),
                            _CacheEntry(int(tile.nbytes), tile),
                        )
                else:
                    self.cache_stats.hit(name)
                    info.cache_hits += 1
                    tile = entry.value
                mask = tids == tid
                out[mask] += np.asarray(tile[flat[mask] - tid * t], np.float64)
            if comp is not None:
                self._account_version_state(name, sp, v, comp)
        return decoded

    # -------------------------------------------------------------- prefetch
    def _pool(self) -> concurrent.futures.ThreadPoolExecutor | None:
        """Lazy single-worker pool: one background thread keeps the
        input-side pipeline strictly ordered (chunk i+1 never races ahead
        of chunk i+2), and nothing is spawned unless prefetch is on AND a
        pipelined path actually runs."""
        if not self.prefetch:
            return None
        if self._prefetch_pool is None:
            self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="codec-prefetch"
            )
        return self._prefetch_pool

    def _read_chunks(self, name: str, sp: _StreamPayload) -> list[bytes]:
        """BASE-chunk bytes in index order.  With prefetch, reads run ahead
        on the background thread (page-in + CRC drop the GIL) while the
        main thread copies earlier chunks into the joined body."""
        nb = _n_base(sp)
        pool = self._pool()
        if pool is None or nb < 2:
            return [self._read_chunk_checked(name, sp, i) for i in range(nb)]
        futs = [
            pool.submit(self._read_chunk_checked, name, sp, i)
            for i in range(nb)
        ]
        return [f.result() for f in futs]

    # ------------------------------------------------------------- ownership
    def set_ownership(self, name: str, ownership: Ownership | None) -> None:
        """Install (or clear, with ``None``) the fleet ownership filter on
        a lazy payload's chunk-materialization and tile-cache paths.  The
        filter only gates FUTURE materialization/caching; state that just
        became unowned is dropped by :meth:`drop_unowned`, which the
        rebalancer calls after its drain barrier."""
        sp = self._streams.get(name)
        if sp is None:
            raise KeyError(f"no stream payload {name!r} (resident payloads "
                           "are not shardable)")
        sp.ownership = ownership

    def drop_unowned(self, name: str) -> int:
        """Evict cached state the current ownership filter excludes —
        unowned decode tiles, plus the materialized body when the payload
        itself is no longer owned.  Returns bytes freed (through the
        normal LRU eviction accounting)."""
        sp = self._streams.get(name)
        if sp is None or sp.ownership is None:
            return 0
        freed = 0
        for key in [k for k in self._cache if k[1] == name]:
            if key[0] == "tile":
                # composite versioned tile ids fold to their base tile: all
                # versions of a tile share one owner
                tid = key[2] % sp.n_tiles if sp.versions is not None else key[2]
                unowned = not sp.ownership.owns_tile(tid)
            else:
                unowned = not sp.ownership.owns_payload()
            if unowned:
                freed += self._cache[key].nbytes
                self._cache_evict(key)
        return freed

    def export_tiles(self, name: str) -> dict[int, np.ndarray]:
        """Cached decode tiles (tile id -> values) — the warm-handoff
        source a rebalance reads before this instance drops ownership."""
        return {
            key[2]: entry.value
            for key, entry in self._cache.items()
            if key[0] == "tile" and key[1] == name and entry.value is not None
        }

    def admit_tile(self, name: str, tid: int, values: np.ndarray) -> bool:
        """Warm handoff: admit a tile decoded by another instance, subject
        to the ownership filter and the byte budget.  Counts as neither
        hit nor miss — no query was answered.  Versioned payloads hand
        tiles off under their COMPOSITE ids (version * n_tiles + tile);
        ownership is judged on the base tile.  Returns True if admitted."""
        sp = self._streams.get(name)
        if sp is None or not sp.tile_entries:
            raise KeyError(f"no tiled stream payload {name!r}")
        tid = int(tid)
        base_tid = tid
        if sp.versions is not None:
            self._ensure_version_geometry(name, sp)
            v, base_tid = divmod(tid, sp.n_tiles)
            if not 0 <= v < len(sp.versions):
                return False
        if sp.ownership is not None and not sp.ownership.owns_tile(base_tid):
            return False
        values = np.asarray(values)
        self._cache_put(("tile", name, int(tid)),
                        _CacheEntry(int(values.nbytes), values))
        return True

    # ---------------------------------------------------------------- repair
    def inject_fault(self, name: str, fault: dict) -> None:
        """DEBUG-ONLY fault injection — the single surface behind the
        reference worker's ``--debug-corrupt-chunk`` /
        ``--debug-fitness-noise`` flags, so drills and unit tests exercise
        the exact failure path the repair controller fixes.

        ``fault["kind"]``:

        - ``"corrupt_chunk"`` (``chunk``): the named chunk's next read
          fails its CRC exactly as if the bytes rotted on disk — the chunk
          quarantines and queries needing the body raise
          :class:`ChunkCorruptError`;
        - ``"fitness_noise"`` (``entry_start``, ``entry_stop``, ``sigma``,
          optional ``seed``): served values inside the flat range pick up
          deterministic seeded noise, degrading canary fitness without
          touching the file.

        Cached bodies and tiles for the payload are dropped so the fault
        takes effect on the very next decode; :meth:`refresh` clears every
        installed fault."""
        sp = self._streams.get(name)
        if sp is None:
            raise KeyError(f"no stream payload {name!r}")
        kind = fault.get("kind")
        spec = self._faults.setdefault(
            name, {"corrupt_chunks": set(), "noise": None}
        )
        if kind == "corrupt_chunk":
            cid = int(fault["chunk"])
            if not 0 <= cid < len(sp.chunks):
                raise ValueError(f"{name}: chunk {cid} out of range")
            spec["corrupt_chunks"].add(cid)
        elif kind == "fitness_noise":
            spec["noise"] = (
                int(fault["entry_start"]),
                int(fault["entry_stop"]),
                float(fault["sigma"]),
                int(fault.get("seed", 0)),
            )
        else:
            raise ValueError(f"unknown fault kind {kind!r}")
        # join an in-flight background warm first: it may otherwise finish
        # AFTER the state drop below and resurrect a pre-fault body
        if sp.warm is not None:
            warm, sp.warm = sp.warm, None
            with contextlib.suppress(Exception):
                warm.result()
        sp.warm_credit = False
        self._drop_named_cache_entries(name)
        if sp.enc is not None:
            sp.enc.drop_caches()
            sp.enc = None
        sp.vencs.clear()

    def refresh(self, name: str) -> PayloadInfo:
        """Re-open a lazy payload's container file in place — the repair
        controller's epoch switch after it rewrote chunks or appended a
        patch.  Preserves the ownership filter and the cumulative
        ``PayloadInfo`` counters; clears quarantine marks, injected debug
        faults, per-payload canary state (the fitness gauge restarts clean
        for the repaired epoch), and every cached body/tile so the next
        decode re-reads the repaired bytes."""
        sp = self._streams.get(name)
        if sp is None:
            raise KeyError(f"no stream payload {name!r}")
        old = self._info[name]
        ownership, tile_entries, path = sp.ownership, sp.tile_entries, sp.path
        if sp.warm is not None:
            warm, sp.warm = sp.warm, None
            with contextlib.suppress(Exception):
                warm.result()
        self._faults.pop(name, None)
        self._canary.pop(name, None)
        self._canary_calls.pop(name, None)
        self._drop_named_cache_entries(name)
        self._streams.pop(name, None)
        sp.view.release()
        self.load_stream(name, path, tile_entries=tile_entries)
        nsp = self._streams[name]
        nsp.ownership = ownership
        info = self._info[name]
        info.requests = old.requests
        info.entries_decoded = old.entries_decoded
        info.decode_calls = old.decode_calls
        info.cache_hits = old.cache_hits
        info.cache_misses = old.cache_misses
        obs.emit_event("payload_refreshed", payload=name, path=path)
        return info

    def export_chunk(self, name: str, chunk: int) -> bytes | None:
        """Exact bytes of one chunk, reconstructed from this instance's
        MATERIALIZED body — never from the file, whose copy of the chunk
        may be the corrupt one under repair.  ``Encoded.to_bytes`` is a
        bit-exact round trip, so slicing the re-serialized body at the
        footer's chunk spans reproduces the originally written bytes.

        Returns ``None`` when this instance cannot vouch for the bytes:
        the chunk is quarantined here, the body is not materializable
        (ownership filter, or its own chunks are corrupt), or the slice
        fails the footer CRC.  A non-``None`` return IS CRC-verified
        against the footer entry, so the repair controller can splice it
        into a damaged replica's file sight unseen."""
        sp = self._streams.get(name)
        if sp is None:
            raise KeyError(f"no stream payload {name!r}")
        chunk = int(chunk)
        if not 0 <= chunk < len(sp.chunks):
            raise ValueError(f"{name}: chunk {chunk} out of range")
        if chunk in sp.quarantine:
            return None
        try:
            if sp.versions is not None:
                raw = self._export_version_chunk(name, sp, chunk)
            else:
                raw = self._export_single_chunk(name, sp, chunk)
        except (ChunkCorruptError, NotOwnedError):
            return None
        if raw is None:
            return None
        c = sp.chunks[chunk]
        if len(raw) != c.length or zlib.crc32(raw) & 0xFFFFFFFF != c.crc:
            return None
        return raw

    def _export_single_chunk(
        self, name: str, sp: _StreamPayload, chunk: int
    ) -> bytes | None:
        enc = self._get(name, count=False)
        self._account_decode_state(name, enc)
        while isinstance(enc, _NoisyEncoded):  # noise is decode-side only
            enc = enc.inner
        nb = _n_base(sp)
        if chunk < nb:
            base = enc.base if isinstance(enc, container.PatchedEncoded) else enc
            body = base.to_bytes()
            off = sum(sp.chunks[i].length for i in range(chunk))
            return body[off : off + sp.chunks[chunk].length]
        if not isinstance(enc, container.PatchedEncoded):
            return None
        for p, oenc in enc.overlays:
            if p.chunk_start <= chunk < p.chunk_stop:
                body = oenc.to_bytes()
                off = sum(
                    sp.chunks[i].length for i in range(p.chunk_start, chunk)
                )
                return body[off : off + sp.chunks[chunk].length]
        return None

    def _export_version_chunk(
        self, name: str, sp: _StreamPayload, chunk: int
    ) -> bytes | None:
        for v, ve in enumerate(sp.versions):
            if ve.chunk_start <= chunk < ve.chunk_stop:
                enc = self._get_component(name, sp, v, count=False)
                self._account_version_state(name, sp, v, enc)
                body = enc.to_bytes()
                off = sum(
                    sp.chunks[i].length for i in range(ve.chunk_start, chunk)
                )
                return body[off : off + sp.chunks[chunk].length]
        return None

    def quarantine_stats(self) -> dict:
        """Payload name -> {chunk id -> error} for every quarantined chunk;
        empty when healthy.  Rides ``stats()`` so the fleet repair
        controller discovers corruption through the same wire poll as
        canary breaches.  (JSON transports stringify the chunk-id keys —
        consumers normalize with ``int``.)"""
        return {
            name: {int(cid): err for cid, err in sorted(sp.quarantine.items())}
            for name, sp in self._streams.items()
            if sp.quarantine
        }

    # ----------------------------------------------------------------- cache
    def _drop_named_cache_entries(self, name: str) -> None:
        for key in [k for k in self._cache if k[1] == name]:
            self._cache_evict(key)

    def _cache_evict(self, key: tuple) -> None:
        entry = self._cache.pop(key)
        self.cache_stats.resident_bytes -= entry.nbytes
        self.cache_stats.evictions += 1
        per = self.cache_stats.for_payload(key[1])
        per.resident_bytes -= entry.nbytes
        per.evictions += 1
        if entry.on_evict is not None:
            entry.on_evict()

    def _cache_put(self, key: tuple, entry: _CacheEntry) -> None:
        old = self._cache.pop(key, None)
        if old is not None:
            self.cache_stats.resident_bytes -= old.nbytes
            self.cache_stats.for_payload(key[1]).resident_bytes -= old.nbytes
        self._cache[key] = entry
        self.cache_stats.resident_bytes += entry.nbytes
        self.cache_stats.for_payload(key[1]).resident_bytes += entry.nbytes
        if self.cache_bytes is None:
            return
        while self.cache_stats.resident_bytes > self.cache_bytes and self._cache:
            self._cache_evict(next(iter(self._cache)))

    def _cache_touch(self, key: tuple) -> _CacheEntry | None:
        entry = self._cache.get(key)
        if entry is not None:
            self._cache.move_to_end(key)
        return entry

    def _account_decode_state(self, name: str, enc: codecs.Encoded) -> None:
        """Post-decode accounting: droppable payload state (SZ-lite dense
        cache, materialized lazy bodies) joins the LRU ledger."""
        info = self._info[name]
        sp = self._streams.get(name)
        if sp is not None and sp.enc is not None:
            nbytes = sp.body_nbytes + enc.cache_nbytes()

            def drop(sp=sp, name=name):
                if sp.enc is not None:
                    sp.enc.drop_caches()
                    sp.enc = None
                # the rebuilt Encoded starts its counters at zero; reset the
                # mirror baseline with it or the next sync under-counts
                self._enc_counters_seen.pop(name, None)

            self._cache_put(("enc", name), _CacheEntry(nbytes, None, drop))
        elif enc.cache_nbytes():
            self._cache_put(
                ("deccache", name),
                _CacheEntry(enc.cache_nbytes(), None, enc.drop_caches),
            )
        # mirror per-payload counters kept by the Encoded itself (SZ-lite):
        # enc counters are cumulative, so fold in only the delta since the
        # last sync (re-registration under a new name resets the baseline)
        own = (getattr(enc, "cache_hits", 0), getattr(enc, "cache_misses", 0))
        if isinstance(own[0], int) and any(own):
            seen = self._enc_counters_seen.get(name, (0, 0))
            info.cache_hits += own[0] - seen[0]
            info.cache_misses += own[1] - seen[1]
            self._enc_counters_seen[name] = own

    # ----------------------------------------------------------------- tiles
    def _decode_tiled(
        self, name: str, sp: _StreamPayload, enc: codecs.Encoded, idx: np.ndarray
    ) -> tuple[np.ndarray, int]:
        """Answer a query from T-entry decode tiles; returns (values,
        number of tiles actually decoded)."""
        shape = enc.shape
        t = sp.tile_entries
        n_entries = int(np.prod(shape))
        flat = multi_to_flat(idx, shape)
        tids = flat // t
        if not len(flat):  # delegate so the dtype matches the untiled path
            return self._decode_batched(enc, idx), 0
        info = self._info[name]

        # pass 1: classify — cached tiles resolve immediately, misses queue
        # for the (possibly pipelined) decode pass.  Same structure with
        # prefetch on or off, so stats and answers match bit-for-bit.
        tiles: dict[int, np.ndarray] = {}
        misses: list[int] = []
        for tid in np.unique(tids):
            entry = self._cache_touch(("tile", name, int(tid)))
            if entry is None:
                self.cache_stats.miss(name)
                info.cache_misses += 1
                misses.append(int(tid))
            else:
                self.cache_stats.hit(name)
                info.cache_hits += 1
                tiles[int(tid)] = entry.value

        # pass 2: decode misses.  The per-tile input block (flat range ->
        # multi indices) is pure CPU work independent of the decode, so
        # with prefetch on, tile k+1's block is built on the background
        # thread while tile k decodes.
        def build(tid: int) -> np.ndarray:
            start = tid * t
            stop = min(start + t, n_entries)
            return flat_to_multi(np.arange(start, stop, dtype=np.int64), shape)

        pool = self._pool()
        with obs.span("tile_decode", payload=name, tiles=len(misses)) if misses \
                else contextlib.nullcontext():
            fut = None
            if pool is not None and len(misses) > 1:
                fut = pool.submit(build, misses[0])
            for j, tid in enumerate(misses):
                if fut is not None:
                    tpos = fut.result()
                    fut = pool.submit(build, misses[j + 1]) if j + 1 < len(misses) else None
                else:
                    tpos = build(tid)
                tile = self._decode_batched(enc, tpos)
                tiles[tid] = tile
                # unowned tiles decode through WITHOUT caching — correct
                # mid-rebalance, and resident tile bytes stay this
                # instance's shard of the fleet total
                if sp.ownership is None or sp.ownership.owns_tile(tid):
                    self._cache_put(
                        ("tile", name, tid), _CacheEntry(int(tile.nbytes), tile)
                    )

        out = np.empty(len(flat), dtype=next(iter(tiles.values())).dtype)
        for tid, tile in tiles.items():
            mask = tids == tid
            out[mask] = tile[flat[mask] - tid * t]
        return out, len(misses)

    # --------------------------------------------------------------- queries
    def _decode_batched(self, enc: codecs.Encoded, idx: np.ndarray) -> np.ndarray:
        """Decode at most ``max_batch`` indices per ``enc.decode_at`` call —
        EVERY decode (direct, coalesced, tile fill) funnels through here so
        no path can materialize one giant device batch."""
        if idx.shape[0] <= self.max_batch:
            return np.asarray(enc.decode_at(idx))
        return np.concatenate(
            [
                np.asarray(enc.decode_at(idx[s : s + self.max_batch]))
                for s in range(0, idx.shape[0], self.max_batch)
            ]
        )

    def _validate(self, name: str, enc: codecs.Encoded,
                  indices: np.ndarray) -> np.ndarray:
        return validate_indices(name, tuple(enc.shape), indices)

    def decode_at(
        self, name: str, indices: np.ndarray, version: int | None = None
    ) -> np.ndarray:
        """Chunked decode so arbitrarily large requests stream through
        fixed-size batches.  Indices are validated up front; stats count
        only work that actually decoded.  ``version`` selects a v4
        payload's version (default: latest); single-tensor payloads
        reject it."""
        with obs.span("decode_at", payload=name, entries=int(np.size(indices))):
            sp = self._streams.get(name)
            if sp is not None and sp.versions is not None:
                v = self._resolve_version(name, sp, version)
                shape = self._ensure_version_geometry(name, sp)
                idx = validate_indices(name, shape, indices)
                out, calls = self._decode_versioned(name, sp, idx, v)
            else:
                if version is not None:
                    raise ValueError(
                        f"payload {name!r} is not versioned (version={version})"
                    )
                enc = self._get(name)
                idx = self._validate(name, enc, indices)
                if sp is not None and sp.tile_entries:
                    out, calls = self._decode_tiled(name, sp, enc, idx)
                else:
                    out = self._decode_batched(enc, idx)
                    # ceil-div: 0 for an empty query, matching the tiled path
                    # (which reports 0 tiles decoded for an empty query)
                    calls = -(-idx.shape[0] // self.max_batch)
                self._account_decode_state(name, enc)
                if self.canary_fraction and sp is not None:
                    self._maybe_canary(name, sp, enc)
            info = self._info[name]
            info.requests += 1
            info.entries_decoded += idx.shape[0]
            info.decode_calls += calls
            return out

    # -------------------------------------------------------------- canaries
    def _maybe_canary(
        self, name: str, sp: _StreamPayload, enc: codecs.Encoded
    ) -> None:
        """Maybe run one online fitness check after a served decode.

        The sampling decision hashes (seed, payload, per-payload call
        number) so it is DETERMINISTIC in the request sequence — two
        instances serving the same stream canary the same calls, and a
        Local vs Socket transport cannot diverge.  The check decodes
        through :meth:`_decode_batched` (a pure read), so served answers
        are untouched; only stats move.
        """
        if sp.heldout is None:
            return
        k = self._canary_calls.get(name, 0)
        self._canary_calls[name] = k + 1
        h = zlib.crc32(f"{self.canary_seed}:{name}:{k}".encode())
        if h >= self.canary_fraction * 2**32:
            return
        idx, truth = sp.heldout.indices, sp.heldout.values
        if len(idx) > self.canary_max_entries:
            pick = np.random.default_rng((self.canary_seed, k)).choice(
                len(idx), size=self.canary_max_entries, replace=False
            )
            idx, truth = idx[pick], truth[pick]
        with obs.span("canary", payload=name, entries=len(idx)):
            pos = flat_to_multi(idx, tuple(int(s) for s in enc.shape))
            approx = np.asarray(self._decode_batched(enc, pos), np.float64)
        err = approx - truth
        fitness = float(
            1.0 - np.linalg.norm(err) / max(np.linalg.norm(truth), 1e-30)
        )
        st = self._canary.setdefault(name, _CanaryState())
        st.checks += 1
        st.last_fitness = fitness
        st.window.append(fitness)
        self.metrics.gauge("canary_fitness", payload=name).set(
            st.rolling_fitness()
        )
        self.metrics.counter("canary_checks", payload=name).inc()
        if (
            self.canary_min_fitness is not None
            and fitness < self.canary_min_fitness
        ):
            st.breaches += 1
            self.metrics.counter("canary_breaches", payload=name).inc()
            worst = int(idx[int(np.argmax(np.abs(err)))])
            chunk, lo, hi = self._chunk_of_entry(sp, worst)
            st.last_breach = {
                "fitness": fitness,
                "threshold": float(self.canary_min_fitness),
                "worst_index": worst,
                "chunk": chunk,
                "entry_start": lo,
                "entry_stop": hi,
            }
            obs.emit_event(
                "quality_breach",
                payload=name,
                fitness=fitness,
                threshold=float(self.canary_min_fitness),
                worst_index=worst,
                chunk=chunk,
                entry_start=lo,
                entry_stop=hi,
            )

    @staticmethod
    def _chunk_of_entry(
        sp: _StreamPayload, flat: int
    ) -> tuple[int | None, int | None, int | None]:
        """The BASE chunk whose footer entry range routes ``flat`` — names
        the repair target for a quality breach (patch chunks also carry
        ranges but base chunks are the stable repair address).  (None,
        None, None) when the file carries no entry ranges."""
        for i, c in enumerate(sp.chunks[: _n_base(sp)]):
            if (
                c.entry_start is not None
                and c.entry_start <= flat < c.entry_stop
            ):
                return i, int(c.entry_start), int(c.entry_stop)
        return None, None, None

    def canary_stats(self) -> dict:
        """Per-payload canary snapshot (checks/breaches/fitness); empty
        until a canary has actually run."""
        return {name: st.as_dict() for name, st in self._canary.items()}

    def stats(self) -> dict:
        """Full JSON-able instance snapshot: the cache-stats wire schema
        plus ``canary`` and ``quarantine`` sub-dicts.  Additive over
        ``cache_stats.as_dict`` so old consumers of the transport stats
        blob keep working."""
        out = self.cache_stats.as_dict()
        out["canary"] = self.canary_stats()
        out["quarantine"] = self.quarantine_stats()
        return out

    # --------------------------------------------------------------- batched
    def submit(
        self, name: str, indices: np.ndarray, version: int | None = None
    ) -> int:
        """Queue a request; returns a ticket resolved by the next flush().

        Validates eagerly — a malformed request raises HERE and never
        enters the queue, so it cannot sink the coalesced batch.
        ``version=None`` on a versioned payload resolves to the LATEST
        version at submit time, so the coalesced group is concrete."""
        sp = self._streams.get(name)
        if sp is not None and sp.versions is not None:
            v = self._resolve_version(name, sp, version)
            shape = self._ensure_version_geometry(name, sp)
            idx = validate_indices(name, shape, indices)
        else:
            if version is not None:
                raise ValueError(
                    f"payload {name!r} is not versioned (version={version})"
                )
            idx = self._validate(name, self._get(name, count=False), indices)
            v = None
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queue.append((ticket, name, idx, v))
        return ticket

    def flush(self) -> dict[int, np.ndarray]:
        """Decode all queued requests, one coalesced batch per (payload,
        version) group.

        A group that still fails is isolated: its tickets go to
        ``self.failed`` (ticket -> exception, reset each flush) and the
        other groups' results are returned normally."""
        self.failed = {}
        by_group: dict[tuple[str, int | None], list[tuple[int, np.ndarray]]] = {}
        for ticket, name, idx, version in self._queue:
            by_group.setdefault((name, version), []).append((ticket, idx))
        self._queue.clear()
        results: dict[int, np.ndarray] = {}
        with obs.span(
            "coalesce_flush",
            tickets=sum(len(reqs) for reqs in by_group.values()),
            groups=len(by_group),
        ):
            for (name, version), reqs in by_group.items():
                merged = np.concatenate([idx for _, idx in reqs], axis=0)
                try:
                    values = self.decode_at(name, merged, version=version)
                except Exception as e:  # noqa: BLE001 — isolate the bad group
                    for ticket, _ in reqs:
                        self.failed[ticket] = e
                    continue
                self._info[name].requests += len(reqs) - 1  # decode_at counted one
                off = 0
                for ticket, idx in reqs:
                    results[ticket] = values[off : off + idx.shape[0]]
                    off += idx.shape[0]
        return results
