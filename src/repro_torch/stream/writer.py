"""Chunked container writer: append payload bytes as fit progresses, as in
``repro.stream.writer``; for the same payload and the same calls it
writes files byte-identical to the reference's.

``ChunkedWriter`` writes the header up front, appends chunks as the
producer emits them (a finalized TT core, an accumulating fitter's
partial body, a periodic snapshot), and seals the file with the footer
chunk index on ``close`` — append-only, no seeking back to patch a
length field, so a crash leaves a file that is cleanly rejected rather
than silently half-read.

Two modes:

* default (container v3): the concatenated chunks are one codec's
  ``Encoded.to_bytes()`` body; ``write_chunked`` is the convenience that
  splits a finished payload into fixed-size chunks, which keeps a lazy
  loader (the reference's ``CodecService.load_stream``) from ever
  needing one giant read.
* ``delta=True`` (container v4): the file holds a SEQUENCE of bodies.
  ``begin_version(base)`` opens a version (``base=-1`` keyframe, else a
  residual against version ``base``); subsequent ``append`` calls belong
  to it; the footer's ``TCDV`` block records the per-version chunk
  ranges.  ``sync()`` is an opt-in durability point: it ends the open
  version and writes a footer NOW, leaving a valid readable file while
  the writer stays open — the next ``append`` truncates that footer and
  keeps going, so a crash mid-version loses only the unsynced tail.
  The reference's ``repro.temporal.VersionedStore`` builds on this.

Either mode can additionally record HELD-OUT ground truth for the serve
layer's online fitness canaries: ``record_heldout(flat_indices, values)``
accumulates exact original-tensor entries that every sync/close folds
into the footer's optional ``TCDQ`` block.  ``write_chunked`` takes the
same sample via ``heldout=``; files written without one parse exactly as
before (the block is optional), so old readers and old files both keep
working.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from repro_torch.codecs import container
from repro_torch.codecs.base import Encoded


class ChunkedWriter:
    def __init__(self, path: str, codec_name: str, *, delta: bool = False):
        self.path = path
        self.codec_name = codec_name
        self.delta = delta
        self._chunks: list[container.ChunkEntry] = []
        self._versions: list[container.VersionEntry] | None = [] if delta else None
        self._heldout_idx: list[np.ndarray] = []
        self._heldout_vals: list[np.ndarray] = []
        self._open_base: int | None = None
        self._open_start = 0
        flags = container.FLAG_CHUNKED | (container.FLAG_DELTA if delta else 0)
        version = container.DELTA_VERSION if delta else container.VERSION
        self._f = open(path, "w+b")
        self._offset = self._f.write(
            container.pack_header(codec_name, flags, version)
        )
        self._sealed = False  # a valid footer currently trails the data
        self._closed = False

    # -- delta versions ----------------------------------------------------
    def begin_version(self, base: int = -1) -> int:
        """Open version ``len(versions)``; returns its id.

        ``base=-1`` marks a keyframe; ``base=k`` a residual whose decode
        adds onto version ``k``'s.  Closes the previously open version
        (which must have received at least one chunk).
        """
        if not self.delta:
            raise ValueError(f"{self.path}: begin_version needs delta=True")
        if self._closed:
            raise ValueError(f"{self.path}: writer already closed")
        self._end_version()
        vid = len(self._versions)
        base = int(base)
        if vid == 0 and base != -1:
            raise ValueError(f"{self.path}: version 0 must be a keyframe (base=-1)")
        if not -1 <= base < vid:
            raise ValueError(f"{self.path}: bad base {base} for version {vid}")
        self._open_base = base
        self._open_start = len(self._chunks)
        return vid

    def _end_version(self) -> None:
        if self._open_base is None:
            return
        if len(self._chunks) == self._open_start:
            raise ValueError(
                f"{self.path}: version {len(self._versions)} has no chunks"
            )
        self._versions.append(
            container.VersionEntry(
                self._open_base, self._open_start, len(self._chunks)
            )
        )
        self._open_base = None

    # -- chunk appends -----------------------------------------------------
    def append(
        self, chunk: bytes, entry_range: tuple[int, int] | None = None
    ) -> int:
        """Append one chunk; returns its index in the footer.

        ``entry_range=(start, stop)`` records the flat-entry span this
        chunk ROUTES for (footer ``TCDR`` block) — the partition of the
        index space the fleet router shards ownership by (per version, in
        delta mode).  Ranges are all-or-nothing across chunks: the footer
        drops them unless every chunk has one.
        """
        if self._closed:
            raise ValueError(f"{self.path}: writer already closed")
        if self.delta and self._open_base is None:
            raise ValueError(
                f"{self.path}: append outside begin_version in delta mode"
            )
        if not chunk:
            raise ValueError("empty chunk")
        start, stop = (None, None) if entry_range is None else map(int, entry_range)
        if start is not None and not 0 <= start < stop:
            raise ValueError(f"bad entry_range ({start}, {stop})")
        self._unseal()
        self._f.write(chunk)
        self._chunks.append(
            container.ChunkEntry(
                self._offset, len(chunk), zlib.crc32(chunk) & 0xFFFFFFFF,
                start, stop,
            )
        )
        self._offset += len(chunk)
        return len(self._chunks) - 1

    def record_heldout(
        self, flat_indices: np.ndarray, values: np.ndarray
    ) -> int:
        """Accumulate held-out ground-truth entries (flat index + exact
        original value) for the footer's ``TCDQ`` block; returns the total
        recorded so far.  Call any time before close — typically at fit
        time, when the original values are still in hand.  Re-sealing
        (``sync``) folds everything recorded so far into the footer."""
        if self._closed:
            raise ValueError(f"{self.path}: writer already closed")
        idx = np.asarray(flat_indices, dtype=np.int64).reshape(-1)
        vals = np.asarray(values, dtype=np.float64).reshape(-1)
        if len(idx) != len(vals):
            raise ValueError(
                f"held-out indices/values length mismatch: {len(idx)} != {len(vals)}"
            )
        if len(idx):
            if int(idx.min()) < 0:
                raise ValueError("held-out flat indices must be non-negative")
            self._heldout_idx.append(idx)
            self._heldout_vals.append(vals)
            self._unseal()  # a synced footer no longer reflects the sample
        return self.heldout_recorded

    @property
    def heldout_recorded(self) -> int:
        return sum(len(a) for a in self._heldout_idx)

    def _heldout(self) -> container.HeldoutEntries | None:
        if not self._heldout_idx:
            return None
        return container.HeldoutEntries(
            np.concatenate(self._heldout_idx), np.concatenate(self._heldout_vals)
        )

    def _unseal(self) -> None:
        """Drop a footer written by an earlier ``sync`` so appends resume
        at the data end; the next sync/close writes a fresh footer."""
        if self._sealed:
            self._f.seek(self._offset)
            self._f.truncate()
            self._sealed = False

    @property
    def chunks_written(self) -> int:
        return len(self._chunks)

    @property
    def versions_written(self) -> int:
        return len(self._versions or ())

    # -- sealing -----------------------------------------------------------
    def sync(self) -> int:
        """Write a footer NOW without closing; returns current file bytes.

        Ends the open version first (delta mode).  The file is valid and
        readable from this moment even if the process dies — appends made
        after the last ``sync`` are the only thing a crash can lose.
        """
        if self._closed:
            raise ValueError(f"{self.path}: writer already closed")
        if self.delta:
            self._end_version()
            if not self._versions:
                raise ValueError(f"{self.path}: no versions to sync")
        if not self._sealed:
            self._f.write(
                container.pack_footer(self._chunks, self._versions, self._heldout())
            )
            self._f.flush()
            self._sealed = True
        return self._f.tell()

    def close(self) -> int:
        """Seal the file with the footer index; returns total file bytes."""
        if self._closed:
            return self._offset
        if self.delta:
            self._end_version()
            if not self._versions:
                raise ValueError(
                    f"{self.path}: delta file needs at least one version"
                )
        if not self._sealed:
            self._f.write(
                container.pack_footer(self._chunks, self._versions, self._heldout())
            )
        self._offset = self._f.tell()
        self._f.close()
        self._closed = True
        return self._offset

    def __enter__(self) -> "ChunkedWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:  # don't seal a half-written file as valid
            self._f.close()
            self._closed = True


def write_chunked(
    path: str,
    enc: Encoded,
    chunk_bytes: int = 1 << 20,
    heldout: tuple[np.ndarray, np.ndarray] | None = None,
) -> int:
    """Write a finished payload as a chunked v3 file; returns file bytes.

    Each byte chunk is stamped with an equal slice of the tensor's flat
    entry space (chunk i of n routes entries ``[i*E/n, (i+1)*E/n)``) so a
    fleet router can shard query ownership chunk-by-chunk without any
    knowledge of the codec's body layout.

    ``heldout=(flat_indices, values)`` records ground-truth ORIGINAL
    tensor entries into the footer's ``TCDQ`` block so the serve layer
    can run online fitness canaries against this file.  The values must
    come from the source tensor, not the codec's own decode — comparing
    a codec against itself would report perfect fitness forever.
    """
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    body = enc.to_bytes()
    if not body:
        raise ValueError("empty payload body")
    n_entries = int(np.prod(enc.shape))
    n_chunks = -(-len(body) // chunk_bytes)
    with ChunkedWriter(path, enc.codec_name) as w:
        if heldout is not None:
            idx = np.asarray(heldout[0], dtype=np.int64).reshape(-1)
            if len(idx) and int(idx.max()) >= n_entries:
                raise ValueError(
                    f"held-out flat index {int(idx.max())} out of range "
                    f"[0, {n_entries})"
                )
            w.record_heldout(idx, heldout[1])
        for i, off in enumerate(range(0, len(body), chunk_bytes)):
            lo = i * n_entries // n_chunks
            hi = (i + 1) * n_entries // n_chunks
            w.append(
                body[off : off + chunk_bytes],
                entry_range=(lo, hi) if hi > lo else None,
            )
        return w.close()


def _sealed_state(path: str):
    """Parse a sealed chunked file for mutation: footer contents plus the
    data end (where the footer starts) so a rewrite can truncate-and-reseal
    exactly the way ``ChunkedWriter._unseal``/``sync`` do."""
    oc = container.open_container(path)
    try:
        if not (oc.flags & container.FLAG_CHUNKED):
            raise ValueError(f"{path}: monolithic container cannot be rewritten")
        state = (oc.codec, list(oc.chunks), oc.versions, oc.heldout,
                 list(oc.patches))
    finally:
        oc.close()
    with open(path, "rb") as f:
        f.seek(-container._TRAILER_LEN, 2)
        trailer_at = f.tell()
        (footer_len,) = struct.unpack("<Q", f.read(8))
    return (*state, trailer_at - footer_len)


def rewrite_chunks(path: str, replacements: dict[int, bytes]) -> None:
    """Replace named chunks' BYTES in a sealed chunked file, in place.

    The read-repair swap primitive: a same-length replacement (the exact
    restore of a corrupt chunk from a replica's materialized body) is
    written at the chunk's original offset — every other byte of the file,
    footer included, is preserved verbatim.  A different-length replacement
    is appended at the data end and the chunk's index entry re-pointed
    (its id, entry range, and position in the footer never change, so
    routing tables stay valid); the old bytes become an unreferenced hole.
    Either way the footer is truncated and resealed, so a crash mid-rewrite
    leaves a file that is cleanly rejected, never silently half-patched.
    Live mmap readers keep their parsed index: same-length rewrites become
    visible to them byte-for-byte, relocations stay invisible until they
    re-open — both consistent states, which is what lets a fleet swap a
    repaired chunk under traffic (the reference's ``repro.fleet.repair``).
    """
    if not replacements:
        return
    codec, chunks, versions, heldout, patches, data_end = _sealed_state(path)
    for cid in replacements:
        if not 0 <= cid < len(chunks):
            raise ValueError(f"{path}: no chunk {cid} to rewrite")
        if not replacements[cid]:
            raise ValueError(f"{path}: empty replacement for chunk {cid}")
    with open(path, "r+b") as f:
        f.seek(data_end)
        f.truncate()  # unseal: drop the footer before mutating the index
        end = data_end
        for cid in sorted(replacements):
            raw = replacements[cid]
            c = chunks[cid]
            crc = zlib.crc32(raw) & 0xFFFFFFFF
            if len(raw) == c.length:
                f.seek(c.offset)
                f.write(raw)
                chunks[cid] = dataclasses.replace(c, crc=crc)
            else:
                f.seek(end)
                f.write(raw)
                chunks[cid] = container.ChunkEntry(
                    end, len(raw), crc, c.entry_start, c.entry_stop
                )
                end += len(raw)
        f.seek(end)
        f.write(container.pack_footer(chunks, versions, heldout, patches))
        f.flush()


def append_patch(
    path: str,
    body: bytes,
    entry_range: tuple[int, int],
    codec_name: str,
    chunk_bytes: int = 1 << 20,
) -> int:
    """Append a read-repair overlay to a sealed v3 file; returns its patch
    index in the ``TCDP`` block.

    ``body`` is the overlay payload's ``Encoded.to_bytes()`` — a
    stand-alone tensor holding exactly ``entry_stop - entry_start``
    entries whose decode REPLACES the base payload over ``entry_range``
    (see ``container.PatchEntry``).  The overlay's chunks join the chunk
    index as a suffix; base chunks are not touched, which is the whole
    point: untouched entry ranges keep decoding bit-identically after the
    repair.  Delta (v4) containers are rejected — repairing a version
    chain goes through exact chunk restore (``rewrite_chunks``), never an
    overlay.
    """
    lo, hi = int(entry_range[0]), int(entry_range[1])
    if not 0 <= lo < hi:
        raise ValueError(f"{path}: bad patch entry_range ({lo}, {hi})")
    if not body:
        raise ValueError(f"{path}: empty patch body")
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    codec, chunks, versions, heldout, patches, data_end = _sealed_state(path)
    if versions is not None:
        raise ValueError(f"{path}: cannot patch a delta container")
    n_base = container.patch_base_count(len(chunks), patches)
    stops = [c.entry_stop for c in chunks[:n_base] if c.entry_stop is not None]
    if stops and hi > max(stops):
        raise ValueError(
            f"{path}: patch entry_range ({lo}, {hi}) exceeds the payload's "
            f"{max(stops)} entries"
        )
    with open(path, "r+b") as f:
        f.seek(data_end)
        f.truncate()
        cstart = len(chunks)
        off = data_end
        for at in range(0, len(body), chunk_bytes):
            raw = body[at : at + chunk_bytes]
            f.write(raw)
            chunks.append(container.ChunkEntry(
                off, len(raw), zlib.crc32(raw) & 0xFFFFFFFF, lo, hi
            ))
            off += len(raw)
        patches.append(container.PatchEntry(
            lo, hi, cstart, len(chunks), codec_name
        ))
        f.write(container.pack_footer(chunks, versions, heldout, patches))
        f.flush()
    return len(patches) - 1


def sample_heldout(
    x: np.ndarray, n: int = 256, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic held-out sample of a dense source tensor: ``n``
    distinct flat indices (sorted) and their exact values, ready for
    ``write_chunked(..., heldout=...)`` / ``record_heldout``."""
    flat = np.asarray(x).reshape(-1)
    n = min(int(n), flat.size)
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(flat.size, size=n, replace=False)).astype(np.int64)
    return idx, flat[idx].astype(np.float64)
