"""Versioned self-describing container, byte-compatible with
``repro.codecs.container``.

Monolithic layout (``flags == 0``):

    magic 'TCDC' | u16 version=3 | u8 flags | u8 name_len | name ascii
    u64 body_len | u32 crc32(body) | body

Chunked layout (``flags & FLAG_CHUNKED``) replaces the single body with
chunks indexed by a footer:

    header (as above) | chunk bytes ... | footer | u64 footer_len | 'TCDX'
    footer = chunk index | [ranges block] | [version-index block]
                         | [held-out block] | [patch block]
    chunk index   = u32 n_chunks | n x (u64 offset | u64 length | u32 crc32)
    ranges block  = 'TCDR' | n x (u64 entry_start | u64 entry_stop)
    version index = 'TCDV' | u32 n_versions
                           | n x (i64 base | u32 chunk_start | u32 chunk_stop)
    held-out      = 'TCDQ' | u32 n_entries | n x u64 flat_index | n x f64 value
    patch block   = 'TCDP' | u32 n_patches
                           | n x (u64 entry_start | u64 entry_stop
                                  | u32 chunk_start | u32 chunk_stop
                                  | u8 codec_len | codec ascii)

The footer blocks after the chunk index are optional and magic-tagged,
parsed in the fixed order above; any trailing bytes the blocks do not
account for make the footer corrupt.  The concatenated chunks of a v3
file ARE the codec's ``Encoded.to_bytes()`` body.

The patch (``TCDP``) block is the durable artifact of a read repair:
each entry names a flat-entry range whose decode is OVERRIDDEN by a
stand-alone overlay payload whose body is ``chunks[chunk_start:chunk_stop)``.
Patch chunks always occupy a suffix of the chunk index (appended by
``repro_torch.stream.writer.append_patch``), so the BASE payload --
``chunks[:n_base]`` -- is byte-identical to what was first written and
untouched entry ranges keep decoding bit-identically.  Overlapping
patches resolve last-wins.  A v4 delta container with a patch block is
rejected.

The held-out (``TCDQ``) block carries ground-truth entries sampled from
the ORIGINAL tensor at fit time (flat index + exact value), recorded by
``repro_torch.stream.ChunkedWriter``.

Delta layout (container **v4**: ``u16 version=4`` with ``FLAG_CHUNKED |
FLAG_DELTA``, written by ``repro_torch.stream.writer`` in delta mode)
stores a SEQUENCE of related tensors in one file.  The version-index
block partitions the chunk index into per-version chunk ranges: version
``v``'s codec body is the concatenation of
``chunks[chunk_start:chunk_stop)``.  ``base == -1`` marks a keyframe;
``base == k`` a delta whose decode is ADDED to version ``k``'s, so
version ``v`` decodes as the sum of its chain back to a keyframe
(``repro_torch.temporal.delta``).

The concatenated chunks of a v3 file (or of one v4 version) ARE the
codec's ``Encoded.to_bytes()`` body.  ``load_bytes`` reads monolithic v3,
chunked v3 (every footer block parsed and validated, every chunk
CRC-checked, patch overlays applied), v4 delta files (decoded at their
latest version) and bare legacy v2 NTTD blobs, and hands ``device`` on to
every component's ``from_bytes``.  ``open_container``/``open_chunks``
expose the index without touching chunk bytes; the write side
(``pack_footer``) serves ``repro_torch.stream.writer``, which writes
files byte-identical to the reference's.

``write_array``/``read_array`` preserve dtype and shape so float64
payload arrays round-trip bit-exactly.
"""
from __future__ import annotations

import dataclasses
import io
import mmap
import struct
import zlib

import numpy as np

from repro_torch.codecs.base import Encoded, get_codec
from repro_torch.devices import resolve_device

MAGIC = b"TCDC"
VERSION = 3
DELTA_VERSION = 4  # container carrying a version-index (delta chain) block
FOOTER_MAGIC = b"TCDX"
RANGES_MAGIC = b"TCDR"  # optional per-chunk entry-range block in the footer
VINDEX_MAGIC = b"TCDV"  # optional version-index block in the footer
HELDOUT_MAGIC = b"TCDQ"  # optional held-out ground-truth block in the footer
PATCH_MAGIC = b"TCDP"  # optional read-repair patch (overlay) block in the footer
FLAG_CHUNKED = 0x01
FLAG_DELTA = 0x02  # chunk index is partitioned into versions (v4 only)
_LEGACY_NTTD_VERSION = 2
_TRAILER_LEN = 12  # u64 footer_len + FOOTER_MAGIC

_DTYPES = {
    0: np.float16,
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.int64,
    5: np.uint8,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# array helpers (the framing of codec bodies)
# ---------------------------------------------------------------------------
def write_array(out: io.BytesIO, arr: np.ndarray) -> None:
    """u8 dtype-code | u8 ndim | ndim x u64 shape | raw bytes (C order)."""
    arr = np.ascontiguousarray(arr)
    out.write(struct.pack("<BB", _DTYPE_CODES[arr.dtype], arr.ndim))
    out.write(np.asarray(arr.shape, dtype=np.uint64).tobytes())
    out.write(arr.tobytes())


def pack_arrays(*arrays: np.ndarray) -> bytes:
    """u8 count | count x array — the shared body framing for the
    decomposition codecs (TT/Tucker/CP/TR cores and factors)."""
    if len(arrays) > 255:
        raise ValueError("too many arrays for u8 count")
    out = io.BytesIO()
    out.write(struct.pack("<B", len(arrays)))
    for arr in arrays:
        write_array(out, arr)
    return out.getvalue()


def unpack_arrays(data: bytes) -> list[np.ndarray]:
    buf = io.BytesIO(data)
    head = buf.read(1)
    if not head:
        raise ValueError("truncated payload: array count")
    (n,) = struct.unpack("<B", head)
    return [read_array(buf) for _ in range(n)]


def read_array(buf: io.BytesIO) -> np.ndarray:
    head = buf.read(2)
    if len(head) < 2:
        raise ValueError("truncated payload: array header")
    code, ndim = struct.unpack("<BB", head)
    if code not in _DTYPES:
        raise ValueError(f"corrupt payload: unknown dtype code {code}")
    shape = tuple(np.frombuffer(buf.read(8 * ndim), dtype=np.uint64).astype(int))
    dtype = np.dtype(_DTYPES[code])
    nbytes = int(np.prod(shape)) * dtype.itemsize if ndim else dtype.itemsize
    raw = buf.read(nbytes)
    if len(raw) < nbytes:
        raise ValueError("truncated payload: array body")
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChunkEntry:
    offset: int  # absolute file offset of the chunk's first byte
    length: int
    crc: int
    #: optional flat-entry range [entry_start, entry_stop) this chunk is
    #: responsible for — a ROUTING partition of the tensor's flat index
    #: space (recorded by the stream writer), not a decode dependency:
    #: the fleet router uses it to assign queries to chunk owners, while
    #: decoding still concatenates all chunks into the payload body.
    entry_start: int | None = None
    entry_stop: int | None = None


@dataclasses.dataclass(frozen=True)
class VersionEntry:
    """One version in a v4 delta file's version-index block.

    ``base == -1`` marks a keyframe; otherwise the version's decode is a
    residual to be ADDED to version ``base``'s decode.  The version's codec
    body is the concatenation of ``chunks[chunk_start:chunk_stop)``.
    """

    base: int
    chunk_start: int
    chunk_stop: int

    @property
    def is_keyframe(self) -> bool:
        return self.base < 0


@dataclasses.dataclass(frozen=True)
class PatchEntry:
    """One read-repair overlay in the ``TCDP`` footer block.

    The overlay's codec body is ``chunks[chunk_start:chunk_stop)``; its
    decode REPLACES the base payload's values for flat entries in
    ``[entry_start, entry_stop)`` (the overlay tensor's own shape must
    hold exactly ``entry_stop - entry_start`` entries, addressed by
    ``flat - entry_start`` in row-major order).  Entries outside every
    patch range keep decoding from the untouched base chunks."""

    entry_start: int
    entry_stop: int
    chunk_start: int
    chunk_stop: int
    codec: str


@dataclasses.dataclass(frozen=True)
class HeldoutEntries:
    """Fit-time ground truth for online fitness canaries: exact values of
    ``n`` entries of the ORIGINAL tensor, addressed by flat index.  Both
    arrays are the footer block verbatim (int64 indices, float64 values),
    so recording and re-reading round-trips bit-exactly."""

    indices: np.ndarray  # [n] int64 flat indices into the original tensor
    values: np.ndarray   # [n] float64 original values at those indices

    def __post_init__(self):
        idx = np.ascontiguousarray(np.asarray(self.indices, dtype=np.int64))
        vals = np.ascontiguousarray(np.asarray(self.values, dtype=np.float64))
        if idx.ndim != 1 or vals.ndim != 1 or len(idx) != len(vals):
            raise ValueError(
                f"held-out indices/values must be equal-length 1-D arrays, "
                f"got {idx.shape} / {vals.shape}"
            )
        if len(idx) and int(idx.min()) < 0:
            raise ValueError("held-out flat indices must be non-negative")
        object.__setattr__(self, "indices", idx)
        object.__setattr__(self, "values", vals)

    def __len__(self) -> int:
        return len(self.indices)


def pack_header(codec_name: str, flags: int = 0, version: int = VERSION) -> bytes:
    name = codec_name.encode("ascii")
    if not name or len(name) > 255:
        raise ValueError(f"bad codec id {codec_name!r}")
    return MAGIC + struct.pack("<HBB", version, flags, len(name)) + name


def pack_footer(
    chunks: list[ChunkEntry],
    versions: list[VersionEntry] | None = None,
    heldout: HeldoutEntries | None = None,
    patches: list[PatchEntry] | None = None,
) -> bytes:
    footer = struct.pack("<I", len(chunks)) + b"".join(
        struct.pack("<QQI", c.offset, c.length, c.crc) for c in chunks
    )
    # entry ranges are all-or-nothing: a partial mapping cannot route
    if chunks and all(c.entry_start is not None for c in chunks):
        footer += RANGES_MAGIC + b"".join(
            struct.pack("<QQ", c.entry_start, c.entry_stop) for c in chunks
        )
    if versions is not None:
        footer += VINDEX_MAGIC + struct.pack("<I", len(versions)) + b"".join(
            struct.pack("<qII", v.base, v.chunk_start, v.chunk_stop) for v in versions
        )
    if heldout is not None and len(heldout):
        footer += (
            HELDOUT_MAGIC
            + struct.pack("<I", len(heldout))
            + heldout.indices.astype("<i8").tobytes()
            + heldout.values.astype("<f8").tobytes()
        )
    if patches:
        footer += PATCH_MAGIC + struct.pack("<I", len(patches))
        for p in patches:
            name = p.codec.encode("ascii")
            if not name or len(name) > 255:
                raise ValueError(f"bad patch codec id {p.codec!r}")
            footer += struct.pack(
                "<QQIIB", p.entry_start, p.entry_stop,
                p.chunk_start, p.chunk_stop, len(name),
            ) + name
    return footer + struct.pack("<Q", len(footer)) + FOOTER_MAGIC


def _parse_header(data) -> tuple[int, str, int]:
    """-> (flags, codec name, offset just past the header)."""
    if len(data) < 8:
        raise ValueError("truncated payload: header")
    flags, name_len = struct.unpack("<BB", bytes(data[6:8]))
    if len(data) < 8 + name_len:
        raise ValueError("truncated payload: codec id")
    name = bytes(data[8 : 8 + name_len]).decode("ascii")
    return flags, name, 8 + name_len


def _validate_versions(
    versions: list[VersionEntry], n_chunks: int, ctx: str = ""
) -> None:
    """Version entries must contiguously partition [0, n_chunks) from 0 and
    form well-founded base chains (keyframe 0, bases strictly backwards)."""
    if not versions:
        raise ValueError(f"{ctx}corrupt payload: empty version index")
    expect = 0
    for i, v in enumerate(versions):
        if v.chunk_start != expect or v.chunk_stop <= v.chunk_start:
            raise ValueError(f"{ctx}corrupt payload: version {i} chunk range")
        expect = v.chunk_stop
        if i == 0 and not v.is_keyframe:
            raise ValueError(f"{ctx}corrupt payload: version 0 must be a keyframe")
        if not v.is_keyframe and v.base >= i:
            raise ValueError(f"{ctx}corrupt payload: version {i} base {v.base}")
    if expect != n_chunks:
        raise ValueError(f"{ctx}corrupt payload: version index does not cover chunks")


def _validate_patches(
    patches: list[PatchEntry], n_chunks: int, ctx: str = ""
) -> None:
    """Patch chunk ranges must be non-empty, disjoint, and together cover a
    SUFFIX ``[n_base, n_chunks)`` of the chunk index — the invariant that
    keeps ``chunks[:n_base]`` the untouched base payload."""
    covered: set[int] = set()
    for i, p in enumerate(patches):
        if p.entry_stop <= p.entry_start or p.entry_start < 0:
            raise ValueError(f"{ctx}corrupt payload: patch {i} entry range")
        if not 0 <= p.chunk_start < p.chunk_stop <= n_chunks:
            raise ValueError(f"{ctx}corrupt payload: patch {i} chunk range")
        ids = set(range(p.chunk_start, p.chunk_stop))
        if ids & covered:
            raise ValueError(f"{ctx}corrupt payload: patch {i} chunks overlap")
        covered |= ids
    if covered and covered != set(range(min(covered), n_chunks)):
        raise ValueError(f"{ctx}corrupt payload: patch chunks must be a suffix")


def patch_base_count(n_chunks: int, patches: list[PatchEntry] | None) -> int:
    """Number of BASE (non-patch) chunks — patch chunks are a validated
    suffix, so the base payload is always ``chunks[:n_base]``."""
    if not patches:
        return n_chunks
    return min(p.chunk_start for p in patches)


def _parse_footer(
    data, header_end: int, ctx: str = ""
) -> tuple[
    list[ChunkEntry],
    list[VersionEntry] | None,
    HeldoutEntries | None,
    list[PatchEntry],
]:
    """Parse the trailer-addressed footer: chunk index, then the optional
    magic-tagged TCDR (entry ranges), TCDV (version index), TCDQ
    (held-out ground truth), and TCDP (read-repair patch) blocks."""
    if len(data) < header_end + _TRAILER_LEN:
        raise ValueError(f"{ctx}truncated payload: chunk trailer")
    if bytes(data[-4:]) != FOOTER_MAGIC:
        raise ValueError(f"{ctx}truncated payload: chunk footer magic missing")
    (footer_len,) = struct.unpack("<Q", bytes(data[-12:-4]))
    footer_start = len(data) - _TRAILER_LEN - footer_len
    if footer_start < header_end:
        raise ValueError(f"{ctx}corrupt payload: chunk footer overlaps header")
    footer = bytes(data[footer_start : footer_start + footer_len])
    if len(footer) < 4:
        raise ValueError(f"{ctx}truncated payload: chunk index")
    (n,) = struct.unpack("<I", footer[:4])
    pos = 4 + 20 * n
    if len(footer) < pos:
        raise ValueError(f"{ctx}corrupt payload: chunk index length mismatch")
    ranges: list[tuple[int, int]] | None = None
    if footer[pos : pos + 4] == RANGES_MAGIC:
        if len(footer) < pos + 4 + 16 * n:
            raise ValueError(f"{ctx}corrupt payload: chunk index length mismatch")
        ranges = [
            struct.unpack("<QQ", footer[pos + 4 + 16 * i : pos + 20 + 16 * i])
            for i in range(n)
        ]
        pos += 4 + 16 * n
    versions: list[VersionEntry] | None = None
    if footer[pos : pos + 4] == VINDEX_MAGIC:
        if len(footer) < pos + 8:
            raise ValueError(f"{ctx}truncated payload: version index")
        (nv,) = struct.unpack("<I", footer[pos + 4 : pos + 8])
        pos += 8
        if len(footer) < pos + 16 * nv:
            raise ValueError(f"{ctx}truncated payload: version index")
        versions = [
            VersionEntry(*struct.unpack("<qII", footer[pos + 16 * i : pos + 16 * (i + 1)]))
            for i in range(nv)
        ]
        pos += 16 * nv
        _validate_versions(versions, n, ctx)
    heldout: HeldoutEntries | None = None
    if footer[pos : pos + 4] == HELDOUT_MAGIC:
        if len(footer) < pos + 8:
            raise ValueError(f"{ctx}truncated payload: held-out block")
        (nq,) = struct.unpack("<I", footer[pos + 4 : pos + 8])
        pos += 8
        if nq == 0:
            raise ValueError(f"{ctx}corrupt payload: empty held-out block")
        if len(footer) < pos + 16 * nq:
            raise ValueError(f"{ctx}truncated payload: held-out block")
        idx = np.frombuffer(footer, dtype="<i8", count=nq, offset=pos)
        vals = np.frombuffer(footer, dtype="<f8", count=nq, offset=pos + 8 * nq)
        if len(idx) and int(idx.min()) < 0:
            raise ValueError(f"{ctx}corrupt payload: held-out index negative")
        heldout = HeldoutEntries(idx, vals)
        pos += 16 * nq
    patches: list[PatchEntry] = []
    if footer[pos : pos + 4] == PATCH_MAGIC:
        if len(footer) < pos + 8:
            raise ValueError(f"{ctx}truncated payload: patch block")
        (np_,) = struct.unpack("<I", footer[pos + 4 : pos + 8])
        pos += 8
        for _ in range(np_):
            if len(footer) < pos + 25:
                raise ValueError(f"{ctx}truncated payload: patch block")
            lo, hi, cstart, cstop, nlen = struct.unpack(
                "<QQIIB", footer[pos : pos + 25]
            )
            pos += 25
            if len(footer) < pos + nlen:
                raise ValueError(f"{ctx}truncated payload: patch codec id")
            codec = footer[pos : pos + nlen].decode("ascii")
            pos += nlen
            patches.append(PatchEntry(lo, hi, cstart, cstop, codec))
        _validate_patches(patches, n, ctx)
    if pos != len(footer):
        raise ValueError(f"{ctx}corrupt payload: chunk index length mismatch")
    chunks = []
    for i in range(n):
        off, length, crc = struct.unpack("<QQI", footer[4 + 20 * i : 24 + 20 * i])
        if off < header_end or off + length > footer_start:
            raise ValueError(f"{ctx}corrupt payload: chunk outside data region")
        start, stop = ranges[i] if ranges is not None else (None, None)
        chunks.append(ChunkEntry(off, length, crc, start, stop))
    return chunks, versions, heldout, patches


def _check_delta(
    data, flags: int, header_end: int, ctx: str = ""
) -> tuple[list[ChunkEntry], list[VersionEntry], HeldoutEntries | None]:
    """Parse + validate a v4 footer: both delta flags and a version index
    are mandatory, so a v4 file is never silently read as a single tensor."""
    if not (flags & FLAG_CHUNKED) or not (flags & FLAG_DELTA):
        raise ValueError(f"{ctx}corrupt payload: v4 container without delta flags")
    chunks, versions, heldout, patches = _parse_footer(data, header_end, ctx)
    if versions is None:
        raise ValueError(f"{ctx}corrupt payload: v4 container missing version index")
    if patches:
        raise ValueError(f"{ctx}corrupt payload: patch block on a delta container")
    return chunks, versions, heldout


def read_chunk(data, chunk: ChunkEntry, ctx: str = "") -> bytes:
    """Materialize one chunk's bytes, CRC-checked.  ``ctx`` (conventionally
    ``f"{path}: "``) prefixes both failure messages so a corrupt chunk names
    the file it lives in, matching every other container error path."""
    raw = bytes(data[chunk.offset : chunk.offset + chunk.length])
    if len(raw) < chunk.length:
        raise ValueError(f"{ctx}truncated payload: chunk body")
    if zlib.crc32(raw) & 0xFFFFFFFF != chunk.crc:
        raise ValueError(f"{ctx}corrupt payload: chunk checksum mismatch")
    return raw


class PatchedEncoded(Encoded):
    """A base payload with read-repair overlays applied last-wins.

    Entries inside a patch's ``[entry_start, entry_stop)`` come from the
    overlay payload (addressed by ``flat - entry_start`` in the overlay's
    own row-major index space); everything else comes from the untouched
    base payload.  Serialization goes through the container file (writer
    ``append_patch``), not ``to_bytes``: the patched whole has no single
    codec body.  The base and each overlay decode where their own
    ``from_bytes`` placed them.
    """

    def __init__(
        self, base: Encoded, overlays: list[tuple[PatchEntry, Encoded]]
    ):
        self.base = base
        self.overlays = list(overlays)
        for p, enc in self.overlays:
            n = int(np.prod(enc.shape))
            if n != p.entry_stop - p.entry_start:
                raise ValueError(
                    f"corrupt payload: patch overlay shape {enc.shape} holds "
                    f"{n} entries, range needs {p.entry_stop - p.entry_start}"
                )

    @property
    def codec_name(self) -> str:  # type: ignore[override]
        return self.base.codec_name

    @property
    def shape(self) -> tuple[int, ...]:
        return self.base.shape

    def decode_at(self, indices: np.ndarray) -> np.ndarray:
        out = np.asarray(self.base.decode_at(indices))
        if not self.overlays:
            return out
        idx = np.asarray(indices, dtype=np.int64)
        flat = np.ravel_multi_index(tuple(idx.T), self.base.shape).astype(np.int64)
        for p, enc in self.overlays:  # later patches win
            mask = (flat >= p.entry_start) & (flat < p.entry_stop)
            if not mask.any():
                continue
            local = flat[mask] - p.entry_start
            pos = np.stack(
                np.unravel_index(local, enc.shape), axis=1
            ).astype(np.int64)
            out = out.copy()
            out[mask] = np.asarray(enc.decode_at(pos), out.dtype)
        return out

    def to_dense(self) -> np.ndarray:
        out = np.asarray(self.base.to_dense()).copy()
        flat = out.reshape(-1)
        for p, enc in self.overlays:
            flat[p.entry_start : p.entry_stop] = np.asarray(
                enc.to_dense(), flat.dtype
            ).reshape(-1)
        return out

    def payload_bytes(self) -> int:
        return self.base.payload_bytes() + sum(
            enc.payload_bytes() for _, enc in self.overlays
        )

    def to_bytes(self) -> bytes:
        raise NotImplementedError(
            "patched payloads serialize through the container file "
            "(stream.writer.append_patch), not to_bytes"
        )

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "Encoded":
        raise NotImplementedError("patched payloads load via the container file")

    def cache_nbytes(self) -> int:
        return self.base.cache_nbytes() + sum(
            enc.cache_nbytes() for _, enc in self.overlays
        )

    def drop_caches(self) -> None:
        self.base.drop_caches()
        for _, enc in self.overlays:
            enc.drop_caches()


def _load_patch_overlay(data, chunks: list[ChunkEntry], p: PatchEntry,
                        device=None) -> Encoded:
    """Materialize one patch overlay's payload from its chunk suffix."""
    try:
        codec = get_codec(p.codec)
    except KeyError:
        raise ValueError(f"unknown codec id {p.codec!r} in patch block") from None
    body = b"".join(
        read_chunk(data, c) for c in chunks[p.chunk_start : p.chunk_stop]
    )
    return codec.encoded_cls.from_bytes(body, device=device)


def _codec_of(name: str):
    try:
        return get_codec(name)
    except KeyError:
        raise ValueError(f"unknown codec id {name!r} in container") from None


def save_bytes(enc: Encoded) -> bytes:
    body = enc.to_bytes()
    out = io.BytesIO()
    out.write(pack_header(enc.codec_name))
    out.write(struct.pack("<QI", len(body), zlib.crc32(body) & 0xFFFFFFFF))
    out.write(body)
    return out.getvalue()


def load_bytes(data: bytes, device=None) -> Encoded:
    """Decode a container (or a bare v2 NTTD blob) onto ``device`` (CUDA
    unless given; raises when CUDA is missing and no device was given).
    A v4 file decodes as the chain of its latest version; a v3 file with
    patch overlays as a ``PatchedEncoded``."""
    device = resolve_device(device)
    if len(data) < 4 or bytes(data[:4]) != MAGIC:
        raise ValueError("not a TensorCodec container")
    if len(data) < 6:
        raise ValueError("truncated payload: version header")
    (version,) = struct.unpack("<H", bytes(data[4:6]))
    if version == _LEGACY_NTTD_VERSION:
        # headerless NTTD blob (older checkpoints)
        from repro_torch.codecs.adapters import NTTDEncoded

        return NTTDEncoded.from_bytes(bytes(data), device=device)
    if version not in (VERSION, DELTA_VERSION):
        raise ValueError(f"unsupported container version {version}")
    flags, name, off = _parse_header(data)
    if version == DELTA_VERSION:
        chunks, versions, _ = _check_delta(data, flags, off)
        codec = _codec_of(name)
        from repro_torch.temporal.delta import load_chain

        bodies = [
            b"".join(read_chunk(data, c) for c in chunks[v.chunk_start : v.chunk_stop])
            for v in versions
        ]
        return load_chain(codec, bodies, versions, device=device)
    if flags & FLAG_DELTA:
        raise ValueError("corrupt payload: delta flag on a v3 container")
    if flags & FLAG_CHUNKED:
        chunks, versions, _, patches = _parse_footer(data, off)
        if versions is not None:
            raise ValueError("corrupt payload: version index on a v3 container")
        n_base = patch_base_count(len(chunks), patches)
        body = b"".join(read_chunk(data, c) for c in chunks[:n_base])
        if patches:
            base = _codec_of(name).encoded_cls.from_bytes(body, device=device)
            return PatchedEncoded(
                base,
                [(p, _load_patch_overlay(data, chunks, p, device)) for p in patches],
            )
    else:
        if len(data) < off + 12:
            raise ValueError("truncated payload: codec id")
        body_len, crc = struct.unpack("<QI", bytes(data[off : off + 12]))
        off += 12
        body = bytes(data[off : off + body_len])
        if len(body) < body_len:
            raise ValueError(
                f"truncated payload: body has {len(body)} of {body_len} bytes"
            )
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ValueError("corrupt payload: body checksum mismatch")
    return _codec_of(name).encoded_cls.from_bytes(body, device=device)


def save_file(path: str, enc: Encoded) -> int:
    data = save_bytes(enc)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_file(path: str, device=None) -> Encoded:
    with open(path, "rb") as f:
        return load_bytes(f.read(), device=device)


@dataclasses.dataclass
class OpenContainer:
    """Lazily opened container: header + footer parsed, chunk bytes mmapped.

    ``versions`` is ``None`` for a plain v3 (single tensor) file and the
    validated version index for a v4 delta file.  ``heldout`` is the
    fit-time ground-truth sample from the optional ``TCDQ`` footer block
    (``None`` for files written without one).
    """

    codec: str
    flags: int
    chunks: list[ChunkEntry]
    versions: list[VersionEntry] | None
    view: memoryview
    heldout: HeldoutEntries | None = None
    #: read-repair overlays (TCDP block); empty for unrepaired files
    patches: list[PatchEntry] = dataclasses.field(default_factory=list)

    @property
    def is_versioned(self) -> bool:
        return self.versions is not None

    @property
    def n_base(self) -> int:
        """Chunks before the patch suffix — the untouched base payload."""
        return patch_base_count(len(self.chunks), self.patches)

    @property
    def base_chunks(self) -> list[ChunkEntry]:
        return self.chunks[: self.n_base]

    def close(self) -> None:
        mm = self.view.obj
        self.view.release()
        if hasattr(mm, "close"):
            mm.close()


def open_container(path: str) -> OpenContainer:
    """Open a v3/v4 file lazily: parse header + footer, mmap the rest.

    No chunk bytes are read; callers materialize chunks on demand through
    ``read_chunk``.  Monolithic v3 files come back as one pseudo-chunk.
    """
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    view = memoryview(mm)
    try:
        if len(view) < 6 or bytes(view[:4]) != MAGIC:
            raise ValueError(f"{path}: not a TensorCodec container")
        (version,) = struct.unpack("<H", bytes(view[4:6]))
        if version not in (VERSION, DELTA_VERSION):
            raise ValueError(
                f"{path}: lazy open needs a v{VERSION}/v{DELTA_VERSION} "
                f"container, got v{version}"
            )
        flags, name, off = _parse_header(view)
        ctx = f"{path}: "
        if version == DELTA_VERSION:
            chunks, versions, heldout = _check_delta(view, flags, off, ctx)
            return OpenContainer(name, flags, chunks, versions, view, heldout)
        if flags & FLAG_DELTA:
            raise ValueError(f"{ctx}corrupt payload: delta flag on a v3 container")
        patches: list[PatchEntry] = []
        if flags & FLAG_CHUNKED:
            chunks, versions, heldout, patches = _parse_footer(view, off, ctx)
            if versions is not None:
                raise ValueError(
                    f"{ctx}corrupt payload: version index on a v3 container"
                )
        else:
            if len(view) < off + 12:
                raise ValueError(f"{ctx}truncated payload: codec id")
            body_len, crc = struct.unpack("<QI", bytes(view[off : off + 12]))
            if len(view) < off + 12 + body_len:
                raise ValueError(f"{ctx}truncated payload: body")
            chunks, heldout = [ChunkEntry(off + 12, body_len, crc)], None
        return OpenContainer(name, flags, chunks, None, view, heldout, patches)
    except Exception:
        view.release()
        mm.close()
        raise


def open_chunks(path: str) -> tuple[str, list[ChunkEntry], memoryview]:
    """Lazy open for single-tensor (v3) callers: ``(codec_name, chunks,
    mmap-backed view)``; rejects v4 delta files, whose chunk list only
    makes sense alongside the version index (use :func:`open_container`)."""
    oc = open_container(path)
    if oc.is_versioned:
        oc.close()
        raise ValueError(
            f"{path}: v{DELTA_VERSION} delta container needs open_container"
        )
    return oc.codec, oc.chunks, oc.view


def container_index(
    path: str,
) -> tuple[str, list[ChunkEntry], list[VersionEntry] | None]:
    """Parse a v3/v4 file's header + footer WITHOUT keeping it open.

    Read-repair patch chunks (the TCDP suffix) are EXCLUDED: the base
    chunks' entry-range partition is what routing uses, and a repair never
    changes it.  Callers that need the overlays use :func:`open_container`.
    """
    oc = open_container(path)
    oc.close()
    return oc.codec, oc.base_chunks, oc.versions


def chunk_index(path: str) -> tuple[str, list[ChunkEntry]]:
    """:func:`container_index` for single-tensor callers."""
    name, chunks, versions = container_index(path)
    if versions is not None:
        raise ValueError(
            f"{path}: v{DELTA_VERSION} delta container needs container_index"
        )
    return name, chunks
