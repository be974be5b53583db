"""Consistent-hash routing of payload chunks and decode tiles, as in
``repro.fleet.router``: the same members, vnodes and replication give the
reference's owners for every key, so mixed fleets agree.

The unit of ownership is a ring KEY: one per container chunk
(``name/c<i>``) and, for payloads served through the decode-tile cache,
one per tile (``name/t<tid>``).  A :class:`HashRing` hashes instance ids
onto a ring with virtual nodes; a key's owners are the first R distinct
instances clockwise from the key's point, so adding or removing one
instance moves only the keys whose owner arc it occupied — the property
that makes fleet rebalancing chunk-by-chunk instead of all-at-once.

:class:`PayloadRoute` is the payload-side half: built from a container's
chunk index (``repro_torch.codecs.container.chunk_index``), it maps a batch of
query indices onto ring keys — by decode tile when ``tile_entries`` is
set, else by the chunk whose recorded entry range covers the query's
flat index (uniform partition when the file predates entry ranges).
"""
from __future__ import annotations

import bisect
import hashlib

import numpy as np

from repro_torch.codecs import container
from repro_torch.codecs.indexing import multi_to_flat


def _hash(key: str) -> int:
    """Stable 64-bit point on the ring (independent of PYTHONHASHSEED)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring over instance ids with virtual nodes."""

    def __init__(
        self,
        instances: tuple[str, ...] | list[str] = (),
        *,
        vnodes: int = 64,
        replication: int = 1,
    ):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        if replication < 1:
            raise ValueError(f"replication must be >= 1, got {replication}")
        self.vnodes = vnodes
        self.replication = replication
        self._points: list[tuple[int, str]] = []  # sorted (hash, instance)
        self._instances: set[str] = set()
        for iid in instances:
            self.add(iid)

    @property
    def instances(self) -> list[str]:
        return sorted(self._instances)

    def __len__(self) -> int:
        return len(self._instances)

    def __contains__(self, iid: str) -> bool:
        return iid in self._instances

    def add(self, iid: str) -> None:
        if iid in self._instances:
            raise ValueError(f"instance {iid!r} already on the ring")
        self._instances.add(iid)
        for v in range(self.vnodes):
            bisect.insort(self._points, (_hash(f"{iid}#{v}"), iid))

    def remove(self, iid: str) -> None:
        if iid not in self._instances:
            raise KeyError(f"instance {iid!r} not on the ring")
        self._instances.discard(iid)
        self._points = [p for p in self._points if p[1] != iid]

    def owners(self, key: str, r: int | None = None) -> list[str]:
        """The first ``r`` (default: replication factor) DISTINCT instances
        clockwise from the key's ring point, primary first."""
        if not self._points:
            raise RuntimeError("hash ring is empty")
        r = self.replication if r is None else r
        r = min(r, len(self._instances))
        start = bisect.bisect_left(self._points, (_hash(key), ""))
        out: list[str] = []
        for i in range(len(self._points)):
            iid = self._points[(start + i) % len(self._points)][1]
            if iid not in out:
                out.append(iid)
                if len(out) == r:
                    break
        return out

    def owner(self, key: str) -> str:
        return self.owners(key, 1)[0]


class PayloadRoute:
    """Query-index -> ring-key mapping for one chunked payload."""

    def __init__(
        self,
        name: str,
        shape: tuple[int, ...],
        chunks: list[container.ChunkEntry],
        tile_entries: int | None = None,
        versions: list[container.VersionEntry] | None = None,
    ):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.n_entries = int(np.prod(self.shape))
        self.tile_entries = int(tile_entries) if tile_entries else None
        self.n_chunks = len(chunks)
        self.versions = list(versions) if versions is not None else None
        if not chunks:
            raise ValueError(f"payload {name!r} has no chunks to route")
        if self.versions is not None:
            # one chunk-start table per version: entry ranges restart at 0
            # for every version's chunk run, so queries route to ABSOLUTE
            # chunk ids via the version's own table
            self._chunk_starts = None
            self._version_starts = [
                self._starts_for(chunks[v.chunk_start : v.chunk_stop])
                for v in self.versions
            ]
        else:
            self._chunk_starts = self._starts_for(chunks)

    def _starts_for(self, chunks: list[container.ChunkEntry]) -> np.ndarray:
        """Entry-start table for one contiguous chunk run, validated to
        partition [0, n_entries); uniform split for legacy files."""
        if all(c.entry_start is not None for c in chunks):
            starts = [c.entry_start for c in chunks]
            stops = [c.entry_stop for c in chunks]
            if starts != sorted(starts) or starts[0] != 0 or any(
                a != b for a, b in zip(starts[1:], stops[:-1])
            ) or stops[-1] != self.n_entries:
                raise ValueError(
                    f"payload {self.name!r}: recorded entry ranges do not "
                    f"partition [0, {self.n_entries})"
                )
            return np.asarray(starts, dtype=np.int64)
        # legacy file without recorded ranges: uniform partition
        return (
            np.arange(len(chunks), dtype=np.int64)
            * self.n_entries
            // len(chunks)
        )

    @property
    def n_tiles(self) -> int:
        if not self.tile_entries:
            return 0
        return -(-self.n_entries // self.tile_entries)

    @property
    def tiled(self) -> bool:
        return self.tile_entries is not None

    @property
    def versioned(self) -> bool:
        return self.versions is not None

    @property
    def n_versions(self) -> int:
        return len(self.versions) if self.versions is not None else 0

    # -- index space ---------------------------------------------------------
    def flat(self, indices: np.ndarray) -> np.ndarray:
        return multi_to_flat(indices, self.shape)

    def chunk_of(self, flat: np.ndarray, version: int | None = None) -> np.ndarray:
        """ABSOLUTE chunk id whose entry range covers each flat index —
        for versioned payloads, within ``version``'s chunk run (default:
        latest), so every version's queries key distinct ring points."""
        if self.versions is not None:
            v = len(self.versions) - 1 if version is None else int(version)
            ve = self.versions[v]
            return ve.chunk_start + (
                np.searchsorted(self._version_starts[v], flat, side="right") - 1
            )
        return np.searchsorted(self._chunk_starts, flat, side="right") - 1

    def tile_of(self, flat: np.ndarray) -> np.ndarray:
        return flat // self.tile_entries

    def group_of(self, flat: np.ndarray, version: int | None = None) -> np.ndarray:
        """The ownership-group id per flat index: tile when tiled (fine-
        grained sharding, deliberately VERSION-INDEPENDENT so all versions
        of a tile share one owner and base tiles are reused), else the
        version's covering chunk."""
        return self.tile_of(flat) if self.tiled else self.chunk_of(flat, version)

    # -- ring keys -----------------------------------------------------------
    def chunk_key(self, cid: int) -> str:
        return f"{self.name}/c{int(cid)}"

    def tile_key(self, tid: int) -> str:
        return f"{self.name}/t{int(tid)}"

    def group_key(self, gid: int) -> str:
        return self.tile_key(gid) if self.tiled else self.chunk_key(gid)

    # -- ownership -----------------------------------------------------------
    def owner_maps(
        self, ring: HashRing
    ) -> tuple[dict[int, list[str]], dict[int, list[str]]]:
        """Enumerate the ring ONCE for this payload: chunk id -> replica
        list and tile id -> replica list (primary first; tiles empty when
        untiled).  One pass costs n_chunks + n_tiles ring lookups total —
        the single source every ownership view derives from."""
        chunk_owners = {
            c: ring.owners(self.chunk_key(c)) for c in range(self.n_chunks)
        }
        tile_owners = (
            {t: ring.owners(self.tile_key(t)) for t in range(self.n_tiles)}
            if self.tiled
            else {}
        )
        return chunk_owners, tile_owners

    def ownership_tables(
        self,
        ring: HashRing,
        maps: tuple[dict[int, list[str]], dict[int, list[str]]] | None = None,
    ) -> tuple[dict[str, frozenset[int]], dict[str, frozenset[int]]]:
        """Invert :meth:`owner_maps`: instance id -> owned chunk ids, and
        instance id -> owned tile ids.  Pass ``maps`` to reuse an
        enumeration already paid for; the resulting sets make every later
        ownership decision (decode-tile caching, drop_unowned, rebalance
        diffs) a set lookup instead of a fresh hash + ring scan."""
        chunk_owners, tile_owners = (
            self.owner_maps(ring) if maps is None else maps
        )
        chunks: dict[str, set[int]] = {iid: set() for iid in ring.instances}
        tiles: dict[str, set[int]] = {iid: set() for iid in ring.instances}
        for c, own in chunk_owners.items():
            for iid in own:
                chunks[iid].add(c)
        for t, own in tile_owners.items():
            for iid in own:
                tiles[iid].add(t)
        return (
            {iid: frozenset(s) for iid, s in chunks.items()},
            {iid: frozenset(s) for iid, s in tiles.items()},
        )
