"""Warm scale-up / scale-down: change the ring without failing a ticket,
as in ``repro.fleet.rebalance``.  Tiles are host NumPy in the port's
service, so the warm handoff copies host arrays.

The sequence for any membership change:

1. ``drain()`` — barrier: every queued fleet ticket is resolved under the
   OLD ownership epoch, so no in-flight ticket can land on a departed
   instance or a not-yet-owning one.
2. Mutate the ring (add instances after ``spawn_instance`` so a joiner
   can serve the moment it owns anything; removals leave the ring first).
3. Ownership moves chunk-by-chunk: for every payload the per-instance
   filters are recomputed from the new ring and re-installed; the report
   records exactly which chunks and tiles changed hands.
4. Warm handoff (``warm=True``): decode tiles whose ownership moved are
   copied from the old owner's cache into the new owner's (through the
   byte-budgeted ``admit_tile`` path) before the old owner drops them —
   a scale-up starts with a warm cache instead of a miss storm.  Across
   processes the tiles ride the transport's array encoding, so a socket
   fleet warms exactly like an in-process one.
5. Evicted owners drop cache bytes under the existing LRU accounting
   (``drop_unowned``), and departed instances are retired (payloads
   unloaded, worker processes shut down).

Everything goes through the :class:`~repro_torch.fleet.transport.Transport`
protocol.  A member whose transport died (``fleet.excluded``) neither
contributes warm tiles nor receives any — removing it through
``rebalance(fleet, remove=[iid])`` is how a dead worker leaves the fleet
for real.
"""
from __future__ import annotations

import dataclasses

from repro_torch.fleet.frontend import FleetFrontend
from repro_torch.fleet.transport import TransportError


@dataclasses.dataclass
class RebalanceReport:
    added: list[str]
    removed: list[str]
    #: payload -> number of chunk ids whose owner set changed
    chunks_moved: dict[str, int]
    #: payload -> number of decode tiles whose owner set changed
    tiles_moved: dict[str, int]
    #: payload -> tiles warm-copied into a new owner's cache
    tiles_warmed: dict[str, int]
    #: bytes freed by evicted owners dropping unowned cache state
    bytes_dropped: int

    @property
    def total_moved(self) -> int:
        return sum(self.chunks_moved.values()) + sum(self.tiles_moved.values())


def _ownership_snapshot(
    fleet: FleetFrontend,
) -> dict[str, dict[str, tuple[frozenset, frozenset]]]:
    """payload -> instance -> (owned chunk ids, owned tile ids) — one
    ring enumeration per payload (``PayloadRoute.ownership_tables``)."""
    snap: dict[str, dict[str, tuple[frozenset, frozenset]]] = {}
    for name, route in fleet.routes.items():
        chunk_tbl, tile_tbl = route.ownership_tables(fleet.ring)
        snap[name] = {
            iid: (chunk_tbl[iid], tile_tbl[iid]) for iid in fleet.ring.instances
        }
    return snap


def rebalance(
    fleet: FleetFrontend,
    *,
    add: list[str] | tuple[str, ...] = (),
    remove: list[str] | tuple[str, ...] = (),
    warm: bool = True,
) -> RebalanceReport:
    """Apply a membership change; see the module docstring for semantics."""
    add, remove = list(add), list(remove)
    for iid in add:
        if iid in fleet.transports:
            raise ValueError(f"cannot add {iid!r}: already in the fleet")
    for iid in remove:
        if iid not in fleet.transports:
            raise KeyError(f"cannot remove {iid!r}: not in the fleet")
    if set(fleet.transports) - set(remove) | set(add) == set():
        raise ValueError("rebalance would leave an empty fleet")

    # 1. barrier — in-flight tickets resolve under the old epoch
    fleet.drain()
    before = _ownership_snapshot(fleet)

    # warm-handoff source: cached tiles of every current live instance
    # (the departing ones' caches are exactly what must not go cold)
    tile_cache: dict[str, dict[int, object]] = {}
    if warm:
        for name, route in fleet.routes.items():
            if not route.tiled:
                continue
            merged: dict[int, object] = {}
            for iid, t in fleet.transports.items():
                if iid in fleet.excluded:
                    continue  # a dead worker's cache is unreadable
                try:
                    merged.update(t.export_tiles(name))
                except TransportError as e:
                    fleet.exclude(iid, e)
            tile_cache[name] = merged

    # 2. ring mutation — spawn joiners first so they can serve immediately
    for iid in add:
        fleet.spawn_instance(iid)
        fleet.ring.add(iid)
    for iid in remove:
        fleet.ring.remove(iid)

    # 3. chunk-by-chunk ownership movement
    after = _ownership_snapshot(fleet)
    chunks_moved: dict[str, int] = {}
    tiles_moved: dict[str, int] = {}
    for name, route in fleet.routes.items():
        old_chunk_owner = _owner_map(before.get(name, {}), 0)
        new_chunk_owner = _owner_map(after.get(name, {}), 0)
        chunks_moved[name] = sum(
            1 for c in range(route.n_chunks)
            if old_chunk_owner.get(c) != new_chunk_owner.get(c)
        )
        if route.tiled:
            old_tile_owner = _owner_map(before.get(name, {}), 1)
            new_tile_owner = _owner_map(after.get(name, {}), 1)
            tiles_moved[name] = sum(
                1 for t in range(route.n_tiles)
                if old_tile_owner.get(t) != new_tile_owner.get(t)
            )
        fleet.apply_ownership(name)

    # 4. warm handoff into owners the tile GAINED (before old owners
    # drop) — stationary tiles are neither re-admitted (that would reset
    # their LRU recency) nor counted
    tiles_warmed: dict[str, int] = {}
    if warm:
        for name, cached in tile_cache.items():
            old_owner = _owner_map(before.get(name, {}), 1)
            new_owner = _owner_map(after.get(name, {}), 1)
            route = fleet.routes[name]
            n = 0
            for tid, values in cached.items():
                # versioned payloads export COMPOSITE tile ids
                # (version * n_tiles + tile); ownership rides on the base
                # tile, so all versions of a tile move together
                base = tid % route.n_tiles if route.versioned else tid
                gained = new_owner.get(base, frozenset()) - old_owner.get(
                    base, frozenset()
                )
                for iid in gained:
                    if iid in fleet.excluded:
                        continue
                    try:
                        if fleet.transports[iid].admit_tile(name, tid, values):
                            n += 1
                    except TransportError as e:
                        fleet.exclude(iid, e)
            tiles_warmed[name] = n

    # 5. evicted owners drop cache bytes; departed instances retire
    bytes_dropped = 0
    for name in fleet.routes:
        for iid in list(fleet.ring.instances):
            if iid in fleet.excluded:
                continue
            try:
                bytes_dropped += fleet.transports[iid].drop_unowned(name)
            except TransportError as e:
                fleet.exclude(iid, e)
    for iid in remove:
        fleet.retire_instance(iid)

    return RebalanceReport(
        added=add,
        removed=remove,
        chunks_moved=chunks_moved,
        tiles_moved=tiles_moved,
        tiles_warmed=tiles_warmed,
        bytes_dropped=bytes_dropped,
    )


def _owner_map(
    per_instance: dict[str, tuple[frozenset, frozenset]], slot: int
) -> dict[int, frozenset]:
    """id -> frozenset of owning instances, from an ownership snapshot."""
    owners: dict[int, set[str]] = {}
    for iid, sets in per_instance.items():
        for ident in sets[slot]:
            owners.setdefault(ident, set()).add(iid)
    return {k: frozenset(v) for k, v in owners.items()}
