"""The fleet query frontend: N fleet members behind one service, as in
``repro.fleet.frontend``.

Each member sits behind a :class:`~repro_torch.fleet.transport.Transport` —
in-process (``LocalTransport`` wrapping a ``CodecService``) or a
separate OS process (``SocketTransport`` to a ``repro_torch.fleet.worker``).
The frontend depends only on the protocol, so batch split/reassembly,
the in-flight byte budget, the drain barrier, and warm tile handoff
behave identically across both; every instance mmaps the same
container-v3 file and — via the
:class:`~repro_torch.serve.codec_service.Ownership` filter the router
installs — materializes and caches only its shard of chunks and decode
tiles.  A ``decode_at`` batch is split by owner, fanned out through each
instance's submit/flush coalescing path (pipelined frames on a socket
transport), and reassembled in request order, so a fleet answer is
bit-identical to a single resident instance's.

Admission control: ``max_inflight_bytes`` bounds the bytes (decoded
output + index payload) queued on any one instance during a flush.  When
a wave of sub-batches would exceed it, the instance is flushed NOW
(backpressure) instead of queueing without bound —
``backpressure_flushes`` counts how often that happened.

Replication: with ``replication=R`` each chunk/tile key has R owners on
the ring; the frontend sends each group to whichever replica has the
least bytes planned this flush, so hot chunks spread across their
replica set.

Failure containment: a dead transport (worker killed, request timeout,
framing violation) raises ``TransportError`` exactly once — the frontend
fails that flush's affected tickets cleanly, adds the instance to
``excluded``, and routes every later query to surviving replicas.  A
group whose replicas are ALL excluded fails its ticket with a clear
error instead of hanging.  ``rebalance`` removes excluded members for
real (ring change + retirement).

Read repair's serving half: a sub-batch that FAILS on one instance
(e.g. a quarantined corrupt chunk raising ``ChunkCorruptError`` on the
worker, or the transport dying mid-flush) is retried on the group's
surviving replicas before the ticket is failed — with ``replication=R>1``
a single corrupt replica costs zero failed tickets, and each failover is
recorded as a ``decode_failover`` event.  ``refresh(name)`` fans the
post-repair epoch switch (re-open the container file, clear quarantine)
to every live member.

On the card: the fleet has a ``device`` (CUDA unless given; without a
card and without ``device`` the constructor raises).  The default
transport factory builds each in-process member's ``CodecService`` there,
so every NTTD answer is a ``decode_tile`` launch on that device; answers
come back as float64 NumPy on the host, which is what admission budgets.

    fleet = FleetFrontend(4, cache_bytes=1 << 24, replication=1)
    fleet.load_stream("embed", "embed.tcdc", tile_entries=4096)
    fleet.decode_at("embed", idx)        # == single instance, bit-exact

    # one worker process per member instead:
    fleet = FleetFrontend(
        ["w0", "w1"],
        transport_factory=lambda iid: SocketTransport.spawn(iid, device="cuda"),
        device="cuda",
    )
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np

from repro_torch import obs
from repro_torch.codecs import container
from repro_torch.codecs.indexing import validate_indices
from repro_torch.devices import resolve_device
from repro_torch.fleet.router import HashRing, PayloadRoute
from repro_torch.fleet.transport import LocalTransport, Transport, TransportError
from repro_torch.serve.codec_service import CodecService, Ownership

#: fp64 output per decoded entry — the unit admission control budgets in
_OUT_BYTES_PER_ENTRY = 8


class FleetFrontend:
    def __init__(
        self,
        instances: int | list[str] | dict[str, CodecService | Transport] = 2,
        *,
        cache_bytes: int | None = None,
        max_batch: int = 65536,
        replication: int = 1,
        vnodes: int = 64,
        max_inflight_bytes: int | None = None,
        latency_window: int = 2048,
        transport_factory: Callable[[str], Transport] | None = None,
        prefetch: bool = False,
        canary_fraction: float = 0.0,
        canary_seed: int = 0,
        canary_min_fitness: float | None = None,
        device=None,
    ):
        #: where in-process members decode and repair refits train
        self.device = resolve_device(device)
        if isinstance(instances, int):
            if instances < 1:
                raise ValueError(f"need >= 1 instance, got {instances}")
            instances = [f"i{k}" for k in range(instances)]
        self._cache_bytes = cache_bytes
        self._max_batch = max_batch
        self.max_inflight_bytes = max_inflight_bytes
        self._latency_window = latency_window
        self._transport_factory = transport_factory or (
            lambda iid: LocalTransport(
                iid, cache_bytes=cache_bytes, max_batch=max_batch,
                prefetch=prefetch, canary_fraction=canary_fraction,
                canary_seed=canary_seed,
                canary_min_fitness=canary_min_fitness, device=self.device,
            )
        )
        if isinstance(instances, dict):
            self.transports: dict[str, Transport] = {
                iid: (
                    LocalTransport(iid, service=t)
                    if isinstance(t, CodecService)
                    else t
                )
                for iid, t in instances.items()
            }
        else:
            self.transports = {
                iid: self._transport_factory(iid) for iid in instances
            }
        self.ring = HashRing(
            list(self.transports), vnodes=vnodes, replication=replication
        )
        self.routes: dict[str, PayloadRoute] = {}
        self._paths: dict[str, tuple[str, int | None]] = {}
        #: payload -> group id -> replica list, rebuilt by apply_ownership
        self._group_owners: dict[str, dict[int, list[str]]] = {}
        self._queue: list[tuple[int, str, np.ndarray, int | None]] = []
        self._next_ticket = 0
        #: results resolved by drain()/decode_at(), delivered by the next flush()
        self._drained: dict[int, np.ndarray] = {}
        #: failures resolved early (drain(), decode_at()), reported by the
        #: next flush() — the failure analogue of _drained
        self._pending_failed: dict[int, Exception] = {}
        #: fleet tickets whose decode failed during the LAST flush
        self.failed: dict[int, Exception] = {}
        self.backpressure_flushes = 0
        #: instances whose transport died — still fleet members (the ring
        #: keeps them until a rebalance removes them) but excluded from
        #: routing, so queries go to surviving replicas instead of hanging
        self.excluded: set[str] = set()
        #: instance -> the TransportError that excluded it
        self.exclusion_errors: dict[str, TransportError] = {}
        #: CUMULATIVE exclusion count — never decremented (retiring a dead
        #: member clears ``excluded`` but not this), so metrics consumers
        #: can tell a fresh death from an old one
        self.exclusions_total = 0
        #: per-instance flush-latency histograms + peak-inflight gauges
        #: (all-time buckets AND an exact recent window, bounded memory)
        self.metrics = obs.MetricsRegistry()
        self._lat_hist: dict[str, obs.Histogram] = {}
        self._peak_gauge: dict[str, obs.Gauge] = {}
        for iid in self.transports:
            self._add_instance_instruments(iid)

    def _add_instance_instruments(self, iid: str) -> None:
        self._lat_hist[iid] = self.metrics.histogram(
            "flush_latency_seconds", window=self._latency_window, instance=iid
        )
        self._peak_gauge[iid] = self.metrics.gauge(
            "peak_inflight_bytes", instance=iid
        )

    def _remove_instance_instruments(self, iid: str) -> None:
        self._lat_hist.pop(iid, None)
        self._peak_gauge.pop(iid, None)
        self.metrics.remove("flush_latency_seconds", instance=iid)
        self.metrics.remove("peak_inflight_bytes", instance=iid)

    # ------------------------------------------------------------------ admin
    @property
    def services(self) -> dict[str, CodecService]:
        """In-process members' services (LocalTransport only) — a debug/
        test convenience; fleet logic goes through ``transports``."""
        return {
            iid: t.service
            for iid, t in self.transports.items()
            if isinstance(t, LocalTransport)
        }

    def instances(self) -> list[str]:
        return sorted(self.transports)

    def payloads(self) -> list[str]:
        return sorted(self.routes)

    def path_of(self, name: str) -> tuple[str, int | None]:
        """(container path, tile_entries) a payload was loaded with — what
        the rebalancer replays onto a joining instance."""
        return self._paths[name]

    def exclude(self, iid: str, err: TransportError) -> None:
        """Mark a member's transport dead: it stays on the ring (ownership
        is a rebalance concern) but routing skips it from now on."""
        if iid not in self.excluded:
            self.excluded.add(iid)
            self.exclusion_errors[iid] = err
            self.exclusions_total += 1

    def spawn_instance(self, iid: str) -> Transport:
        """Build a member with this fleet's transport factory and load
        every registered payload on it.  Ring membership and ownership are
        NOT touched — that is the rebalancer's job (drain barrier first)."""
        if iid in self.transports:
            raise ValueError(f"instance {iid!r} already exists")
        t = self._transport_factory(iid)
        try:
            for name, (path, tile_entries) in self._paths.items():
                t.load_stream(name, path, tile_entries=tile_entries)
        except Exception:
            # a failed replay must not leak the member (for a socket
            # transport that is a live worker OS process)
            try:
                t.close()
            except TransportError:
                pass
            raise
        self.transports[iid] = t
        self._add_instance_instruments(iid)
        return t

    def retire_instance(self, iid: str) -> Transport:
        """Detach a member from the fleet (payloads unloaded, worker shut
        down).  Ring membership must already have been updated and
        in-flight work drained — the rebalancer sequences this.  A dead
        transport retires without a hang: the shutdown is best-effort."""
        t = self.transports.pop(iid)
        self._remove_instance_instruments(iid)
        self.excluded.discard(iid)
        self.exclusion_errors.pop(iid, None)
        try:
            t.drain()
            for name in list(t.payloads()):
                t.unload(name)
        except TransportError:
            pass
        t.close()
        return t

    def close(self) -> None:
        """Shut down every member (terminates worker processes)."""
        for iid in list(self.transports):
            t = self.transports.pop(iid)
            try:
                t.close()
            except TransportError:
                pass

    def latency_seconds(self, iid: str) -> list[float]:
        """Wall seconds of this instance's most recent flushes (window-
        capped at ``latency_window``; see ``flush_count`` for the total)."""
        return self._lat_hist[iid].window_values()

    def latency_histogram(self, iid: str) -> obs.Histogram:
        """The full flush-latency instrument: all-time bucket counts plus
        the exact recent window ``latency_seconds`` reads."""
        return self._lat_hist[iid]

    def flush_count(self, iid: str) -> int:
        return self._lat_hist[iid].count

    def peak_inflight_bytes(self, iid: str) -> int:
        return int(self._peak_gauge[iid].value)

    # ------------------------------------------------------------------ load
    def load_stream(
        self, name: str, path: str, *, tile_entries: int | None = None
    ) -> PayloadRoute:
        """Register a container v3/v4 file fleet-wide: every instance
        mmaps it lazily; the chunk index (and, for v4 delta files, the
        version index) seeds the routing table; ownership filters shard
        materialization and tile caching across the ring."""
        codec_name, chunks, versions = container.container_index(path)
        live = [iid for iid in self.transports if iid not in self.excluded]
        if not live:
            raise TransportError(
                f"cannot load {name!r}: every fleet member is excluded "
                f"(dead instances: {sorted(self.excluded)})"
            )
        try:
            for iid in live:  # dead members get the payload at rebalance
                self.transports[iid].load_stream(
                    name, path, tile_entries=tile_entries
                )
            # the chunk-0 primary is an owner either way — peeking the shape
            # there materializes a body that instance would keep anyway;
            # fall back to any live member when the primary's transport died
            candidates = self.ring.owners(f"{name}/c0", len(self.transports))
            primary = next((i for i in candidates if i in live), live[0])
            shape = self.transports[primary].shape_of(name)
            route = PayloadRoute(name, shape, chunks, tile_entries, versions)
        except Exception:
            # nothing half-registered: a corrupt chunk discovered at the
            # shape peek must not leave N-1 instances serving garbage —
            # and a failed RE-load must not keep the replaced payload's
            # stale route/path either (the instances' registrations are
            # already gone)
            for t in self.transports.values():
                try:
                    t.unload(name)
                except TransportError:
                    pass
            self.routes.pop(name, None)
            self._paths.pop(name, None)
            raise
        self.routes[name] = route
        self._paths[name] = (path, tile_entries)
        self.apply_ownership(name)
        return route

    def unload(self, name: str) -> None:
        self.routes.pop(name, None)
        self._paths.pop(name, None)
        self._group_owners.pop(name, None)
        for iid, t in self.transports.items():
            try:
                t.unload(name)
            except TransportError as e:
                self.exclude(iid, e)

    def refresh(self, name: str) -> None:
        """Fan a payload refresh to every live member — the repair
        controller's epoch switch after it rewrote chunks or appended a
        patch: each instance re-opens the container file and drops its
        quarantine marks and cached decode state for the payload."""
        if name not in self.routes:
            raise KeyError(f"no payload {name!r}")
        for iid, t in self.transports.items():
            if iid in self.excluded:
                continue
            try:
                t.refresh(name)
            except TransportError as e:
                self.exclude(iid, e)

    def apply_ownership(self, name: str) -> None:
        """(Re-)install each instance's ownership filter for a payload
        from the CURRENT ring — called at load and after every rebalance.
        One ring enumeration serves all instances; a member not on the
        ring (a leaver awaiting retirement) owns nothing."""
        route = self.routes[name]
        maps = route.owner_maps(self.ring)
        chunk_tbl, tile_tbl = route.ownership_tables(self.ring, maps)
        for iid, t in self.transports.items():
            if iid in self.excluded:
                continue  # dead transport; rebalance retires it for real
            try:
                t.set_ownership(
                    name,
                    Ownership(
                        chunk_ids=chunk_tbl.get(iid, frozenset()),
                        tile_ids=(
                            tile_tbl.get(iid, frozenset()) if route.tiled else None
                        ),
                    ),
                )
            except TransportError as e:
                self.exclude(iid, e)
        # hot-path routing table: group id -> replica list (primary first),
        # so flush() pays a dict lookup per group, not a ring hash
        self._group_owners[name] = maps[1] if route.tiled else maps[0]

    # ---------------------------------------------------------------- queries
    def _validate(self, name: str, indices: np.ndarray) -> np.ndarray:
        """Same validation as CodecService (shared helper), so a malformed
        request is rejected before any fan-out."""
        route = self.routes.get(name)
        if route is None:
            raise KeyError(
                f"no payload {name!r}; loaded: {', '.join(self.payloads())}"
            )
        return validate_indices(name, route.shape, indices)

    def _resolve_version(self, name: str, version: int | None) -> int | None:
        """Pin a versioned payload's query to a concrete version id at
        submit time (None -> latest), mirroring CodecService."""
        route = self.routes[name]
        if not route.versioned:
            if version is not None:
                raise ValueError(
                    f"payload {name!r} is not versioned (version={version})"
                )
            return None
        v = route.n_versions - 1 if version is None else int(version)
        if not 0 <= v < route.n_versions:
            raise ValueError(
                f"{name}: version {v} out of range [0, {route.n_versions})"
            )
        return v

    def submit(
        self, name: str, indices: np.ndarray, version: int | None = None
    ) -> int:
        """Queue a request; resolved by the next flush().  Validates
        eagerly so a malformed request can never poison a batch."""
        with obs.span("fleet.submit", payload=name):
            idx = self._validate(name, indices)
            v = self._resolve_version(name, version)
            ticket = self._next_ticket
            self._next_ticket += 1
            self._queue.append((ticket, name, idx, v))
            return ticket

    def decode_at(
        self, name: str, indices: np.ndarray, version: int | None = None
    ) -> np.ndarray:
        """Direct query: split by owner, fan out, reassemble in order.
        Any other queued tickets are resolved too — their results are
        held for the next flush(), and their failures (if any) stay in
        ``self.failed`` until then, mirroring CodecService semantics."""
        with obs.span(
            "fleet.decode_at", payload=name, entries=int(np.size(indices))
        ):
            ticket = self.submit(name, indices, version=version)
            results = self.flush()
            value = results.pop(ticket, None)
            self._drained.update(results)  # don't lose concurrent tickets...
            err = self.failed.pop(ticket, None)
            # ...and defer their failures to the next flush — the one
            # report, not one now and one again later
            self._pending_failed.update(self.failed)
            self.failed = {}
        if err is not None:
            raise err
        return value

    def drain(self) -> None:
        """Barrier: resolve every queued ticket.  Results are merged into
        the next flush()'s return and failures accumulate, so a rebalance
        mid-query-stream loses nothing."""
        if not self._queue:
            return
        results = self.flush()
        self._drained.update(results)
        self._pending_failed.update(self.failed)

    # ----------------------------------------------------------------- flush
    def flush(self) -> dict[int, np.ndarray]:
        """Resolve all queued tickets: one owner-split plan, one
        coalesced submit/flush round per live instance (admission-
        controlled), then per-ticket reassembly in request order."""
        # failures resolved early (drain/decode_at) are reported exactly
        # once, by this flush — mirroring how _drained delivers results
        self.failed = self._pending_failed
        self._pending_failed = {}
        results = self._drained
        self._drained = {}
        queue, self._queue = self._queue, []
        # plan: per instance, (ticket, name, version, sub-indices, positions)
        plan: dict[
            str, list[tuple[int, str, int | None, np.ndarray, np.ndarray]]
        ] = {iid: [] for iid in self.transports}
        planned_bytes = dict.fromkeys(self.transports, 0)
        for ticket, name, idx, version in queue:
            route = self.routes.get(name)
            if route is None:  # unloaded between submit and flush
                self.failed[ticket] = KeyError(f"payload {name!r} unloaded")
                continue
            if not idx.shape[0]:  # empty request: answer locally
                results[ticket] = np.empty(0, dtype=np.float64)
                continue
            gids = route.group_of(route.flat(idx), version)
            uniq, inv = np.unique(gids, return_inverse=True)
            counts = np.bincount(inv, minlength=len(uniq))
            group_owners = self._group_owners[name]
            owner_by_gid = np.empty(len(uniq), dtype=object)
            unroutable: int | None = None
            for k, gid in enumerate(uniq):
                replicas = [
                    r for r in group_owners[int(gid)] if r not in self.excluded
                ]
                if not replicas:
                    unroutable = int(gid)
                    break
                # ties go to the first (primary) replica — min() keeps
                # the earliest element among equals
                owner_by_gid[k] = min(replicas, key=planned_bytes.__getitem__)
                planned_bytes[owner_by_gid[k]] += (
                    int(counts[k]) * _OUT_BYTES_PER_ENTRY
                )
            if unroutable is not None:
                self.failed[ticket] = TransportError(
                    f"payload {name!r} group {unroutable}: every replica is "
                    f"excluded (dead instances: {sorted(self.excluded)})"
                )
                continue
            owners = owner_by_gid[inv]
            for iid in np.unique(owners):
                pos = np.nonzero(owners == iid)[0]
                plan[iid].append((ticket, name, version, idx[pos], pos))
        # execute
        parts: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {}
        part_failed: dict[int, Exception] = {}
        #: sub-batches that failed on their planned instance, eligible for
        #: replica failover: (failed instance, plan item, error)
        retries: list[tuple[str, tuple, Exception]] = []
        with obs.span(
            "fleet.flush",
            tickets=len(queue),
            instances=sum(1 for items in plan.values() if items),
        ):
            for iid, items in plan.items():
                if items:
                    self._run_instance(iid, items, parts, part_failed, retries)
            if retries:
                self._retry_failed(retries, parts, part_failed)
        # reassemble in request order
        sizes = {ticket: idx.shape[0] for ticket, _, idx, _ in queue}
        for ticket, _, idx, _ in queue:
            if ticket in results or ticket in self.failed:
                continue  # empty request / failed before fan-out
            if ticket in part_failed:
                self.failed[ticket] = part_failed[ticket]
                continue
            got = parts.get(ticket, [])
            out = np.empty(sizes[ticket], dtype=got[0][1].dtype)
            for pos, values in got:
                out[pos] = values
            results[ticket] = out
        return results

    def _run_instance(
        self,
        iid: str,
        items: list[tuple[int, str, int | None, np.ndarray, np.ndarray]],
        parts: dict[int, list[tuple[np.ndarray, np.ndarray]]],
        part_failed: dict[int, Exception],
        retries: list[tuple[str, tuple, Exception]],
    ) -> None:
        """Submit this instance's sub-batches through its transport's
        coalescing path, flushing early whenever the in-flight byte budget
        would overflow.  A failed sub-batch — request-level error or the
        transport dying mid-batch — goes to ``retries`` for replica
        failover instead of failing its ticket outright; a transport death
        additionally excludes the instance from future routing."""
        t = self.transports[iid]
        #: (ticket, rid, pos, plan item) — the item rides along so a
        #: failure can be retried on a replica with full context
        pending: list[tuple[int, int, np.ndarray, tuple]] = []
        inflight = 0
        resolved: set[int] = set()  # tickets answered by an early flush
        try:
            for item in items:
                ticket, name, version, sub_idx, pos = item
                cost = sub_idx.shape[0] * _OUT_BYTES_PER_ENTRY + sub_idx.nbytes
                if (
                    self.max_inflight_bytes is not None
                    and pending
                    and inflight + cost > self.max_inflight_bytes
                ):
                    self.backpressure_flushes += 1
                    self._flush_instance(iid, t, pending, parts, retries)
                    resolved.update(p[0] for p in pending)
                    pending, inflight = [], 0
                rid = t.submit(name, sub_idx, version=version)
                pending.append((ticket, rid, pos, item))
                inflight += cost
                self._peak_gauge[iid].set_max(inflight)
            if pending:
                self._flush_instance(iid, t, pending, parts, retries)
        except TransportError as e:
            self.exclude(iid, e)
            for item in items:
                if item[0] not in resolved:
                    retries.append((iid, item, e))

    def _flush_instance(self, iid, transport, pending, parts, retries) -> None:
        # latency is measured with raw perf_counter reads, independent of
        # tracing, so the metrics are identical with tracing off or on
        with obs.span("transport.flush", instance=iid, requests=len(pending)):
            t0 = time.perf_counter()
            results, failures = transport.flush()
            self._lat_hist[iid].observe(time.perf_counter() - t0)
        for ticket, rid, pos, item in pending:
            if rid in results:
                parts.setdefault(ticket, []).append((pos, results[rid]))
            else:
                retries.append((iid, item, failures.get(
                    rid, RuntimeError(f"instance {iid}: ticket vanished")
                )))

    def _retry_failed(
        self,
        retries: list[tuple[str, tuple, Exception]],
        parts: dict[int, list[tuple[np.ndarray, np.ndarray]]],
        part_failed: dict[int, Exception],
    ) -> None:
        """Replica failover: re-route each failed sub-batch to its groups'
        surviving replicas (decode-through keeps any owning replica
        bit-identical).  Only when no healthy replica remains does the
        original error reach the ticket.  Each successful failover emits a
        ``decode_failover`` event naming source, target, and cause —
        the repair controller's corruption signal rides the same poll."""
        for failed_iid, item, err in retries:
            ticket = item[0]
            if ticket in part_failed:
                continue
            if not self._retry_on_replicas(failed_iid, item, err, parts):
                part_failed[ticket] = err

    def _retry_on_replicas(
        self,
        failed_iid: str,
        item: tuple[int, str, int | None, np.ndarray, np.ndarray],
        err: Exception,
        parts: dict[int, list[tuple[np.ndarray, np.ndarray]]],
    ) -> bool:
        ticket, name, version, sub_idx, pos = item
        route = self.routes.get(name)
        group_owners = self._group_owners.get(name)
        if route is None or group_owners is None:
            return False
        gids = route.group_of(route.flat(sub_idx), version)
        split: dict[str, list[np.ndarray]] = {}
        for gid in np.unique(gids):
            cand = [
                r for r in group_owners[int(gid)]
                if r != failed_iid and r not in self.excluded
            ]
            if not cand:
                return False  # no surviving replica for this group
            split.setdefault(cand[0], []).append(np.nonzero(gids == gid)[0])
        done: list[tuple[np.ndarray, np.ndarray]] = []
        for iid, sels in split.items():
            sel = np.concatenate(sels)
            t = self.transports[iid]
            try:
                rid = t.submit(name, sub_idx[sel], version=version)
                results, _failures = t.flush()
            except TransportError as e:
                self.exclude(iid, e)
                return False
            if rid not in results:
                return False
            done.append((pos[sel], results[rid]))
            obs.emit_event(
                "decode_failover",
                payload=name,
                from_instance=failed_iid,
                to_instance=iid,
                entries=int(len(sel)),
                ticket=ticket,
                error=str(err),
            )
        parts.setdefault(ticket, []).extend(done)
        return True
