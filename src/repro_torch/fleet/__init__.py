"""Multi-pod serving of chunked codec payloads, on the card.

The paper's serving story — any entry reconstructible in logarithmic
time — makes compressed payloads directly servable, but one
``CodecService`` is bounded by one machine's RAM and one process's
decode throughput.  ``repro_torch.fleet`` runs N instances as a single
logical service:

    from repro_torch.fleet import FleetFrontend, rebalance, collect

    fleet = FleetFrontend(4, cache_bytes=1 << 24, replication=1)  # on CUDA
    fleet.load_stream("embed", "embed.tcdc", tile_entries=4096)
    fleet.decode_at("embed", idx)       # bit-identical to one instance

    rebalance(fleet, remove=["i3"])     # drain -> move chunks -> evict
    collect(fleet).as_dict()            # fleet-wide cache + latency roll-up

``controller`` closes the loop: a :class:`FleetController` polls
``collect()`` against declarative SLOs (``repro_torch.obs.slo``) and calls
``rebalance`` itself — sustained p99 breach admits a standby, sustained
idle retires one, with hysteresis + cooldown so it cannot flap.

Every instance mmaps the same container-v3 file; a consistent-hash ring
(``router``) over the file's chunk index entries decides which instances
own a payload — only owners materialize its body — and, when
``tile_entries`` is set, which instance caches which decode tiles, so
resident cache bytes shard across the fleet (with a configurable
replication factor for hot chunks).  The frontend splits each query
batch by owner, fans out through
the per-instance ``submit``/``flush`` coalescing path under an in-flight
byte budget (backpressure, not unbounded queues), and reassembles
results in request order.  ``rebalance`` changes ring membership behind
a drain barrier so zero in-flight tickets are lost, with a warm tile
handoff so scale-up does not start from a cold cache.

Members are location-transparent (``transport``): ``LocalTransport``
wraps an in-process ``CodecService``; ``SocketTransport`` speaks a
length-prefixed binary protocol to a ``repro_torch.fleet.worker`` OS process,
so the same fleet spans processes —

    fleet = FleetFrontend(
        ["w0", "w1"], device="cuda",
        transport_factory=lambda iid: SocketTransport.spawn(iid, device="cuda"),
    )

— with identical (bit-exact) answers; a dead worker becomes a routed
``excluded`` instance instead of a hang.

This is the port of ``repro.fleet``: the same names, the same ring, the
same wire protocol (a port frontend drives a ``repro.fleet.worker`` and a
reference frontend a ``repro_torch.fleet.worker``).  The fleet, its
in-process members, its workers (``--device``) and the repair refit run
on a ``device``, CUDA unless given.
"""
from repro_torch.fleet.controller import (
    ControllerConfig,
    Decision,
    FleetController,
    ScalingPolicy,
)
from repro_torch.fleet.frontend import FleetFrontend
from repro_torch.fleet.metrics import CacheCounters, FleetMetrics, InstanceMetrics, collect
from repro_torch.fleet.rebalance import RebalanceReport, rebalance
from repro_torch.fleet.repair import (
    RepairConfig,
    RepairController,
    RepairReport,
    RepairTicket,
)
from repro_torch.fleet.router import HashRing, PayloadRoute
from repro_torch.fleet.transport import (
    LocalTransport,
    RemoteError,
    SocketTransport,
    Transport,
    TransportError,
)

__all__ = [
    "CacheCounters",
    "ControllerConfig",
    "Decision",
    "FleetController",
    "FleetFrontend",
    "FleetMetrics",
    "HashRing",
    "InstanceMetrics",
    "LocalTransport",
    "PayloadRoute",
    "RebalanceReport",
    "RemoteError",
    "RepairConfig",
    "RepairController",
    "RepairReport",
    "RepairTicket",
    "ScalingPolicy",
    "SocketTransport",
    "Transport",
    "TransportError",
    "collect",
    "rebalance",
]
