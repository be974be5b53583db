"""GPipe-style pipeline parallelism over one mesh axis, as in
``repro.dist.pipeline_parallel``.

The stack's layers are split into S = the mesh's ``axis`` size contiguous
stages (``split_stages``); the rank at position i on ``axis`` owns stage
i's weights and the M microbatches stream through the stages
(``pipeline_forward``).  The schedule is GPipe's fill-drain: M + S - 1
ticks; at tick t stage 0 takes microbatch t, stage i holds microbatch
t - i, and the last stage finishes microbatch t - (S - 1).  The bubble
fraction is (S - 1) / (M + S - 1).

The reference runs every stage on every tick, on ring garbage during fill
and drain, because its loop body must be the same collective program on
every device.  Eager ranks need not: a stage applies ``fn`` only to a real
microbatch and sends only real activations, so the outputs are the same
and the bubble is idle time.  Each tick's sends and receives are posted
together with ``dist.batch_isend_irecv`` over the axis's process group, so
a ring of ranks cannot deadlock on blocking sends.  The output is
replicated over ``axis`` (a broadcast from the last stage: the
reference's ``psum`` of its buffer, whose other terms are zeros).

Transport follows the group's backend: NCCL sends device tensors as they
are; gloo sends CPU tensors, so under gloo an activation on the card is
copied to the host, sent, received on the host and copied back (the
stage's compute stays on its device).

``fn(stage_params, x) -> y`` must preserve the activation's shape and
dtype (true for residual stacks), as in the reference.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import is_dtensor
from repro_torch.optim.optimizers import tree_map


def split_stages(params, n_stages: int):
    """Split each leaf's leading (layer) dim into [n_stages, L/n_stages, ...]."""

    def split(a):
        if a.shape[0] % n_stages:
            raise ValueError(f"layer dim {a.shape[0]} not divisible by {n_stages} stages")
        return a.reshape((n_stages, a.shape[0] // n_stages) + tuple(a.shape[1:]))

    return tree_map(split, params)


def _local_stage(leaf: torch.Tensor, stage: int) -> torch.Tensor:
    """This rank's [L/S, ...] slice of a [S, ...] leaf: a ``DTensor``
    sharded on its stage dim holds it alone; a plain tensor holds every
    stage."""
    if is_dtensor(leaf):
        local = leaf.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage leaf of shape {tuple(leaf.shape)} is not sharded over "
                             f"its stages (local shape {tuple(local.shape)})")
        return local[0]
    return leaf[stage]


class _Hops:
    """Point-to-point hops to the next and from the previous stage."""

    def __init__(self, group, stage: int, n_stages: int, device: torch.device, stats):
        self.group = group
        self.next = dist.get_global_rank(group, (stage + 1) % n_stages)
        self.prev = dist.get_global_rank(group, (stage - 1) % n_stages)
        # gloo moves CPU tensors only: a device activation goes through the host
        self.staged = dist.get_backend(group) != "nccl" and device.type != "cpu"
        self.device = device
        self.stats = stats

    def _timed(self, fn):
        if self.stats is None:
            return fn()
        _sync(self.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        self.stats["staging_seconds"] += time.perf_counter() - t0
        return out

    def exchange(self, send: torch.Tensor | None, recv_like: torch.Tensor | None):
        """Send ``send`` to the next stage and receive a tensor like
        ``recv_like`` from the previous one (either may be None); returns
        the received tensor, on ``recv_like``'s device."""
        if send is not None and self.staged:
            send = self._timed(send.cpu)
        buf = None
        if recv_like is not None:
            buf = torch.empty_like(recv_like, device="cpu" if self.staged else recv_like.device)
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, self.next, self.group))
        if buf is not None:
            ops.append(dist.P2POp(dist.irecv, buf, self.prev, self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if buf is not None and self.staged:
            buf = self._timed(lambda: buf.to(self.device))
        return buf


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pipeline_forward(fn, stage_params, microbatches: torch.Tensor, mesh, axis: str = "pod",
                     stats: dict | None = None) -> torch.Tensor:
    """Run ``fn`` as an S-stage pipeline over the ``axis`` of ``mesh`` (a
    ``DeviceMesh``).

    stage_params: tree of [S, ...] leaves (see ``split_stages``), plain
    tensors on every rank or ``DTensor``s sharded on dim 0 over ``axis``;
    the rank at position i on ``axis`` applies stage i.  microbatches:
    [M, mb, ...], the same on every rank, on the rank's device.  Returns the
    [M, mb, ...] outputs of the final stage on every rank of ``axis``.

    ``stats``, a dict, gets the schedule (``ticks``, ``stages``,
    ``microbatches``, ``bubble_fraction``) and this rank's host-clock
    seconds: ``tick_seconds`` (one per tick), ``compute_seconds`` (in
    ``fn``) and ``staging_seconds`` (host copies of the hops); timing
    drains the device before and after each part.
    """
    names = list(mesh.mesh_dim_names)
    n_stages = mesh.shape[names.index(axis)]
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    m = microbatches.shape[0]
    n_ticks = m + n_stages - 1
    device = microbatches.device
    params = tree_map(lambda a: _local_stage(a, stage), stage_params)
    if stats is not None:
        stats.update(ticks=n_ticks, stages=n_stages, microbatches=m,
                     bubble_fraction=(n_stages - 1) / n_ticks, tick_seconds=[],
                     compute_seconds=0.0, staging_seconds=0.0)
    hops = None
    if n_stages > 1:
        hops = _Hops(group, stage, n_stages, device, stats)
        # NCCL wants every rank of a group in its first batched
        # point-to-point call; the first tick's has two ranks
        dist.barrier(group=group)

    def holds(i: int, t: int) -> bool:  # stage i has a real microbatch at tick t
        return 0 <= t - i < m

    out = torch.zeros_like(microbatches)
    state = None
    for t in range(n_ticks):
        t0 = time.perf_counter()
        y = None
        if holds(stage, t):
            x = microbatches[t] if stage == 0 else state
            if stats is not None:
                _sync(device)
                c0 = time.perf_counter()
            y = fn(params, x)
            if stats is not None:
                _sync(device)
                stats["compute_seconds"] += time.perf_counter() - c0
            if stage == n_stages - 1:
                out[t - (n_stages - 1)] = y
        if hops is not None:
            send = y if stage < n_stages - 1 else None
            recv = microbatches[0] if stage > 0 and holds(stage - 1, t) else None
            state = hops.exchange(send, recv)
        if stats is not None:
            _sync(device)
            stats["tick_seconds"].append(time.perf_counter() - t0)
    if n_stages > 1:
        dist.broadcast(out, dist.get_global_rank(group, n_stages - 1), group=group)
    return out
