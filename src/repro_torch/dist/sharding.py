"""Logical-axis sharding, as in ``repro.dist.sharding``: ParamSpec trees,
rules tables, late mesh binding, and materialization.

Weights are declared once as ``ParamSpec(shape, logical_axes, init)``
trees; activations are constrained with ``shard(x, *axes)``.  Nothing in
the model code names a mesh axis: the rules tables bind logical axes to
mesh axes when a program is placed, so the same definition runs whole on
one device or spread over a mesh.

Resolution semantics (``logical_pspec``), the reference's four rules:
  * rules map a logical axis to a mesh axis name, a tuple of names, or
    ``None`` (replicate); axes missing from the table replicate too;
  * mesh axes not present in the target mesh are dropped (e.g. 'pod' on a
    single-pod mesh);
  * a mesh axis consumed by an earlier dim of the same tensor is skipped
    (a spec must not repeat a mesh axis);
  * when the tensor shape is known, a dim that the mapped axis product
    does not divide evenly falls back to replication, all or nothing.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim, each
``None``, a mesh axis name or a tuple of names, as JAX's.  A mesh is
anything with ``axis_names`` and a ``shape`` (``MeshShape``, for meshes
larger than the process group, as the dry-run's) or a
``torch.distributed.device_mesh.DeviceMesh``.  ``placements`` turns a
spec into DTensor placements, one per mesh dim (JAX lists them per tensor
dim): a dim on several mesh axes is ``Shard(d)`` on each, which DTensor
splits major to minor in the mesh's order, so a tuple in another order
raises.

``shard`` is an identity outside a ``sharding_ctx``; inside one it
redistributes a ``DTensor`` to the resolved placements.  A context on a
``DeviceMesh`` also treats the plain tensors that code inside it makes
(positions, masks, the optimizer's scalars) as replicated, DTensor's
``implicit_replication``: the models run unchanged on ``DTensor`` params.

``device_put`` is JAX's ``device_put(tree, shardings)``: a tree of tensors
and a matching tree of ``NamedSharding`` become ``DTensor``s on their
mesh and placements.

``materialize`` turns a spec tree into tensors on one device, each leaf
drawn from its own ``torch.Generator`` seeded from ``(seed,
crc32(path))``, so adding a leaf never reshuffles the others.  The draws
cannot equal JAX's; the shapes, dtypes and standard deviations do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import threading
import zlib
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative leaf: shape + logical axis names + init kind.

    init: 'fan_in' (scaled normal), 'embed', 'ones', 'zeros'.
    dtype: overrides the tree-level default (KV caches).
    """

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "fan_in"
    dtype: Any = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"ParamSpec rank mismatch: shape {self.shape} vs axes {self.axes}"
            )


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """Apply ``fn(path, leaf)`` over a nested dict; ``path`` is JAX's
    ``keystr`` of the leaf (``"['blocks']['attn']['wq']"``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    return fn(path, tree)


def leaves(tree) -> list:
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def keyed_leaves(tree, path: str = "") -> dict[str, Any]:
    """``{keystr: leaf}`` of a tree of dicts and NamedTuples, JAX's
    ``keystr`` paths (``".mu['blocks']['attn']['wq']"``)."""
    if isinstance(tree, dict):
        items = [(f"{path}[{k!r}]", v) for k, v in tree.items()]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f"{path}.{f}", getattr(tree, f)) for f in tree._fields]
    else:
        return {path: tree}
    return {k: leaf for p, v in items for k, leaf in keyed_leaves(v, p).items()}


# ---------------------------------------------------------------------------
# rules tables (logical axis -> mesh axis | tuple of mesh axes | None)
# ---------------------------------------------------------------------------
# Megatron-style tensor parallelism on 'model', data parallelism on
# ('pod', 'data').  Weights stay unsharded on their input dims (pure TP);
# FSDP_RULES below adds the ZeRO-3 weight sharding over the DP axes.
BASE_RULES: dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,          # -> 'model' (Megatron SP) via effective_rules
    "seq_attn": None,     # -> 'model' for context-parallel attention cells
    "act_embed": None,
    # embedding / unembedding
    "vocab": "model",
    "embed": None,
    # stacked-layer and generic weight dims
    "layers": None,
    "ffn_in": None,
    "mlp": "model",
    # attention
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    # KV cache; kv_seq flips to 'data'/'model' per-cell (flash-decode)
    "kv_seq": None,
    "long_kv": "data",
    # MoE: dispatch groups ride the DP axes (keeps the sort/scatter local),
    # expert weights are TP-sharded on their hidden dim like dense MLPs
    "moe_group": ("pod", "data"),
    "experts": None,
    "expert_in": None,
    "expert_mlp": "model",
    "capacity": None,
    # Mamba / SSD
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_head_dim": None,
    "ssm_state": None,
    "conv_k": None,
}

# ZeRO-3/FSDP: additionally shard every weight's input dim over the DP
# axes.  Experts move to 'model' (expert parallelism); 'expert_mlp' then
# loses 'model' via the first-dim-wins fallback, so expert weights gather
# only over 'data' on their d_model dim.
FSDP_RULES: dict[str, Any] = dict(
    BASE_RULES,
    ffn_in=("pod", "data"),
    embed=("pod", "data"),
    experts="model",
    expert_in=("pod", "data"),
)


# ---------------------------------------------------------------------------
# meshes and specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its axis names and sizes alone, with no process group
    behind it: JAX's ``AbstractMesh``, for meshes larger than the world
    (the production meshes of the dry-run)."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"MeshShape: sizes {self.sizes} vs axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def dp_axes(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes, ``pod`` then ``data`` (major to
    minor), as the reference's ``(None, ('pod', 'data'))`` batch specs."""
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's major-to-minor order, of a
    ``MeshShape`` or a ``DeviceMesh`` (whose ``shape`` is a tuple)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names split major to minor.  A one-name tuple is the name, as in JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _rule_axes(logical: str | None, rules: dict) -> tuple[str, ...]:
    if logical is None:
        return ()
    r = rules.get(logical)
    if r is None:
        return ()
    if isinstance(r, str):
        return (r,)
    return tuple(r)


def logical_pspec(axes: tuple[str | None, ...], rules: dict, mesh,
                  shape: tuple[int, ...] | None = None) -> PartitionSpec:
    """Resolve logical axis names to a ``PartitionSpec`` on ``mesh``.

    With ``shape`` given, dims the mapped mesh-axis product does not
    divide evenly are replicated instead (all-or-nothing per dim).
    """
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    parts: list[Any] = []
    for i, logical in enumerate(axes):
        cand = [m for m in _rule_axes(logical, rules) if m in sizes and m not in used]
        if cand and shape is not None and shape[i] % math.prod(sizes[m] for m in cand):
            cand = []
        used.update(cand)
        parts.append(None if not cand else cand[0] if len(cand) == 1 else tuple(cand))
    return PartitionSpec(*parts)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_counts(spec: PartitionSpec, mesh) -> list[int]:
    """The number of pieces each tensor dim is split into."""
    sizes = mesh_axes(mesh)
    return [math.prod(sizes[a] for a in _entry_axes(e)) for e in spec]


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the spec puts that mesh axis on tensor dim ``d``,
    else ``Replicate()``.  A tensor dim on several mesh axes must name
    them in the mesh's order (DTensor splits major to minor); any other
    order raises."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_axes(mesh))
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = _entry_axes(entry)
        unknown = [a for a in names if a not in order]
        if unknown:
            raise ValueError(f"placements: {spec} names {unknown}, not axes of {order}")
        if [order.index(a) for a in names] != sorted(order.index(a) for a in names):
            raise ValueError(
                f"placements: dim {d} of {spec} is split over {names}, an order the mesh "
                f"{tuple(order)} cannot express (DTensor splits in mesh order)")
        for a in names:
            if a in dim_of:
                raise ValueError(f"placements: {spec} uses mesh axis {a!r} twice")
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in order)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh, as JAX's ``NamedSharding``."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The shape of one device's piece; raises where a dim does not divide."""
        counts = shard_counts(self.spec, self.mesh) + [1] * (len(shape) - len(self.spec))
        if len(self.spec) > len(shape) or any(n % c for n, c in zip(shape, counts)):
            raise ValueError(f"{self.spec} does not divide shape {tuple(shape)}")
        return tuple(n // c for n, c in zip(shape, counts))


# ---------------------------------------------------------------------------
# sharding context + activation constraints
# ---------------------------------------------------------------------------
_CTX = threading.local()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: dict):
    """Bind (mesh, rules) for the ``shard`` constraints run inside; on a
    ``DeviceMesh``, plain tensors meeting ``DTensor``s count as replicated.
    Nested inside another, it leaves DTensor's implicit replication on as
    it found it (torch's context turns it off when it exits)."""
    prev = getattr(_CTX, "val", None)
    _CTX.val = (mesh, dict(rules))
    try:
        with contextlib.ExitStack() as stack:
            if hasattr(mesh, "mesh_dim_names"):
                from torch.distributed.tensor import DTensor
                from torch.distributed.tensor.experimental import implicit_replication

                if not DTensor._op_dispatcher._allow_implicit_replication:
                    stack.enter_context(implicit_replication())
            yield
    finally:
        _CTX.val = prev


def current_ctx() -> tuple[Any, dict] | None:
    return getattr(_CTX, "val", None)


def is_dtensor(x) -> bool:
    """True for a ``DTensor``.  None exists before DTensor's module is
    imported, so the one-device path (every model layer asks) neither
    imports it nor pays more than a dict lookup."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(x, dtensor.DTensor)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` redistributed whole onto every rank of its mesh (still
    a ``DTensor``); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


class Shards:
    """Per-shard work on ``DTensor``s whose mesh dims split only dims that
    the work keeps apart (the batch of per-sequence work, or the heads of
    attention), written on plain tensors: DTensor's own rules for such
    work (gathers, scatters, padding, einsums over several split dims)
    differ between torch releases and fail on some.

    ``split`` is, per mesh dim of ``mesh``, the tensor dim it splits or
    None.  ``local(t, dims)`` is this rank's shard of ``t``: ``dims`` maps
    a dim of ``split`` to ``t``'s dim (identity where absent), or to None
    where ``t`` lacks it, and every other mesh dim is replicated.  A ``t``
    whole along a split mesh dim (a weight) gets a gradient summed over it,
    each rank having seen only its shard of the work.  ``mesh_tensor``
    wraps a shard back, ``weight`` is a whole ``t`` (all dims mapped to
    None).  All three are differentiable.

    Work that reduces over a split dim (a softmax over a split vocabulary
    or kv sequence) combines the shards itself: ``start`` is where this
    rank's shard begins along a split dim, and ``all_reduce`` reduces a
    plain tensor in place over the mesh dims that split one (``c10d``
    all-reduces, which every backend takes, CUDA tensors on gloo too)."""

    def __init__(self, mesh, split: tuple[int | None, ...]):
        self.mesh, self.split = mesh, tuple(split)

    def _placements(self, dims: dict | None, grad: bool = False) -> list:
        from torch.distributed.tensor import Partial, Replicate, Shard

        out = []
        for d in self.split:
            td = None if d is None else (dims or {}).get(d, d)
            out.append(Shard(td) if td is not None
                       else Partial() if d is not None and grad else Replicate())
        return out

    def local(self, t: torch.Tensor, dims: dict | None = None) -> torch.Tensor:
        return t.redistribute(self.mesh, self._placements(dims)).to_local(
            grad_placements=self._placements(dims, grad=True))

    def mesh_tensor(self, t: torch.Tensor, dims: dict | None = None) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t.contiguous(), self.mesh, self._placements(dims),
                                  run_check=False)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """``w`` whole on every rank, as a plain tensor: gathered over every
        mesh dim, for work that reads it on plain shards (the embedding
        lookup, Mamba's conv, the MoE router).  Its gradient stays the
        ``Partial`` sum over the mesh dims that split the work (laid out as
        ``w`` on the others) for the leaf's layout step (``layout_grad``)
        to reduce once with the leaf's other contributions (a tied
        embedding table's lookup and unembedding)."""
        dims = {d: None for d in self.split if d is not None}
        whole = _GatherGradPartial.apply(w, self._placements(dims))
        return whole.to_local(grad_placements=self._placements(dims, grad=True))

    def mesh_dims(self, d: int) -> list[int]:
        """The mesh dims (of more than one rank) that split tensor dim
        ``d``, major to minor."""
        return [i for i, s in enumerate(self.split) if s == d and self.mesh.size(i) > 1]

    def start(self, d: int, size: int) -> int:
        """The global index at which this rank's shard of tensor dim ``d``
        (of ``size`` in all) begins: DTensor splits a dim on several mesh
        dims major to minor, into even pieces."""
        coord = self.mesh.get_coordinate()
        index, count = 0, 1
        for i in self.mesh_dims(d):
            n = self.mesh.size(i)
            index, count = index * n + coord[i], count * n
        return index * (size // count)

    def all_reduce(self, t: torch.Tensor, op, d: int) -> torch.Tensor:
        """``t`` (plain) reduced in place by ``op`` (a ``ReduceOp``) over
        every mesh dim that splits tensor dim ``d``; not differentiable."""
        import torch.distributed as dist

        for i in self.mesh_dims(d):
            dist.all_reduce(t, op=op, group=self.mesh.get_group(i))
        return t


def batch_shards(x: torch.Tensor) -> Shards | None:
    """The ``Shards`` of ``x``'s batch (dim 0) split, or None for a plain
    tensor."""
    if not is_dtensor(x):
        return None
    return Shards(x.device_mesh, tuple(0 if p.is_shard(0) else None for p in x.placements))


def on_batch_shards(fn, x: torch.Tensor, *weights: torch.Tensor) -> torch.Tensor:
    """``fn(x, *weights)``, per-sequence work whose output keeps ``x``'s
    batch dim, on each rank's batch shard of a ``DTensor`` ``x`` (a plain
    ``x``: ``fn`` itself)."""
    shards = batch_shards(x)
    if shards is None:
        return fn(x, *weights)
    return shards.mesh_tensor(fn(shards.local(x), *(shards.weight(w) for w in weights)))


class _GatherGradPartial(torch.autograd.Function):
    """``w`` redistributed to ``placements`` (``gather_dp``, ``matmul``,
    ``Shards.weight``): gathered where a weight is read whole.  Its
    gradient comes back in ``w``'s placements where it is not a
    ``Partial`` sum, and stays one where it is: the sum over the shards of
    the work is left to the leaf's layout node (``layout_grad``), which
    reduces it once, in the master's dtype, where a redistribute's
    backward would reduce it here, in ``w``'s."""

    @staticmethod
    def forward(ctx, w, placements):
        ctx.mesh, ctx.placements = w.device_mesh, w.placements
        return w.redistribute(w.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        keep = [gp if gp.is_partial() else wp
                for gp, wp in zip(g.placements, ctx.placements)]
        return g.redistribute(ctx.mesh, keep), None


def gather_dp(w: torch.Tensor) -> torch.Tensor:
    """``w`` gathered over the mesh's data-parallel axes (``pod``,
    ``data``), its split over the others kept: what an FSDP step does
    before each product of a weight that the rules (``FSDP_RULES``) shard
    over those axes.  The gather moves ``w`` in its own dtype, so a weight
    cast to the compute dtype first moves bf16, as the reference's GSPMD
    does.  Its gradient stays a ``Partial`` sum over the DP axes (each
    rank saw its batch shard), left to the leaf's layout node
    (``layout_grad``) to reduce once, in f32 for f32 masters.  A plain
    tensor, or one that no DP axis splits, is returned as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    dp = dp_axes(w.device_mesh)
    whole = [Replicate() if a in dp and p.is_shard() else p
             for a, p in zip(mesh_axes(w.device_mesh), w.placements)]
    if whole == list(w.placements):
        return w
    return _GatherGradPartial.apply(w, whole)


class _ForwardLayoutGrad(torch.autograd.Function):
    """Identity on a ``DTensor`` whose gradient is laid out as the tensor
    was in the forward pass (replicated where the tensor was a partial
    sum), one mesh dim at a time, major to minor: a ``Partial`` sum over
    ``pod`` and ``data`` of a dim split over both is reduce-scattered over
    ``pod``, then its shard over ``data``, where DTensor's own plan
    all-reduces it whole over ``data`` first."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate

        ctx.mesh = y.device_mesh
        ctx.placements = [Replicate() if p.is_partial() else p for p in y.placements]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        placements = list(g.placements)
        for i, p in enumerate(ctx.placements):
            if placements[i] != p:
                placements[i] = p
                g = g.redistribute(ctx.mesh, placements)
        return g


def layout_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, whose gradient is laid out as ``t`` is: the ``Partial``
    sum autograd makes over the mesh dims that split the batch is reduced
    there, once, reduce-scattered onto a dim that splits ``t`` and
    all-reduced elsewhere.  A plain tensor, or one that needs no gradient,
    is returned as it is."""
    if not is_dtensor(t) or not t.requires_grad:
        return t
    return _ForwardLayoutGrad.apply(t)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations x [..., d] and a weight w [d, k], or
    batched over leading dims that both share: x [E, n, d] and w [E, d, k]
    (the experts' products).

    On ``DTensor``s the product runs on each rank's plain shards, in a
    layout chosen here, mesh dim by mesh dim, not by DTensor's cost model
    (which differs between torch releases: on torch 2.11 it split the
    activations of an FSDP product on the contracted dim and reduced the
    partial products).  The weight is first gathered over the DP axes
    (``gather_dp``), as FSDP does.  Then, on each mesh dim:

    * x splits a batch dim of the product: w is split on it alike;
    * x splits another leading dim (the batch over the DP axes, the
      sequence under Megatron SP): w is whole there, gathered if split;
      its gradient is a ``Partial`` sum;
    * x splits d: w's d is split alike, the output a ``Partial`` sum;
    * x is whole: w keeps a split of its k columns (the output split on
      them, x's gradient a ``Partial`` sum) and is gathered otherwise.

    A ``Partial`` x is reduced first.  w's gradient is left a ``Partial``
    sum where it is one, for the leaf's layout node (``layout_grad``) to
    reduce once; the output's gradient comes back in the output's layout,
    not in one a later constraint left on it."""
    if not is_dtensor(x) or not is_dtensor(w):
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    w = gather_dp(w)
    batch, last, cols = w.dim() - 2, x.dim() - 1, w.dim() - 1
    layout = []  # per mesh dim: x's, w's, the output's, x's and w's gradients'
    for px, pw in zip(x.placements, w.placements):
        px = Replicate() if px.is_partial() else px
        if px.is_shard() and px.dim < batch:        # a batch dim of the product
            pw, po, pdx, pdw = Shard(px.dim), px, px, Shard(px.dim)
        elif px.is_shard() and px.dim < last:       # another leading dim of x
            pw, po, pdx, pdw = Replicate(), px, px, Partial()
        elif px.is_shard():                          # the contracted dim
            pw, po, pdx, pdw = Shard(batch), Partial(), px, Shard(batch)
        elif pw.is_shard(cols):                      # x whole, w's columns split
            po, pdx, pdw = Shard(last), Partial(), pw
        else:
            pw = po = pdx = pdw = Replicate()
        layout.append((px, pw, po, pdx, pdw))
    xs, ws, out, dx, dw = (list(p) for p in zip(*layout))
    if xs != list(x.placements):
        x = x.redistribute(x.device_mesh, xs)
    if ws != list(w.placements):
        w = _GatherGradPartial.apply(w, ws)
    y = x.to_local(grad_placements=dx) @ w.to_local(grad_placements=dw)
    return _ForwardLayoutGrad.apply(DTensor.from_local(y, x.device_mesh, out, run_check=False))


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Lay ``x`` out on its logical axes under the active ``sharding_ctx``.

    Identity when no context is active (one device).  Inside one, ``x``
    must be a ``DTensor`` on the context's ``DeviceMesh``: it is
    redistributed to the resolved placements; a plain tensor raises.
    """
    if x.dim() != len(axes):
        # validated on the identity path too, so one-device tests catch a
        # bad annotation before it first runs under a mesh
        raise ValueError(f"shard: rank {x.dim()} tensor with axes {axes}")
    ctx = current_ctx()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    mesh, rules = ctx
    if not isinstance(x, DTensor):
        raise TypeError("shard: inside a sharding_ctx the tensor must be a DTensor")
    spec = logical_pspec(axes, rules, mesh, shape=tuple(x.shape))
    return x.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# spec-tree operations
# ---------------------------------------------------------------------------
def distribute(t: torch.Tensor, target: NamedSharding) -> torch.Tensor:
    """``t``, the same whole tensor on every rank, as a ``DTensor`` on
    ``target``'s mesh and placements: each rank keeps its own chunk, with
    no communication.  A ``DTensor`` is redistributed instead."""
    from torch.distributed.tensor import distribute_tensor

    mesh = target.mesh
    if is_dtensor(t):
        return t.redistribute(mesh, target.placements)
    return distribute_tensor(t.to(mesh.device_type), mesh, target.placements,
                             src_data_rank=None)


def device_put(tree, shardings):
    """JAX's ``device_put(tree, shardings)``: every leaf of a tree of dicts
    and NamedTuples laid out by the ``NamedSharding`` at its place in
    ``shardings`` (same structure), or by ``shardings`` itself where it is
    one ``NamedSharding``.  Each rank must hold the same whole leaves, as
    ``materialize`` from one seed gives them."""
    one = isinstance(shardings, NamedSharding)
    if isinstance(tree, dict):
        return {k: device_put(v, shardings if one else shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(device_put(getattr(tree, f), shardings if one
                                       else getattr(shardings, f)) for f in tree._fields))
    return distribute(tree, shardings)


def tree_shardings(mesh, specs, rules: dict):
    """ParamSpec tree -> ``NamedSharding`` tree (divisibility-checked)."""
    return map_with_path(
        lambda _, s: NamedSharding(mesh, logical_pspec(s.axes, rules, mesh, s.shape)), specs)


def tree_abstract(specs, dtype: torch.dtype):
    """ParamSpec tree -> tree of meta tensors (shape and dtype, no storage)."""
    return map_with_path(
        lambda _, s: torch.empty(s.shape, dtype=s.dtype or dtype, device="meta"), specs
    )


def _stacked_fan_in(spec: ParamSpec) -> int:
    # fan-in = every non-output dim that is not a stacked-layer or a
    # vmapped expert dim; the last dim is the output by convention.
    # q/k/v projections fuse two output dims (heads, head_dim): a heads
    # dim right before a final head_dim is output, not fan-in — while in
    # wo-style (heads, head_dim, d) weights the heads dim IS fan-in.
    fan = 1
    n = len(spec.axes)
    for i, (dim, ax) in enumerate(zip(spec.shape[:-1], spec.axes[:-1])):
        if ax in ("layers", "experts"):
            continue
        if ax in ("heads", "kv_heads") and i == n - 2 and spec.axes[-1] == "head_dim":
            continue
        fan *= dim
    return fan


def init_std(spec: ParamSpec) -> float | None:
    """Standard deviation of a random leaf; None for 'zeros'/'ones'."""
    if spec.init in ("zeros", "ones"):
        return None
    if spec.init == "embed":
        # unit-variance logits under tied unembedding (x is rmsnormed)
        return spec.shape[-1] ** -0.5
    if spec.init == "fan_in":
        return _stacked_fan_in(spec) ** -0.5
    raise ValueError(f"unknown init kind: {spec.init!r}")


def _init_leaf(gen: torch.Generator | None, spec: ParamSpec, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    std = init_std(spec)
    # drawn in f32 and cast once, as the reference does
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def _leaf_seed(seed: int, path: str) -> int:
    """The generator seed of the leaf at ``path``."""
    return ((seed & 0xFFFFFFFF) << 32) | zlib.crc32(path.encode())


def materialize(seed: int, specs, dtype: torch.dtype, device: torch.device,
                shardings=None):
    """ParamSpec tree -> real weights on ``device``, each leaf built in its
    final dtype there (no host copy of the tree).  Given ``shardings`` (a
    ``NamedSharding`` tree of the same structure), each leaf is laid out on
    its mesh as soon as it is drawn (``distribute``): every rank draws the
    same whole leaf from the seed and keeps its own chunk, one leaf at a
    time."""
    device = torch.device(device)
    targets = None if shardings is None else keyed_leaves(shardings)

    def init_at(path: str, spec: ParamSpec):
        gen = None
        if spec.init not in ("zeros", "ones"):
            gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
        leaf = _init_leaf(gen, spec, spec.dtype or dtype, device)
        return leaf if targets is None else distribute(leaf, targets[path])

    return map_with_path(init_at, specs)
