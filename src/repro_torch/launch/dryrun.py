"""Multi-pod dry-run, as in ``repro.launch.dryrun``: every (arch x shape x
mesh) cell's sharding trees, and one step's per-device cost with its
roofline on the production meshes, with no devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-1.3b \
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        [--rules auto|base|fsdp] [--out DIR [--skip-done]]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --check --all --mesh both

**The rule check** (``check_cell``, ``--check``) repeats the reference's
``build_cell`` up to its lowering (serving cells hold bf16 weights;
``rules="auto"`` resolves by model size; a batch the DP axes cannot fill
makes the cache long-context) and returns the resolved spec of every
param, optimizer, batch and cache leaf by its ``keystr`` path, with each
tree's bytes per device: the leaves' shapes divided by their shard counts.

**The cost pass** (``run_cell``, the default) runs one step of the cell as
the launcher runs it, ``train.step``'s ``make_train_step``,
``make_prefill_step`` or ``make_decode_step`` under ``sharding_ctx``, on
``DTensor`` arguments laid out by the rule check's trees over a
``DeviceMesh`` of the production mesh's 256 or 512 ranks.  The process
group is torch's fake backend (this process is rank 0, and every
collective returns at once) and every local tensor is a ``FakeTensor``
(shapes, no storage), so a full-width cell needs neither devices nor
memory.  ``CostCounter`` sees the operations rank 0 runs on its shards,
below DTensor's dispatch, and counts for that one rank:

* FLOPs, by the formulas of ``torch.utils.flop_counter`` on the local
  shapes (matrix products, convolutions, attention);
* bytes: each executed operation's input and output bytes, views,
  allocations and collectives excluded.  This is eager, unfused traffic, an upper bound
  on what a fused program moves; it is not XLA's "bytes accessed" and is
  never compared with the reference's figure;
* collectives, by kind, each the bytes of its result times the
  reference's ring factor (all-reduce x 2): DTensor's functional
  collectives and plain ``c10d`` calls alike;
* peak live bytes: the arguments' local bytes plus every storage the step
  allocates, less each one when it is freed.

The cost pass runs the plain versions of the kernels (a fake tensor
launches nothing) and traces the cell at full depth: the port loops over
blocks in Python, so nothing is counted once for many layers as XLA
counts a scanned body.  The roofline's constants are the H100's
(``launch.mesh``), not a card's timing.  ``seconds_lower`` is the set-up
(the fake world, mesh and arguments), ``seconds_compile`` is 0 (nothing
is compiled) and ``seconds_cost_passes`` is the traced step.

The CLI prints one JSON line per cell; with ``--out DIR`` it also writes
``cell_path``'s file there (default ``RESULTS_DIR``, under ``build/``).
A cell that raises is reported as ``status: error`` and the run exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import sys
import time
import traceback
import weakref
from collections import Counter

import torch
import torch.utils._python_dispatch
import torch.utils._pytree

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model
from repro_torch.optim import optimizers
from repro_torch.train import step as step_lib

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")

# bytes multiplier per collective kind (ring algorithms, per-device traffic)
_COLL_FACTOR = {
    "all-reduce": 2.0,        # reduce-scatter + all-gather phases
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: collective operators by name prefix; namespaces below
_COLL_KIND = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
              ("all_gather", "all-gather"), ("allgather", "all-gather"),
              ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
              ("alltoall", "all-to-all"), ("broadcast", "broadcast"),
              ("send", "collective-permute"), ("recv", "collective-permute"))
#: functional collectives return their result; ``c10d`` ops write their
#: first argument
_FUNCTIONAL = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")

# queries of a tensor's metadata: no operation runs (as FlopCounterMode)
_METADATA = {getattr(torch.ops.aten, n).default for n in (
    "size", "sym_size", "stride", "sym_stride", "storage_offset", "sym_storage_offset",
    "numel", "sym_numel", "dim", "is_contiguous", "sym_is_contiguous",
    "is_strides_like_format", "is_non_overlapping_and_dense")} | {
    torch.ops.aten.is_contiguous.memory_format, torch.ops.prim.layout.default}
# operators that move no data: allocations, and the wait on a collective
_NO_TRAFFIC = ("aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
               "aten.new_empty_strided", "_c10d_functional.wait_tensor",
               "c10d_functional.wait_tensor")


def _collective_kind(packet) -> str | None:
    ns, _, name = str(packet).partition(".")
    if ns not in _FUNCTIONAL and ns != "c10d":
        return None
    name = name.lstrip("_")
    return next((kind for prefix, kind in _COLL_KIND if name.startswith(prefix)), None)


@functools.cache
def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _in_sharding_propagation() -> bool:
    """True inside DTensor's sharding propagation (a frame of its module)."""
    from torch.distributed.tensor import _sharding_prop

    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename == _sharding_prop.__file__:
            return True
        f = f.f_back
    return False


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class CostCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """One rank's cost of the operations run under it: ``flops``,
    ``bytes``, ``collectives`` (``(kind, dtype, bytes)`` of each, bytes
    before the ring factor), ``op_counts`` of the collective operators,
    and ``peak`` live bytes (``track`` registers the arguments first).

    An operation on ``DTensor``s is not counted: DTensor runs it as
    operations on each rank's local tensors, which come back through this
    mode and are counted on their local shapes.  Nor is one that DTensor's
    sharding propagation runs to learn an output's global shape and
    stride (on fake or meta tensors of the global shapes, from its module
    ``_sharding_prop``).  The FLOP formulas and the decomposition of operators
    they lack are ``FlopCounterMode``'s, so on one device the count is
    that mode's.

    ``under``, a source file: ``peak_under`` is then the most live bytes at
    once of the storages made with a frame of that file on the stack (what
    one module holds, e.g. ``kernels/ref.py``'s attention oracle)."""

    def __init__(self, under: str | None = None):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self._formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, str, int]] = []
        self.op_counts: Counter = Counter()
        self.live = self.peak = 0
        self._storages: dict[int, weakref.ref] = {}
        self._under, self._made_under = under, set()
        self.live_under = self.peak_under = 0

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live."""
        made = {}
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key not in self._storages:
                self._storages[key] = weakref.ref(
                    st, functools.partial(self._free, key, st.nbytes()))
                self.live += st.nbytes()
                made[key] = st.nbytes()
        self.peak = max(self.peak, self.live)
        if made and self._under is not None and _on_stack(self._under):
            self._made_under.update(made)
            self.live_under += sum(made.values())
            self.peak_under = max(self.peak_under, self.live_under)

    def _free(self, key: int, n: int, _ref) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= n
            if key in self._made_under:
                self._made_under.discard(key)
                self.live_under -= n

    def storages(self, tree) -> set:
        return {id(t.untyped_storage()) for t in _tensors(tree)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if func in _METADATA or any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _tensors((args, kwargs))
        if _in_sharding_propagation() or any(t.device.type == "meta" for t in ins):
            return func(*args, **kwargs)
        if func not in self._formulas and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += self._formulas[packet](*args, **kwargs, out_val=out)
        kind = _collective_kind(packet)
        if kind is not None:
            self.op_counts[str(packet)] += 1
            result = out if str(packet).split(".")[0] in _FUNCTIONAL else args[0]
            for t in _tensors(result):
                self.collectives.append((kind, str(t.dtype), t.numel() * t.element_size()))
        elif not _is_view(func) and str(packet) not in _NO_TRAFFIC:
            self.bytes += _nbytes(ins) + _nbytes(out)
        self.track(out)
        return out


def _on_stack(filename: str) -> bool:
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename != filename:
        f = f.f_back
    return f is not None


def collective_bytes_per_device(collectives, by_dtype: bool = False) -> dict[str, float]:
    """Bytes per device of each collective kind, the ring factor applied,
    from a ``CostCounter``'s ``collectives`` (the reference parses them
    from the optimized HLO; the port has none).

    ``by_dtype=True`` adds 'kind:dtype' keys (diagnosis: are the FSDP
    gathers moving bf16 or f32?)."""
    out: dict[str, float] = {k: 0.0 for k in _COLL_FACTOR}
    for kind, dtype, nbytes in collectives:
        moved = nbytes * _COLL_FACTOR.get(kind, 1.0)
        out[kind] = out.get(kind, 0.0) + moved
        if by_dtype:
            key = f"{kind}:{dtype.replace('torch.', '')}"
            out[key] = out.get(key, 0.0) + moved
    out["total"] = sum(v for k, v in out.items() if ":" not in k)
    return out


def cost_dict(counter: CostCounter) -> dict:
    """The counterpart of a compiled program's ``cost_analysis()``: the
    counted FLOPs and bytes of one rank."""
    return {"flops": float(counter.flops), "bytes accessed": float(counter.bytes)}


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs (6ND train, 2ND inference) on ACTIVE params."""
    n_active = model.param_count(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def auto_rules(cfg, shape) -> str:
    """Weights + optimizer must fit 16GB/chip alongside activations: big
    models shard weights over the DP axes too (FSDP rules)."""
    n = model.param_count(cfg)
    if shape.kind == "train":
        return "fsdp" if n >= 10e9 else "base"
    return "fsdp" if n * 2 / 16 >= 12e9 else "base"  # bf16 over 16-way TP


def should_skip(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "full-attention arch: long_500k requires sub-quadratic decode (DESIGN.md §6)"
    return None


def tree_bytes_per_device(shardings: dict, abstract: dict) -> int:
    """Bytes one device holds of a tree: each leaf's shard shape (``keyed``
    like ``shardings``) times its element size."""
    return sum(math.prod(shardings[k].shard_shape(tuple(leaf.shape))) * leaf.element_size()
               for k, leaf in abstract.items())


def _cell_config(arch: str, shape: ShapeConfig, rules_name: str, mesh, cfg=None,
                 remat: str | None = None, seq_shard: bool | None = None,
                 depth_blocks: int | None = None):
    """(cfg, rules name, effective rules) of a cell, as the reference's
    ``build_cell`` makes them."""
    cfg = cfg or configs.get(arch)
    if shape.kind != "train":
        # serving runs bf16 weights (no optimizer master copies)
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if depth_blocks is not None:
        cfg = dataclasses.replace(cfg, n_layers=cfg.block_size * depth_blocks,
                                  scan_layers=False)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if rules_name == "auto":
        rules_name = auto_rules(cfg, shape)
    base = sharding.BASE_RULES if rules_name == "base" else sharding.FSDP_RULES
    rules = step_lib.effective_rules(mesh, shape, base, cfg)
    if seq_shard is not None:
        rules["seq"] = "model" if seq_shard else None
    return cfg, rules_name, rules


def check_cell(arch: str, shape_name: str, mesh_name: str, rules_name: str = "base") -> dict:
    """The resolved sharding trees of one cell on the production mesh
    ``mesh_name`` ("single" or "multi")."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    result: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "rules": rules_name}
    skip = should_skip(cfg, shape)
    if skip:
        return dict(result, status="skip", reason=skip)
    mesh = mesh_lib.make_production_mesh(multi_pod=mesh_name == "multi")
    cfg, rules_name, rules = _cell_config(arch, shape, rules_name, mesh)
    specs, nbytes = {}, {}
    for name, (shardings, abstract) in _cell_trees(cfg, shape, mesh, rules).items():
        shardings = sharding.keyed_leaves(shardings)
        abstract = sharding.keyed_leaves(abstract)
        if shardings.keys() != abstract.keys():
            raise ValueError(f"{arch}/{shape_name}: the {name} shardings and leaves differ")
        specs[name] = {k: s.spec for k, s in shardings.items()}
        nbytes[name] = tree_bytes_per_device(shardings, abstract)
    return dict(result, rules=rules_name, status="ok", n_devices=mesh.size,
                long_ctx=rules.get("batch") is None, effective_rules=rules, specs=specs,
                bytes_per_device=nbytes)


def _cell_trees(cfg, shape: ShapeConfig, mesh, rules: dict) -> dict:
    """{name: (sharding tree, abstract tree)} of a cell's step arguments,
    in the step's argument order."""
    batch_spec = step_lib.input_specs(cfg, shape)
    long_ctx = rules.get("batch") is None
    trees = {"params": (step_lib.param_shardings(mesh, cfg, rules), model.abstract_params(cfg))}
    if shape.kind == "train":
        trees["opt"] = (step_lib.opt_shardings(mesh, cfg, rules),
                        step_lib.abstract_opt_state(cfg))
    else:
        trees["cache"] = (
            step_lib.cache_shardings(mesh, cfg, shape.global_batch, shape.seq_len, long_ctx,
                                     rules),
            model.abstract_cache(cfg, shape.global_batch, shape.seq_len, long_ctx))
    trees["batch"] = (step_lib.batch_shardings(mesh, cfg, batch_spec, rules), batch_spec)
    return trees


# ---------------------------------------------------------------------------
# the cost pass
# ---------------------------------------------------------------------------
def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake process group of ``size`` ranks
    (torch's ``fake`` backend: collectives return at once, nothing is
    sent).  A fake group of another size is replaced; a real one raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs its own fake process group; this process "
                               f"is in a {dist.get_backend()!r} group")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def fake_mesh(mesh_name: str):
    """The production mesh ("single" 16 x 16, "multi" 2 x 16 x 16) as a
    ``DeviceMesh`` over a fake process group of its size."""
    shape = mesh_lib.make_production_mesh(multi_pod=mesh_name == "multi")
    fake_world(shape.size)
    sizes = shape.shape
    return mesh_lib.make_debug_mesh(sizes["data"], sizes["model"], sizes.get("pod", 0),
                                    device="cpu")


def fake_tree(shardings, abstract, mesh, fake_mode):
    """``DTensor`` leaves of ``abstract``'s global shapes laid out by
    ``shardings``, each rank's local piece a ``FakeTensor``."""
    from torch.distributed.tensor import DTensor

    def leaf(s, a):
        with fake_mode:
            local = torch.empty(s.shard_shape(tuple(a.shape)), dtype=a.dtype)
        return DTensor.from_local(local, mesh, s.placements, run_check=False,
                                  shape=a.shape, stride=a.stride())

    if isinstance(abstract, dict):
        return {k: fake_tree(shardings[k], v, mesh, fake_mode) for k, v in abstract.items()}
    if isinstance(abstract, tuple) and hasattr(abstract, "_fields"):
        return type(abstract)(*(fake_tree(getattr(shardings, f), getattr(abstract, f), mesh,
                                           fake_mode) for f in abstract._fields))
    return leaf(shardings, abstract)


def build_cell(arch: str, shape_name: str | ShapeConfig, mesh, rules_name: str = "base",
               remat: str | None = None, seq_shard: bool | None = None,
               depth_blocks: int | None = None, cfg=None, fake_mode=None):
    """One cell's step and arguments on ``mesh`` (a ``DeviceMesh`` over a
    fake process group).  Returns ``(step, args, cfg, shape, rules)``:
    ``step(*args)`` is the launcher's step, run inside
    ``sharding_ctx(mesh, rules)`` and ``fake_mode``; ``args`` are
    ``DTensor``s whose local pieces are ``FakeTensor``s of ``fake_mode``.

    ``cfg`` replaces ``configs.get(arch)`` (a depth-cut config);
    ``shape_name`` may be a ``ShapeConfig``; ``depth_blocks`` cuts the
    model to that many blocks, as the reference's."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    cfg, _, rules = _cell_config(arch, shape, rules_name, mesh, cfg, remat, seq_shard,
                                 depth_blocks)
    args = [fake_tree(s, a, mesh, fake_mode)
            for s, a in _cell_trees(cfg, shape, mesh, rules).values()]
    if shape.kind == "train":
        opt = optimizers.adamw(1e-4, weight_decay=0.1, max_grad_norm=1.0)
        fn = step_lib.make_train_step(cfg, opt)
    elif shape.kind == "prefill":
        fn = step_lib.make_prefill_step(cfg)
    else:  # decode the last position: the whole cache is read
        fn = functools.partial(step_lib.make_decode_step(cfg), cache_len=shape.seq_len - 1)
    return fn, args, cfg, shape, rules


def measure(fn, args, mesh, rules: dict | None, fake_mode,
            counter: CostCounter | None = None) -> dict:
    """Run ``fn(*args)`` once under ``counter`` (a new ``CostCounter``
    unless given; inside ``sharding_ctx(mesh, rules)`` unless ``rules`` is
    None); returns it and the memory of the step (the reference's
    ``memory_analysis`` fields, ``code_bytes`` 0)."""
    counter = CostCounter() if counter is None else counter
    local = [_local_tree(a) for a in args]
    counter.track(local)
    arg_storages = counter.storages(local)
    arg_bytes = counter.live
    ctx = sharding.sharding_ctx(mesh, rules) if rules is not None else contextlib.nullcontext()
    with fake_mode, counter, ctx:
        out = fn(*args)
    out_local = _local_tree(out)
    out_storages = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                    for t in _tensors(out_local)}
    out_bytes = sum(out_storages.values())
    alias = sum(n for k, n in out_storages.items() if k in arg_storages)
    peak = counter.peak
    return {"counter": counter, "memory": {
        "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        "temp_bytes": peak - arg_bytes - out_bytes + alias, "alias_bytes": alias,
        "code_bytes": 0, "peak_per_device": peak}}


def _local_tree(tree):
    """Every ``DTensor`` of a tree of dicts, tuples and lists as its local
    piece (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_local_tree(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_local_tree(v) for v in tree)
    return tree.to_local() if sharding.is_dtensor(tree) else tree


def roofline(flops: float, nbytes: float, coll: dict, mf: float, n_dev: int,
             argument_bytes: float) -> dict:
    """The three terms over the H100 constants of ``launch.mesh``, and the
    ideal step: useful FLOPs at peak, or every argument byte read once."""
    terms = {"compute_s": flops / mesh_lib.PEAK_FLOPS_BF16,
             "memory_s": nbytes / mesh_lib.HBM_BW,
             "collective_s": coll["total"] / mesh_lib.LINK_BW}
    bound_s = max(terms.values())
    ideal_compute_s = (mf / n_dev) / mesh_lib.PEAK_FLOPS_BF16
    ideal_memory_s = argument_bytes / mesh_lib.HBM_BW
    ideal_s = max(ideal_compute_s, ideal_memory_s)
    return dict(terms, dominant=max(terms, key=terms.get), bound_s=bound_s,
                ideal_compute_s=ideal_compute_s, ideal_memory_s=ideal_memory_s,
                ideal_s=ideal_s, roofline_fraction=ideal_s / bound_s if bound_s > 0 else 0.0)


def cost_cell(arch: str, shape, mesh, rules_name: str = "base", remat: str | None = None,
              seq_shard: bool | None = None, cfg=None,
              counter: CostCounter | None = None) -> dict:
    """The cost pass of one cell on ``mesh`` (a ``DeviceMesh`` over the
    fake group), under ``counter`` if given: ``run_cell``'s keys from
    ``status`` on."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    fn, args, cfg, shape, rules = build_cell(arch, shape, mesh, rules_name, remat, seq_shard,
                                             cfg=cfg, fake_mode=fake_mode)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = measure(fn, args, mesh, rules, fake_mode, counter)
    t_cost = time.perf_counter() - t0
    counter, mem = m["counter"], m["memory"]
    cost = cost_dict(counter)
    flops_dev, bytes_dev = cost["flops"], cost["bytes accessed"]
    coll = collective_bytes_per_device(counter.collectives)
    n_dev = mesh.size()
    mf = model_flops(cfg, shape)
    return dict(
        status="ok", n_devices=n_dev, n_blocks=cfg.n_blocks,
        seconds_lower=round(t_lower, 2), seconds_compile=0.0,
        seconds_cost_passes=round(t_cost, 2), remat=remat or cfg.remat, seq_shard=seq_shard,
        memory=mem, flops_per_device=flops_dev, hlo_bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll,
        collective_ops=dict(counter.op_counts), model_flops=mf,
        hlo_flops_total=flops_dev * n_dev,
        useful_flops_ratio=mf / max(flops_dev * n_dev, 1.0),
        roofline=roofline(flops_dev, bytes_dev, coll, mf, n_dev, mem["argument_bytes"]))


def run_cell(arch: str, shape_name: str, mesh_name: str, rules_name: str = "base",
             verbose: bool = True, remat: str | None = None,
             seq_shard: bool | None = None) -> dict:
    """One cell's cost pass on the production mesh ``mesh_name``, in a fake
    process group of its size that this process joins as rank 0."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    result: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "rules": rules_name}
    skip = should_skip(cfg, shape)
    if skip:
        return dict(result, status="skip", reason=skip)
    t0 = time.perf_counter()
    mesh = fake_mesh(mesh_name)
    t_world = time.perf_counter() - t0
    result.update(cost_cell(arch, shape, mesh, rules_name, remat, seq_shard))
    result["seconds_lower"] = round(result["seconds_lower"] + t_world, 2)
    if verbose:
        r, coll, mem = result["roofline"], result["collective_bytes_per_device"], \
            result["memory"]
        print(f"[{arch} x {shape_name} x {mesh_name} x {rules_name}]")
        print(f"  set-up {result['seconds_lower']:.1f}s "
              f"cost-pass {result['seconds_cost_passes']:.1f}s")
        print(f"  memory: args={mem['argument_bytes']:.4g} peak={mem['peak_per_device']:.4g}")
        print(f"  cost: flops/dev={result['flops_per_device']:.3e} "
              f"bytes/dev={result['hlo_bytes_per_device']:.3e}")
        print("  collectives/dev: " + " ".join(f"{k}={v:.3e}" for k, v in coll.items() if v))
        print(f"  roofline: compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s dominant={r['dominant']} "
              f"fraction={r['roofline_fraction']:.3f}")
    return result


def cell_path(arch, shape, mesh, rules, root: str | None = None):
    """A cell's JSON file under ``root`` (``RESULTS_DIR`` unless given)."""
    root = root or RESULTS_DIR
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, f"{arch}__{shape}__{mesh}__{rules}.json")


def cells(mesh: str = "both", arch: str | None = None, shape: str | None = None) -> list:
    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    archs = [arch] if arch else configs.ARCH_IDS
    shapes = [shape] if shape else list(SHAPES)
    return [(a, s, m) for a in archs for s in shapes for m in meshes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="auto", choices=["auto", "base", "fsdp"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--remat", default=None, choices=[None, "none", "dots", "full"])
    ap.add_argument("--seq-shard", default=None, type=int, choices=[0, 1])
    ap.add_argument("--out", default=None, help="also write each cell's JSON file here")
    ap.add_argument("--check", action="store_true",
                    help="the rule check alone: specs and bytes per device, no cost pass")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    failures = 0
    for arch, shape, mesh_name in cells(args.mesh, None if args.all else args.arch,
                                        None if args.all else args.shape):
        if args.check:
            res = check_cell(arch, shape, mesh_name, args.rules)
            if res["status"] == "ok":
                res["leaves"] = {k: len(v) for k, v in res.pop("specs").items()}
            print(json.dumps(res), flush=True)
            continue
        path = cell_path(arch, shape, mesh_name, args.rules, args.out) if args.out else None
        if path and args.skip_done and os.path.exists(path):
            continue
        try:
            res = run_cell(arch, shape, mesh_name, args.rules, verbose=False,
                           remat=args.remat,
                           seq_shard=None if args.seq_shard is None else bool(args.seq_shard))
        except Exception as e:  # noqa: BLE001 - record the cell and go on with the sweep
            traceback.print_exc()
            res = {"arch": arch, "shape": shape, "mesh": mesh_name, "rules": args.rules,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        print(json.dumps(res), flush=True)
        if path:
            with open(path, "w") as f:
                json.dump(res, f, indent=2)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
