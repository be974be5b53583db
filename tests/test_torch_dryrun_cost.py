"""The port's dry-run cost pass (``launch.dryrun.run_cell``,
``launch.dryrun_codec.run``), on the CPU.

Against the reference: the analytic ``model_flops`` of every arch and
shape, and the codec cell's argument bytes and ``model_flops``, exactly.
Against the plain step: a 1 x 1 fake world counts the FLOPs that
``FlopCounterMode`` counts over the plain step, a data-only 4 x 1 world the
plain step's at a quarter of the batch, and a 2 x 2 world's argument bytes
are the rule check's tree bytes.  Against a real world: four gloo ranks
run the step on a 2 x 2 mesh, and the collectives rank 0's
``CommDebugMode`` sees (kinds and counts; bytes from the same counter the
cost pass uses) equal what the fake pass predicts.  Every fake process
group lives in a subprocess of its own, so none leaks into another test.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models.layers import padded_vocab
from torch_ranks import run_ranks

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TIMEOUT = 300
DECODE_LENS = (32, 64)  # a decode step's cache lengths, L and 2L
LONG_SEQ, CHUNK = 2048, 512  # a step on the q-chunked oracle, and its chunk
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "rules", "status", "n_devices", "n_blocks", "seconds_lower",
    "seconds_compile", "seconds_cost_passes", "remat", "seq_shard", "memory",
    "flops_per_device", "hlo_bytes_per_device", "collective_bytes_per_device", "model_flops",
    "hlo_flops_total", "useful_flops_ratio", "roofline"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "bound_s",
                 "ideal_compute_s", "ideal_memory_s", "ideal_s", "roofline_fraction"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "code_bytes",
               "peak_per_device"}


def _import_reference(module: str):
    """The reference's dry-run modules set ``XLA_FLAGS`` (512 host devices)
    when imported; keep this process's setting."""
    import importlib

    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(module)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _python(code: str, timeout: float = TIMEOUT, **env) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2", **env}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def _json_lines(out: str) -> list[dict]:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_matches_reference(arch, shape):
    jdryrun = _import_reference("repro.launch.dryrun")
    assert dryrun.model_flops(configs.get(arch), SHAPES[shape]) == jdryrun.model_flops(
        jconfigs.get(arch), JSHAPES[shape])


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_codec_cell_matches_reference(mesh):
    """At the defaults (batch 2^20, 4 steps, rank 8, hidden 16): the
    argument bytes and ``model_flops`` are the reference's exactly; the
    port's step all-reduces its flat buffer of gradients and loss once a
    DP axis, so the all-reduce moves 2 x its bytes per axis."""
    ref = _python(f"""
        import json
        from repro.launch import dryrun_codec
        r = dryrun_codec.run({mesh!r}, "ref", 1 << 20, 4, 8, 16, verbose=False)
        print(json.dumps({{"argument_bytes": r["memory"]["argument_bytes"],
                          "model_flops": r["model_flops"]}}))
    """)
    assert ref.returncode == 0, ref.stderr[-3000:]
    port = _python(f"""
        import json
        from repro_torch.launch import dryrun_codec
        print(json.dumps(dryrun_codec.run({mesh!r}, "ref", 1 << 20, 4, 8, 16, verbose=False)))
    """)
    assert port.returncode == 0, port.stderr[-3000:]
    (want,), (got,) = _json_lines(ref.stdout), _json_lines(port.stdout)
    assert got["status"] == "ok" and got["memory"]["argument_bytes"] == want["argument_bytes"]
    assert got["model_flops"] == want["model_flops"]
    if mesh == "single":
        assert want["argument_bytes"] == 4_238_660
        assert want["model_flops"] == 185_220_464_640
    # 3,696 f32 gradients and the loss, all-reduced once a DP axis a step
    axes = 1 if mesh == "single" else 2
    assert got["collective_ops"] == {"c10d.allreduce_": axes}
    coll = got["collective_bytes_per_device"]
    assert coll["all-reduce"] == coll["total"] == axes * 2 * 4 * (3_696 + 1)
    assert {*MEMORY_KEYS} - {"code_bytes"} <= set(got["memory"]) and set(
        got["roofline"]) >= ROOFLINE_KEYS - {"ideal_compute_s", "ideal_memory_s"}


@pytest.fixture(scope="module")
def small_worlds():
    """minicpm-2b's smoke config, batch 8 x 32, on fake worlds of 1 x 1,
    4 x 1 and 2 x 2, and the plain step's ``FlopCounterMode`` count at
    batch 8 and 2; on the 2 x 2 world also the train step's largest
    storage made in its backward (the step under a ``CostCounter`` that
    notes the storages it tracks while autograd runs), and decode steps at
    batch 8 and 1 against caches of DECODE_LENS."""
    res = _python(f"""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch import configs
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.dist import sharding
        from repro_torch.kernels import ref
        from repro_torch.launch import dryrun, mesh as mesh_lib
        from repro_torch.models import model
        from repro_torch.optim import optimizers
        from repro_torch.train import step as step_lib

        LONG_SEQ = {LONG_SEQ}

        class BackwardLargest(dryrun.CostCounter):
            largest = 0

            def track(self, tree):
                super().track(tree)
                if torch._C._current_graph_task_id() != -1:  # inside a backward pass
                    self.largest = max([self.largest] + [
                        t.untyped_storage().nbytes() for t in dryrun._tensors(tree)])

        cfg = configs.get_smoke("minicpm-2b")
        out = {{}}
        for (d, m), batch in (((1, 1), 8), ((4, 1), 8), ((2, 2), 8)):
            dryrun.fake_world(d * m)
            mesh = mesh_lib.make_debug_mesh(d, m, device="cpu")
            shape = ShapeConfig("smoke", 32, batch, "train")
            r = dryrun.cost_cell("minicpm-2b", shape, mesh, "base", cfg=cfg)
            _, _, rules = dryrun._cell_config("minicpm-2b", shape, "base", mesh, cfg)
            trees = dryrun._cell_trees(cfg, shape, mesh, rules)
            r["tree_bytes"] = sum(
                dryrun.tree_bytes_per_device(sharding.keyed_leaves(s), sharding.keyed_leaves(a))
                for s, a in trees.values())
            out[f"{{d}}x{{m}}"] = r
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        fn, args, _, _, rules = dryrun.build_cell("minicpm-2b", shape, mesh, "base", cfg=cfg,
                                                  fake_mode=fake_mode)
        counter = BackwardLargest()
        with fake_mode, counter, sharding.sharding_ctx(mesh, rules):
            fn(*args)
        out["2x2"]["backward_largest"] = counter.largest
        out["2x2"]["vocab"] = cfg.vocab
        # a 2048-token step with remat "dots": the live bytes of the storages
        # the attention oracle makes (a frame of kernels/ref.py on the
        # stack), at their most over the step
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        fn, args, _, _, rules = dryrun.build_cell(
            "minicpm-2b", ShapeConfig("long", LONG_SEQ, 8, "train"), mesh, "base", remat="dots",
            cfg=cfg, fake_mode=fake_mode)
        counter = dryrun.CostCounter(under=ref.__file__)
        with fake_mode, counter, sharding.sharding_ctx(mesh, rules):
            fn(*args)
        out["2x2"]["oracle_most"] = counter.peak_under
        out["2x2"]["heads"] = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        for length in {DECODE_LENS!r}:
            for batch in (8, 1):
                out[f"decode/{{batch}}/{{length}}"] = dryrun.cost_cell(
                    "minicpm-2b", ShapeConfig("smoke", length, batch, "decode"), mesh, "base",
                    cfg=cfg)
        for batch in (8, 2):
            params = model.init_params(cfg, seed=0, device="cpu")
            opt = optimizers.adamw(1e-4, weight_decay=0.1, max_grad_norm=1.0)
            step = step_lib.make_train_step(cfg, opt)
            tokens = torch.randint(0, cfg.vocab, (batch, 32), dtype=torch.int32)
            with FlopCounterMode(display=False) as fc:
                step(params, opt.init(params), {{"tokens": tokens, "labels": tokens}})
            out[f"plain{{batch}}"] = fc.get_total_flops()
        print(json.dumps(out))
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    return _json_lines(res.stdout)[0]


def test_one_device_world_counts_the_plain_steps_flops(small_worlds):
    got = small_worlds["1x1"]
    assert got["flops_per_device"] == small_worlds["plain8"] > 0
    assert got["collective_bytes_per_device"]["total"] == 0
    assert got["memory"]["peak_per_device"] >= got["memory"]["argument_bytes"] > 0
    assert got["memory"]["alias_bytes"] > 0  # params and Adam's moments updated in place


def test_data_parallel_world_counts_a_quarter_batch(small_worlds):
    got = small_worlds["4x1"]
    assert got["flops_per_device"] == small_worlds["plain2"] > 0
    assert got["collective_bytes_per_device"]["all-reduce"] > 0  # the gradients' sum


def test_two_by_two_world(small_worlds):
    got = small_worlds["2x2"]
    assert 0 < got["useful_flops_ratio"] <= 1
    assert got["memory"]["argument_bytes"] == got["tree_bytes"]
    assert got["n_devices"] == 4 and got["hlo_flops_total"] == 4 * got["flops_per_device"]


def test_train_backward_holds_no_more_than_one_vocab_shard(small_worlds):
    """The vocab-parallel cross-entropy's backward writes the logits'
    gradient into this rank's shard alone: no storage the backward makes
    is larger than one vocab shard of the f32 logits, [B/dp, S, V/tp]
    (batch 8 x 32 on 2 x 2: the whole vocabulary's would be twice it)."""
    got = small_worlds["2x2"]
    shard = (8 // 2) * 32 * (padded_vocab(got["vocab"]) // 2) * 4
    assert 0 < got["backward_largest"] <= shard


def test_train_attention_holds_no_more_than_one_chunk(small_worlds):
    """At 2048 tokens the oracle attends 512-row q chunks, each
    rematerialised in the backward pass inside the block's own "dots"
    remat: the live bytes of what it makes never pass one chunk's two f32
    score blocks [B/dp, H/tp, 512, S] (the scores and their softmax), its
    mask [512, S], k and v in f32 and three f32 tensors of q's size (the
    chunks' scaled q and outputs, and the concatenated output), as
    ``scripts/torch_long_step.py``'s ``oracle_bound`` counts them.  Keeping
    every chunk's softmax for the backward read 5.2 score blocks here."""
    got = small_worlds["2x2"]
    heads, kv_heads, dim = got["heads"]
    b, h, hkv = 8 // 2, heads // 2, kv_heads // 2
    block = b * h * CHUNK * LONG_SEQ * 4
    operands = (2 * hkv + 3 * h) * b * LONG_SEQ * dim * 4
    mask = CHUNK * LONG_SEQ
    assert 2 * block <= got["oracle_most"] <= 2 * block + operands + mask


@pytest.mark.parametrize("batch", [8, 1])
def test_decode_collectives_do_not_grow_with_the_cache(small_worlds, batch):
    """A decode step on the 2 x 2 world (the serving rules: the cache's
    length on ``model``; at batch 1, which ``data`` cannot split, on
    ``data``) moves the same collective bytes against a cache of L and of
    2L positions: each rank attends its own piece of the cache and only
    the pieces' outputs and log-sum-exps are reduced.  The cache's
    argument bytes double."""
    short, long = (small_worlds[f"decode/{batch}/{n}"] for n in DECODE_LENS)
    assert short["collective_bytes_per_device"] == long["collective_bytes_per_device"]
    assert short["collective_ops"] == long["collective_ops"]
    assert short["collective_ops"].get("c10d.allreduce_", 0) > 0  # the pieces' combination
    assert long["memory"]["argument_bytes"] > short["memory"]["argument_bytes"]


REAL_WORLD = """
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import codec
from repro_torch.core.folding import make_folding_spec
from repro_torch.core import nttd
from repro_torch.dist import sharding
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.models import model
from repro_torch.optim import optimizers
from repro_torch.train import step as step_lib


def main():
    import json

    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    cfg = configs.get_smoke("minicpm-2b")
    shape = ShapeConfig("smoke", 32, 8, "train")
    _, _, rules = dryrun._cell_config("minicpm-2b", shape, "base", mesh, cfg)
    params = model.init_params(cfg, seed=0, device="cpu",
                               shardings=step_lib.param_shardings(mesh, cfg, rules))
    opt = optimizers.adamw(1e-4, weight_decay=0.1, max_grad_norm=1.0)
    tokens = torch.randint(0, cfg.vocab, (8, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    batch = sharding.device_put({"tokens": tokens, "labels": tokens},
                                step_lib.batch_shardings(mesh, cfg, {"tokens": 0, "labels": 0},
                                                         rules))
    step = step_lib.make_train_step(cfg, opt)
    state = opt.init(params)
    seen = {"train": collectives(mesh, rules, step, params, state, batch)}
    # a decode step at the end of a 32-position cache, laid out as the dry-run lays it
    shape = ShapeConfig("smoke", 32, 8, "decode")
    dcfg, _, drules = dryrun._cell_config("minicpm-2b", shape, "base", mesh, cfg)
    cache = sharding.device_put(model.init_cache(dcfg, 8, 32, device="cpu"),
                                step_lib.cache_shardings(mesh, dcfg, 8, 32, False, drules))
    dparams = model.init_params(dcfg, seed=0, device="cpu",
                                shardings=step_lib.param_shardings(mesh, dcfg, drules))
    dbatch = sharding.device_put({"tokens": tokens[:, :1]}, step_lib.batch_shardings(
        mesh, dcfg, {"tokens": 0}, drules))
    seen["decode"] = collectives(mesh, drules, step_lib.make_decode_step(dcfg), dparams, cache,
                                 dbatch, 31)
    # the data-parallel codec epoch takes positions laid out as the dry-run lays them
    spec = make_folding_spec((6, 5, 4))
    ep = codec._make_dp_train_step(spec, nttd.NTTDConfig(rank=2, hidden=4), optimizers.adam(1e-2),
                                   mesh)
    whole = torch.arange(2 * 8 * 3, dtype=torch.int32).reshape(2, 8, 3)
    laid = sharding.distribute(whole, sharding.NamedSharding(
        mesh, sharding.PartitionSpec(None, sharding.dp_axes(mesh))))
    if RANK == 0:
        print(json.dumps({
            **seen,
            "local_block_equal": bool(torch.equal(ep.local_block(laid), ep.local_block(whole)))}))


def collectives(mesh, rules, step, *args):
    # the collectives of step(*args) on this rank: their kinds' counts as
    # CommDebugMode sees them, and their bytes as the cost pass counts them
    import json

    counter = dryrun.CostCounter()
    with CommDebugMode() as comm, counter, sharding.sharding_ctx(mesh, rules):
        step(*args)
    seen = {}
    for op, n in comm.get_comm_counts().items():
        kind = dryrun._collective_kind(op)
        seen[kind] = seen.get(kind, 0) + n
    return {"comm_counts": seen, "bytes": dryrun.collective_bytes_per_device(counter.collectives)}
"""


@pytest.fixture(scope="module")
def real_and_fake(tmp_path_factory):
    out = tmp_path_factory.mktemp("real_world")
    real = _json_lines(run_ranks(out, 4, REAL_WORLD, timeout=240)[0])[0]
    fake = _python("""
        import json
        from repro_torch import configs
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun, mesh as mesh_lib
        dryrun.fake_world(4)
        mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
        print(json.dumps({kind: dryrun.cost_cell(
            "minicpm-2b", ShapeConfig("smoke", 32, 8, kind), mesh, "base",
            cfg=configs.get_smoke("minicpm-2b")) for kind in ("train", "decode")}))
    """)
    assert fake.returncode == 0, fake.stderr[-3000:]
    return real, _json_lines(fake.stdout)[0]


def test_real_world_collectives_equal_the_fake_pass(real_and_fake):
    _real_equals_fake(real_and_fake, "train")


def test_real_world_decode_collectives_equal_the_fake_pass(real_and_fake):
    """A decode step at the end of its cache: the same kinds, counts and
    bytes, among them the ``c10d`` all-reduces that combine the pieces of
    the cache's length."""
    _real_equals_fake(real_and_fake, "decode")


def _real_equals_fake(real_and_fake, kind: str) -> None:
    real, fake = real_and_fake[0][kind], real_and_fake[1][kind]
    predicted = {}
    for op, n in fake["collective_ops"].items():
        kind = dryrun._collective_kind(op)
        predicted[kind] = predicted.get(kind, 0) + n
    assert real["comm_counts"] == predicted
    assert set(predicted) >= {"all-reduce", "all-gather"}
    assert real["bytes"] == fake["collective_bytes_per_device"]
    assert fake["collective_bytes_per_device"]["total"] > 0
    if kind == "decode":  # the cache's pieces combined: all-reduces of c10d
        assert fake["collective_ops"].get("c10d.allreduce_", 0) > 0


def test_dp_epoch_takes_laid_out_positions(real_and_fake):
    assert real_and_fake[0]["local_block_equal"]


def test_full_width_cell_cli(tmp_path):
    """mamba2-1.3b x decode_32k on the 16 x 16 mesh at full width and
    depth: one line with every reference key, its roofline over the H100
    constants; ``--out`` writes ``cell_path``'s file."""
    res = _python(f"""
        from repro_torch.launch import dryrun
        raise SystemExit(dryrun.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k",
                                      "--mesh", "single", "--out", {str(tmp_path)!r}]))
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    (got,) = _json_lines(res.stdout)
    assert got["status"] == "ok" and REFERENCE_KEYS <= set(got), set(got) ^ REFERENCE_KEYS
    assert set(got["memory"]) == MEMORY_KEYS and set(got["roofline"]) == ROOFLINE_KEYS
    assert (got["n_devices"], got["n_blocks"], got["rules"]) == (256, 48, "auto")
    r = got["roofline"]
    assert r["compute_s"] == got["flops_per_device"] / 989e12
    assert r["memory_s"] == got["hlo_bytes_per_device"] / 3.35e12
    assert r["collective_s"] == got["collective_bytes_per_device"]["total"] / 50e9
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"]) > 0
    assert got["memory"]["peak_per_device"] >= got["memory"]["argument_bytes"] > 0
    assert got["memory"]["alias_bytes"] > 0  # the cache is written in place
    with open(tmp_path / "mamba2-1.3b__decode_32k__single__auto.json") as f:
        assert json.load(f) == got


def test_cli_reports_errors_and_skips(tmp_path):
    """A cell that raises prints ``status: error`` and the run exits 1; a
    ``should_skip`` cell prints ``status: skip``."""
    res = _python("""
        from repro_torch.launch import dryrun
        def boom(*args, **kwargs):
            raise RuntimeError("no rule for this cell")
        dryrun.cost_cell = boom
        code = dryrun.main(["--arch", "minicpm-2b", "--shape", "long_500k", "--mesh", "both"])
        assert code == 0, code
        raise SystemExit(dryrun.main(["--arch", "minicpm-2b", "--shape", "train_4k",
                                      "--mesh", "both"]))
    """)
    assert res.returncode == 1, res.stderr[-3000:]
    lines = _json_lines(res.stdout)
    assert [(x["mesh"], x["status"]) for x in lines] == [
        ("single", "skip"), ("multi", "skip"), ("single", "error"), ("multi", "error")]
    assert lines[-1]["error"] == "RuntimeError: no rule for this cell"
