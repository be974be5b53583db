"""The port's GPipe pipeline (``repro_torch.dist.pipeline_parallel``)
against the JAX package's, on the CPU.

``split_stages`` is held against the reference's on the shapes of
``tests/test_dist.py``.  ``pipeline_forward`` runs the reference test's
case (L 8, D 16, mb 8, ``tanh(x @ w)`` stages, ``tests/test_spmd.py``) in
one spawned gloo world of 8 ranks, on four meshes and microbatch counts:
the reference's 8 stages with M 4 (fewer microbatches than stages), M 1,
a 4-stage ``pod`` axis of a 4 x 2 mesh with M 3 (the stage group is a
sub-group; the stage params are ``DTensor``s sharded over it) and a
2-stage axis of a 2 x 4 mesh with M 5.  Each is held against the
reference's sequential forward and its ``pipeline_forward`` (a
subprocess with 8 host devices) at rtol = atol = 2e-4, the reference
test's bound; every rank's output must equal rank 0's bitwise.  Inputs
come from a numpy seed.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ranks import RANK_TIMEOUT, SRC, run_ranks

from repro.dist import pipeline_parallel as jpp
from repro_torch.dist import pipeline_parallel as pp

L, D, MB, WORLD, TOL = 8, 16, 8, 8, 2e-4
# name: (mesh shape, mesh axis names, microbatches)
CASES = {
    "s8_m4": ((8,), ("pod",), 4),
    "s8_m1": ((8,), ("pod",), 1),
    "s4_m3_subgroup": ((4, 2), ("pod", "data"), 3),
    "s2_m5": ((2, 4), ("pod", "data"), 5),
}

REF_SCRIPT = """
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.dist import pipeline_parallel as pp

out, cases = sys.argv[1], json.loads(sys.argv[2])


def fwd_block(params, x):
    def body(x, wi):
        return jax.nn.tanh(x @ wi), None
    x, _ = jax.lax.scan(body, x, params)
    return x


res = {}
for name, (shape, names, m) in cases.items():
    inp = np.load(os.path.join(out, f"{name}.npz"))
    w, x = jnp.asarray(inp["w"]), jnp.asarray(inp["x"])
    res[f"{name}/seq"] = np.asarray(fwd_block(w, x.reshape(-1, x.shape[-1])).reshape(x.shape))
    mesh = jax.make_mesh(tuple(shape), tuple(names))
    res[f"{name}/pipe"] = np.asarray(
        pp.pipeline_forward(fwd_block, pp.split_stages(w, shape[0]), x, mesh, axis="pod"))
np.savez(os.path.join(out, "reference.npz"), **res)
"""

BODY = """
import json
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.dist import pipeline_parallel as pp
from repro_torch.dist.sharding import NamedSharding, PartitionSpec, device_put


def fwd_block(params, x):
    for wi in params:
        x = torch.tanh(x @ wi)
    return x


def main():
    res = {}
    for name, (shape, names, m) in json.loads(os.environ["CASES"]).items():
        inp = np.load(os.path.join(OUT, f"{name}.npz"))
        w, x = torch.from_numpy(inp["w"]), torch.from_numpy(inp["x"])
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
        stage_params = pp.split_stages(w, shape[0])
        if "subgroup" in name:  # each rank holds its own stage alone
            stage_params = device_put(stage_params, NamedSharding(mesh, PartitionSpec("pod")))
        stats = {}
        res[name] = pp.pipeline_forward(fwd_block, stage_params, x, mesh, axis="pod",
                                        stats=stats).numpy()
        res[name + "/stats"] = np.array(json.dumps(
            {k: stats[k] for k in ("ticks", "stages", "microbatches", "bubble_fraction")}
            | {"ticks_timed": len(stats["tick_seconds"])}))
    np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **res)
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each case's inputs, the reference's outputs and every rank's."""
    out = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    inputs = {}
    for name, (_, _, m) in CASES.items():
        inputs[name] = {"w": (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32),
                        "x": rng.standard_normal((m, MB, D)).astype(np.float32)}
        np.savez(out / f"{name}.npz", **inputs[name])
    cases = json.dumps(CASES)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(out), cases],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        run_ranks(out, WORLD, BODY, CASES=cases)
        log, _ = ref.communicate(timeout=RANK_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return inputs, dict(np.load(out / "reference.npz")), ranks


def test_split_stages_matches_reference():
    params = {"w": np.arange(8 * 4 * 4.0, dtype=np.float32).reshape(8, 4, 4),
              "b": np.arange(8.0, dtype=np.float32)}
    got = pp.split_stages({k: torch.from_numpy(v) for k, v in params.items()}, 4)
    want = jpp.split_stages({k: jnp.asarray(v) for k, v in params.items()}, 4)
    assert got["w"].shape == (4, 2, 4, 4) and got["b"].shape == (4, 2)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["w"].reshape(8, 4, 4).numpy(), params["w"])
    with pytest.raises(ValueError):
        jpp.split_stages({k: jnp.asarray(v) for k, v in params.items()}, 3)
    with pytest.raises(ValueError, match="not divisible"):
        pp.split_stages({k: torch.from_numpy(v) for k, v in params.items()}, 3)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_forward_matches_reference(worlds, name):
    inputs, ref, ranks = worlds
    shape, _, m = CASES[name]
    got = ranks[0][name]
    assert got.shape == inputs[name]["x"].shape
    np.testing.assert_allclose(got, ref[f"{name}/seq"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref[f"{name}/pipe"], rtol=TOL, atol=TOL)
    for r, res in enumerate(ranks[1:], 1):  # replicated over the stage axis and beyond
        assert np.array_equal(res[name], got), f"rank {r}'s output differs from rank 0's"
    stats = json.loads(str(ranks[0][name + "/stats"]))
    s = shape[0]
    assert stats == {"ticks": m + s - 1, "stages": s, "microbatches": m,
                     "bubble_fraction": (s - 1) / (m + s - 1), "ticks_timed": m + s - 1}
