"""The port's ``train.checkpoint`` against the JAX package's, on the CPU:
the leaf keys are the reference's ``_flatten`` strings in its order, and a
checkpoint written by either package restores in the other, bitwise."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.optim import optimizers as joptim
from repro.train import checkpoint as jckpt
from repro_torch import convert
from repro_torch.optim import optimizers as toptim
from repro_torch.train import checkpoint as tckpt

ARCH = "minicpm-2b"


def _state_pair():
    """The reference's {"params", "opt"} after init, and the port's copy."""
    jp = jmodel.init_params(jax.random.PRNGKey(0), jconfigs.get_smoke(ARCH))
    jopt = joptim.adamw(1e-3)
    js = jopt.init(jp)
    js = js._replace(step=jnp.asarray(7, jnp.int32),
                     mu=jax.tree.map(lambda x: x + 0.5, js.mu))
    np_tree = jax.tree.map(np.asarray, {"params": jp, "opt": js})
    tree = {"params": convert.params_from_numpy(np_tree["params"], "cpu"),
            "opt": convert.adam_state_from_numpy(np_tree["opt"], "cpu")}
    return {"params": jp, "opt": js}, tree


def _same(got, want) -> None:
    gl, wl = tckpt._flatten(got), jckpt._flatten(want)
    assert [k for k, _ in gl] == [k for k, _ in wl]
    for (k, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        assert isinstance(g, torch.Tensor), k
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def test_flatten_keys_are_the_reference_keys():
    jtree, ttree = _state_pair()
    want = [k for k, _ in jckpt._flatten(jtree)]
    assert [k for k, _ in tckpt._flatten(ttree)] == want
    assert want[0] == "opt/.step" and want[-1] == "params/tok/embed"
    assert "opt/.mu/blocks/attn/wk" in want


def test_flatten_sequences_and_none_like_jax():
    tree = {"b": [np.zeros(2), (np.ones(1), None)], "a": {"z": np.zeros(3), "y": np.ones(2)}}
    assert [k for k, _ in tckpt._flatten(tree)] == [k for k, _ in jckpt._flatten(tree)]
    back = tckpt._unflatten_into(tree, {k: i for i, (k, _) in enumerate(tckpt._flatten(tree))})
    assert back == {"b": [2, (3, None)], "a": {"z": 1, "y": 0}}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree, ttree = _state_pair()
    tckpt.Checkpointer(str(tmp_path), async_save=False).save(3, ttree, extra={"who": "port"})
    restored, manifest = jckpt.Checkpointer(str(tmp_path)).restore(3, jtree)
    assert manifest["step"] == 3 and manifest["extra"] == {"who": "port"}
    _same(ttree, jax.tree.map(np.asarray, restored))
    assert isinstance(restored["opt"], joptim.AdamState)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _state_pair()
    jckpt.Checkpointer(str(tmp_path), async_save=False).save(5, jtree)
    template = {"params": toptim.tree_map(torch.zeros_like, ttree["params"]),
                "opt": ttree["opt"]}
    restored, manifest = tckpt.Checkpointer(str(tmp_path)).restore(None, template)
    assert manifest["step"] == 5
    assert isinstance(restored["opt"], toptim.AdamState)
    _same(restored, jtree)


def test_manifest_layout_is_the_reference_layout(tmp_path):
    jtree, ttree = _state_pair()
    tckpt.Checkpointer(str(tmp_path / "t"), async_save=False).save(1, ttree)
    jckpt.Checkpointer(str(tmp_path / "j"), async_save=False).save(1, jtree)
    read = lambda d: json.load(open(tmp_path / d / "step_0000000001" / "manifest.json"))  # noqa: E731
    t, j = read("t"), read("j")
    assert t.keys() == j.keys() and t["leaves"] == j["leaves"]
    assert sorted(os.listdir(tmp_path / "t" / "step_0000000001")) == sorted(
        os.listdir(tmp_path / "j" / "step_0000000001"))


def test_keep_gc_and_roundtrip(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path), keep=2, async_save=False)
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones(3, 3)}}
    for step in [10, 20, 30]:
        ck.save(step, toptim.tree_map(lambda x: x * step, tree))
    assert ck.all_steps() == [20, 30]
    restored, manifest = ck.restore(30, tree)
    torch.testing.assert_close(restored["a"], torch.arange(10.0) * 30, rtol=0, atol=0)
    assert manifest["step"] == 30
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]


def test_async_save_snapshots_before_returning(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path), async_save=True)
    tree = {"w": torch.full((4,), 7.0)}
    ck.save(5, tree)
    tree["w"].add_(1.0)  # the caller updates in place right away
    ck.wait()
    restored, step = tckpt.auto_resume(ck, {"w": torch.zeros(4)})
    assert step == 5
    torch.testing.assert_close(restored["w"], torch.full((4,), 7.0), rtol=0, atol=0)


def test_async_save_error_raises_at_wait(tmp_path, monkeypatch):
    ck = tckpt.Checkpointer(str(tmp_path), async_save=True)

    def fail(*args):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "save", fail)
    ck.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # raised once
    assert threading.active_count() >= 1


def test_auto_resume_empty_dir(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path))
    tree, step = tckpt.auto_resume(ck, {"w": torch.zeros(2)})
    assert tree is None and step == 0
    with pytest.raises(FileNotFoundError):
        ck.restore(None, {"w": torch.zeros(2)})


def test_restore_puts_leaves_on_the_template_device(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"w": torch.ones(3), "i": torch.tensor(4, dtype=torch.int32)})
    template = {"w": torch.empty(3, device="meta"), "i": torch.zeros((), dtype=torch.int32)}
    restored, _ = ck.restore(1, template)
    assert restored["w"].device.type == "meta" and restored["i"].device.type == "cpu"
    assert restored["i"].shape == () and int(restored["i"]) == 4
    assert restored["i"].dtype == torch.int32


def test_bf16_leaf_round_trips_without_ml_dtypes(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path), async_save=False)
    w = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)
    ck.save(1, {"w": w})
    meta = json.load(open(tmp_path / "step_0000000001" / "manifest.json"))["leaves"]["w"]
    assert meta["dtype"] == "bfloat16"
    arr = np.load(tmp_path / "step_0000000001" / "w.npy")
    assert arr.dtype.itemsize == 2  # the bits, as the reference's ml_dtypes array
    restored, _ = ck.restore(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16 and torch.equal(restored["w"], w)
    import ml_dtypes

    ref = np.array(w.float().numpy(), dtype=ml_dtypes.bfloat16)
    assert arr.tobytes() == ref.tobytes()
