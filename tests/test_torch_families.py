"""The MoE, Mamba2 and hybrid layouts and the embedding-input configs of
the port, whole models against the JAX package, on the CPU.

Each of the six configs that came with these families is held, at its
smoke size, on a training step's loss, ``aux`` and gradients against
``jax.value_and_grad`` of the reference's ``loss_fn`` (the unsharded
route: the reference's sharded step fails on the installed JAX, ROADMAP
C.3), with ``embeds`` where the config takes embeddings.  The embedding
configs also run prefill and decode through ``train.step``'s factories
with ``embeds``, and every family serves through the launcher on the
kernel route and the oracle route.  Tolerances: the loss and aux to rtol
1e-5; each gradient to atol 1e-5 + rtol 1e-4 of its leaf's largest value;
logits to 1e-5 (rtol = atol), jamba's to 1e-5 of its largest value (see
``tests/test_torch_lm.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.train import step as jstep
from repro_torch import configs, convert
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models import transformer
from repro_torch.optim import optimizers as toptim
from repro_torch.train import step as tstep
from test_torch_lm import _close_model

NEW_ARCHS = ["musicgen-medium", "internvl2-76b", "mamba2-1.3b", "grok-1-314b",
             "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"]
EMBED_ARCHS = ["musicgen-medium", "internvl2-76b"]
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch: str):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.params_from_numpy(_np(jp), "cpu")


def _batch(cfg, b: int = 2, s: int = 20, seed: int = 0) -> dict:
    """The pipeline's token batch, or for an embedding config its labels
    with embeddings drawn from the same seed."""
    src = jpipe.SyntheticSource(jpipe.PipelineConfig(batch_size=b, seq_len=s,
                                                     vocab=cfg.vocab, seed=seed))
    batch = src.batch_at(0)
    if cfg.input_kind == "embeddings":
        rng = np.random.default_rng(seed)
        batch = {"labels": batch["labels"],
                 "embeds": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)}
    return batch


def _leaf_close(got: torch.Tensor, want, where: str) -> None:
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=GRAD_ATOL + GRAD_RTOL * scale, err_msg=where)


def _tree_close(got: dict, want: dict, where: str = "") -> None:
    assert sorted(got) == sorted(want), where
    for key in want:
        if isinstance(want[key], dict):
            _tree_close(got[key], want[key], f"{where}/{key}")
        else:
            _leaf_close(got[key], want[key], f"{where}/{key}")


# ---------------------------------------------------------------------------
# registry and layouts
# ---------------------------------------------------------------------------
def test_registry_is_the_reference_s():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        for get, jget in ((configs.get, jconfigs.get), (configs.get_smoke, jconfigs.get_smoke)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch)), arch


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_block_layout_is_the_reference_s(arch):
    from repro.models import transformer as jtransformer

    for cfg, jcfg in ((configs.get(arch), jconfigs.get(arch)),
                      (configs.get_smoke(arch), jconfigs.get_smoke(arch))):
        assert transformer.block_layout(cfg) == jtransformer.block_layout(jcfg)
        assert transformer._counts(cfg) == jtransformer._counts(jcfg)


# ---------------------------------------------------------------------------
# a training step's loss, aux and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_aux_and_gradients_match_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    batch = _batch(jcfg)
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    (loss, metrics), grads = tstep.value_and_grad(
        lambda p, b: tmodel.loss_fn(p, tcfg, b), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    assert float(metrics["xent"]) == pytest.approx(float(want_m["xent"]), rel=LOSS_RTOL)
    assert float(metrics["aux"]) == pytest.approx(float(want_m["aux"]), rel=LOSS_RTOL)
    if tcfg.moe_experts:
        assert float(metrics["aux"]) > 0  # summed over the MoE sublayers
    _tree_close(grads, _np(want_g), "grads")


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "grok-1-314b", "jamba-1.5-large-398b"])
def test_remat_modes_agree_with_none(arch, remat):
    _, tcfg, _, tp = _pair(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, s=24).items()}
    runs = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(tcfg, remat=mode)
        runs[mode] = tstep.value_and_grad(lambda p, b: tmodel.loss_fn(p, cfg, b), tp, batch)
    (l0, m0), g0 = runs["none"]
    (l1, m1), g1 = runs[remat]
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    torch.testing.assert_close(m1["aux"], m0["aux"], rtol=1e-6, atol=0)
    for a, b in zip(toptim.tree_leaves(g1), toptim.tree_leaves(g0)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# embeddings in: prefill and decode through the step factories
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embeds_prefill_and_decode_match_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    jpre, jdec = jstep.make_prefill_step(jcfg), jstep.make_decode_step(jcfg)
    tpre, tdec = tstep.make_prefill_step(tcfg), tstep.make_decode_step(tcfg)
    jcache = jmodel.init_cache(jcfg, 2, 24)
    tcache = tmodel.init_cache(tcfg, 2, 24, device="cpu")
    jl, jcache = jpre(jp, jcache, {"embeds": jnp.asarray(emb)})
    tl, tcache = tpre(tp, tcache, {"embeds": torch.from_numpy(emb)})
    _close_model(arch, tl, jl)
    for step in range(2):
        nxt = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jl, jcache = jdec(jp, jcache, {"embeds": jnp.asarray(nxt)}, jnp.int32(11 + step))
        tl, tcache = tdec(tp, tcache, {"embeds": torch.from_numpy(nxt)}, 11 + step)
        _close_model(arch, tl, jl)
    for name in ("k", "v"):
        _close_model(arch, tcache["attn"][name], jcache["attn"][name])


# ---------------------------------------------------------------------------
# the launcher on both routes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "grok-1-314b", "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b", "musicgen-medium"])
def test_launcher_serves_every_family_on_the_cpu(arch):
    """Prompts of 1 and 2 tokens (below the conv's k-1), one across the
    smoke chunk of 16, more requests than slots; the kernel route (the
    flash kernel's plain version here) agrees with the oracle route."""
    cfg = configs.get_smoke(arch)
    argv = ["--arch", arch, "--smoke", "--requests", "5", "--slots", "2",
            "--prompt-len", "1,2,37,5", "--max-new", "4", "--max-len", "64",
            "--device", "cpu", "--keep-logits"]
    kernel = sorted(tserve.main(argv), key=lambda r: r.uid)
    oracle = sorted(tserve.main(argv + ["--attn-impl", "ref"]), key=lambda r: r.uid)
    assert [r.uid for r in kernel] == list(range(5))
    for a, b in zip(kernel, oracle):
        assert len(a.tokens) == 4 and a.prefill_logits.shape == (cfg.vocab,)
        assert bool(torch.isfinite(a.prefill_logits).all())
        assert a.tokens == b.tokens
        torch.testing.assert_close(a.prefill_logits, b.prefill_logits, rtol=TOL, atol=TOL)
