"""Carry weights between the JAX package and the port as numpy arrays.

    np_tree = jax.tree.map(np.asarray, params)      # on the JAX side
    params = params_from_numpy(np_tree, "cuda")     # the port's params
    lm = params_from_numpy(np_tree, "cuda", dtype=torch.bfloat16)  # serve dtype

The same call carries an NTTD params tree and an LM params tree
(``repro.models.model.init_params``): both are nested dicts whose keys the
port mirrors.  numpy has no bf16 of its own; a JAX bf16 leaf arrives as an
``ml_dtypes`` bfloat16 array and is carried over exactly.

``adam_state_from_numpy`` carries an optimizer state (the reference's
``AdamState`` with numpy leaves, or anything with ``step``, ``mu`` and
``nu``) into the port's ``AdamState``, so both packages start a training
step from the same state.  ``compressed_from_numpy`` rebuilds a port
``CompressedTensor`` from the numpy parts of a reference one.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import nttd
from repro_torch.core.codec import CompressedTensor
from repro_torch.core.folding import spec_from_factors
from repro_torch.devices import resolve_device
from repro_torch.optim.optimizers import AdamState


def _leaf(arr, device: torch.device, dtype: torch.dtype | None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: widen exactly, narrow on the torch side
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: dict[str, Any], device=None,
                      dtype: torch.dtype | None = None) -> nttd.Params:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``
    (CUDA unless given).  ``dtype`` casts every floating leaf (the serving
    dtype of an LM whose masters are f32); integer leaves keep theirs."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)


def params_to_numpy(params: nttd.Params) -> dict[str, Any]:
    """Inverse of :func:`params_from_numpy`."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def adam_state_from_numpy(state, device=None) -> AdamState:
    """An optimizer state with numpy leaves (``state.step``, ``state.mu``,
    ``state.nu``) -> the port's ``AdamState`` on ``device`` (CUDA unless
    given), every leaf in its own dtype."""
    device = resolve_device(device)
    return AdamState(step=_leaf(state.step, device, None),
                     mu=params_from_numpy(state.mu, device),
                     nu=params_from_numpy(state.nu, device))


def compressed_from_numpy(
    params: dict[str, Any],
    pi: Sequence[np.ndarray],
    shape: Sequence[int],
    factors: np.ndarray,
    norm_mean: float = 0.0,
    norm_std: float = 1.0,
    *,
    device=None,
) -> CompressedTensor:
    """A port ``CompressedTensor`` from a reference one's numpy parts:
    ``params`` (numpy tree), ``pi``, ``spec.shape``, ``spec.factors`` and
    the normalization.  Rank and hidden width are read off the params; the
    kernel impl is ``nttd.default_impl()`` (replace ``cfg`` for another)."""
    tparams = params_from_numpy(params, device)
    cfg = nttd.NTTDConfig(
        rank=int(tparams["head_first"]["b"].shape[0]),
        hidden=int(tparams["lstm"]["wi"].shape[0]),
        kernel_impl=nttd.default_impl(),
    )
    return CompressedTensor(
        tparams,
        [np.asarray(p, dtype=np.int64) for p in pi],
        spec_from_factors(shape, np.asarray(factors)),
        cfg,
        float(norm_mean),
        float(norm_std),
    )
