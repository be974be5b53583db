"""Neural Tensor-Train Decomposition (paper §IV-B, Alg. 2), as in
``repro.core.nttd``.

TT cores are generated per entry by an auto-regressive network:

    mode indices --embedding--> e_1..e_d' --LSTM--> h_1..h_d'
    T_1 = W1 h_1 + b1 (1xR);  T_k = W h_k + b (RxR, shared k=2..d'-1);
    T_d' = Wd h_d' + bd (Rx1);  value = T_1 T_2 ... T_d'

Embedding tables are shared across folded modes of equal length.  Params
are a plain nested dict of tensors with the reference's keys; the payload
format walks them in string-sorted key order.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.folding import FoldingSpec
from repro_torch.devices import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.decode_tile import bucket_operands

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NTTDConfig:
    rank: int = 8            # R, TT rank
    hidden: int = 16         # h, LSTM hidden == embedding dim
    dtype: torch.dtype = torch.float32
    kernel_impl: str = "auto"  # see kernels.ops


def default_impl() -> str:
    """The decode impl when none is given: ``REPRO_DECODE_IMPL`` or "auto".
    The impl is an execution choice; payloads carry none."""
    return os.environ.get("REPRO_DECODE_IMPL", "auto")


def param_shapes(spec: FoldingSpec, cfg: NTTDConfig) -> dict[str, Any]:
    """The params tree with a shape tuple at every leaf."""
    h, r = cfg.hidden, cfg.rank
    shapes: dict[str, Any] = {
        f"embed_{m}": (m, h) for m in sorted(set(spec.folded_shape))
    }
    shapes["lstm"] = {"wi": (h, 4 * h), "wh": (h, 4 * h), "b": (4 * h,)}
    shapes["head_first"] = {"w": (h, r), "b": (r,)}
    shapes["head_mid"] = {"w": (h, r * r), "b": (r * r,)}
    shapes["head_last"] = {"w": (h, r), "b": (r,)}
    return shapes


def init_params(
    generator: torch.Generator,
    spec: FoldingSpec,
    cfg: NTTDConfig,
    device: str | torch.device | None = None,
) -> Params:
    """Random params with the reference's distributions (``nttd.py``).

    Draws come from ``generator`` (a CPU generator) in a fixed order and
    are then moved to ``device``, CUDA unless given (without CUDA this
    raises unless ``device="cpu"``); the numbers differ from JAX's.
    """
    device = resolve_device(device)
    h, r = cfg.hidden, cfg.rank

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32) * scale).to(
            device=device, dtype=cfg.dtype
        )

    def glorot(shape):
        return normal(shape, math.sqrt(2.0 / (shape[0] + shape[-1])))

    params: Params = {}
    for m in sorted(set(spec.folded_shape)):
        params[f"embed_{m}"] = normal((m, h), 1.0 / np.sqrt(h))
    params["lstm"] = {
        "wi": glorot((h, 4 * h)),
        "wh": glorot((h, 4 * h)),
        "b": torch.zeros((4 * h,), dtype=cfg.dtype, device=device),
    }
    # mid cores start at the identity, first/last at 1/sqrt(R), so the
    # initial chain product is ~1 for any d'
    inv_sqrt_r = torch.full((r,), 1.0 / np.sqrt(r), dtype=cfg.dtype, device=device)
    params["head_first"] = {"w": glorot((h, r)), "b": inv_sqrt_r}
    params["head_mid"] = {
        "w": glorot((h, r * r)),
        "b": torch.eye(r, dtype=cfg.dtype, device=device).reshape(r * r),
    }
    params["head_last"] = {"w": glorot((h, r)), "b": inv_sqrt_r.clone()}
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def count_params(params: Params) -> int:
    return sum(int(p.numel()) for p in _leaves(params))


def count_param_shapes(spec: FoldingSpec, cfg: NTTDConfig) -> int:
    """``count_params`` of the params ``init_params`` would make, from
    ``param_shapes`` alone."""
    return sum(math.prod(shape) for shape in _leaves(param_shapes(spec, cfg)))


def params_device(params: Params) -> torch.device:
    return next(_leaves(params)).device


def fused_decode_inputs(
    params: Params, spec: FoldingSpec, cfg: NTTDConfig
) -> tuple[torch.Tensor, ...]:
    """Stack params into the flat operand layout of the fused decode kernel.

    Embedding tables are stacked per step and zero-padded to
    ``M = max(folded_shape)`` rows, giving one dense [T, M, H] operand.
    Returns ``(emb, wi, wh, b, w_first, b_first, w_mid, b_mid, w_last,
    b_last)``.
    """
    m_max = max(spec.folded_shape)
    first = params[f"embed_{spec.folded_shape[0]}"]
    emb = torch.zeros(
        (spec.d_prime, m_max, first.shape[1]), dtype=first.dtype, device=first.device
    )
    for t, m in enumerate(spec.folded_shape):
        emb[t, :m] = params[f"embed_{m}"]
    lstm = params["lstm"]
    return (
        emb,
        lstm["wi"].contiguous(),
        lstm["wh"].contiguous(),
        lstm["b"].contiguous(),
        params["head_first"]["w"].contiguous(),
        params["head_first"]["b"].contiguous(),
        params["head_mid"]["w"].contiguous(),
        params["head_mid"]["b"].contiguous(),
        params["head_last"]["w"].contiguous(),
        params["head_last"]["b"].contiguous(),
    )


def uses_fused_decode(spec: FoldingSpec, cfg: NTTDConfig) -> bool:
    """Whether ``apply`` runs the one-launch decode (and reads operands)."""
    return cfg.kernel_impl in ("fused", "auto") and spec.d_prime >= 2


def decode_operands(
    params: Params, spec: FoldingSpec, cfg: NTTDConfig
) -> tuple[torch.Tensor, ...]:
    """``fused_decode_inputs`` as the fused decode kernel takes them: on
    CUDA zero-padded to the register body's (hidden, rank) bucket, or to the
    simt body's rank (a multiple of 4), both exact
    (``kernels.decode_tile.bucket_operands``); on the CPU, where the plain
    version runs, as they are.  Built once per payload by
    ``CompressedTensor``."""
    ws = fused_decode_inputs(params, spec, cfg)
    return bucket_operands(ws) if ws[0].device.type == "cuda" else ws


# floats of one-hot rows a gradient product of ``_TableRows`` takes at once
_ONEHOT_FLOATS = 1 << 24


class _TableRows(torch.autograd.Function):
    """``F.embedding(idx, table)`` with a deterministic gradient.

    PyTorch's CUDA embedding backward sums a row's duplicate indices in an
    order that changes from call to call, so two fits from one seed drift
    apart.  Here the table's gradient is one-hot(idx)ᵀ · dx, matrix
    products over chunks of at most ``_ONEHOT_FLOATS`` one-hot floats,
    added in a fixed order: the same bits every call, on any device."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return torch.nn.functional.embedding(idx, table)

    @staticmethod
    def backward(ctx, dx: torch.Tensor):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = dx.reshape(-1, dx.shape[-1])
        rows = torch.arange(ctx.rows, device=flat.device)
        grad = torch.zeros((ctx.rows, g.shape[1]), dtype=dx.dtype, device=dx.device)
        chunk = max(1, _ONEHOT_FLOATS // ctx.rows)
        for s in range(0, flat.shape[0], chunk):
            onehot = (flat[s:s + chunk, None] == rows).to(dx.dtype)
            grad.addmm_(onehot.t(), g[s:s + chunk])
        return grad, None


def _embed(params: Params, folded_idx: torch.Tensor, spec: FoldingSpec) -> torch.Tensor:
    """x [B, d', h]: row ``folded_idx[:, j]`` of mode j's table, one lookup
    per distinct table over all the modes that share it (``_TableRows``).
    The same values as one gather per mode; its gradient sums a table's
    rows over those modes in one product of one-hot rows, in a fixed
    order (the backward of a gather sums a row's duplicates one after
    another with atomics, and a table of 8 rows gets ~B d' / 8 of them;
    PyTorch's embedding backward sums them in a varying order)."""
    modes: dict[int, list[int]] = {}
    for j, m in enumerate(spec.folded_shape):
        modes.setdefault(m, []).append(j)
    parts, order = [], []
    for m, js in modes.items():
        parts.append(_TableRows.apply(params[f"embed_{m}"], folded_idx[:, js]))
        order += js
    x = torch.cat(parts, dim=1)
    if order != sorted(order):
        x = x[:, np.argsort(order)]
    return x


def apply(
    params: Params,
    folded_idx: torch.Tensor,  # [B, d'] integer
    spec: FoldingSpec,
    cfg: NTTDConfig,
    operands: tuple[torch.Tensor, ...] | None = None,
) -> torch.Tensor:
    """Approximate entries at the given folded indices.  Returns [B].

    "fused" and "auto" run the one-launch decode kernel (d' >= 2) on
    ``operands``, the params' ``decode_operands`` (built here when None);
    "cuda" runs the unfused pair ``lstm_scan`` + ``tt_contract``; "ref"
    runs the plain oracles.  The head projections of "cuda" and "ref" are
    ``torch.matmul``; they are full f32 on the card only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default),
    which this function leaves to the caller.

    Training differentiates the unfused route: on the card "cuda" is the
    training forward (embedding gather, the ``lstm_scan`` Function, the head
    matmuls, the ``tt_contract`` Function), whose gradients run the two
    backward kernels, and autograd sums the shared embedding tables'
    gradients over the modes.  The fused decode has no backward, so
    ``core.codec.compress`` trains with "cuda" where its impl is "auto",
    "fused" or "cuda", and predicts (fitness, Alg. 3) with its own impl: on
    the card "auto" is the fused decode.  The reference trains and predicts
    on one ``kernel_impl``.
    """
    d_prime = spec.d_prime
    r = cfg.rank
    if uses_fused_decode(spec, cfg):
        return ops.nttd_decode_tile(
            folded_idx.to(torch.int32).contiguous(),
            *(operands if operands is not None else decode_operands(params, spec, cfg)),
            impl=cfg.kernel_impl,
        )
    # --- embedding lookup (shared tables by mode length) -------------------
    x = _embed(params, folded_idx, spec)  # [B, d', h]
    # --- LSTM encoder -------------------------------------------------------
    lstm = params["lstm"]
    hs = ops.lstm_scan(x, lstm["wi"], lstm["wh"], lstm["b"], impl=cfg.kernel_impl)
    # --- TT-core heads: plain matmuls outside any kernel, as in the
    # reference (full f32 on the card only while TF32 stays off)
    first = hs[:, 0] @ params["head_first"]["w"] + params["head_first"]["b"]  # [B, R]
    last = hs[:, -1] @ params["head_last"]["w"] + params["head_last"]["b"]    # [B, R]
    if d_prime > 2:
        mids = (
            hs[:, 1:-1] @ params["head_mid"]["w"] + params["head_mid"]["b"]
        ).reshape(-1, d_prime - 2, r, r)  # [B, d'-2, R, R]
    else:
        mids = torch.zeros((folded_idx.shape[0], 0, r, r), dtype=x.dtype, device=x.device)
    # --- chain contraction ----------------------------------------------------
    return ops.tt_contract(first, mids.contiguous(), last, impl=cfg.kernel_impl)


def apply_at_positions(
    params: Params,
    positions: torch.Tensor,  # [B, d] indices in the *reordered* tensor
    spec: FoldingSpec,
    cfg: NTTDConfig,
    operands: tuple[torch.Tensor, ...] | None = None,
) -> torch.Tensor:
    """Fold positions on their device, then apply."""
    return apply(params, spec.fold_indices(positions.long()), spec, cfg, operands)


def make_predict(spec: FoldingSpec, cfg: NTTDConfig):
    """(params, positions[B, d]) -> values[B]."""

    def predict(params: Params, positions: torch.Tensor) -> torch.Tensor:
        return apply_at_positions(params, positions, spec, cfg)

    return predict


# canonical home is repro_torch.codecs.indexing; re-exported here, as the
# reference does, for callers that import it from nttd (imported after the
# definitions above: the codecs package imports this module)
from repro_torch.codecs.indexing import flat_to_multi  # noqa: E402, F401


def generate_flat(
    params: Params,
    spec: FoldingSpec,
    cfg: NTTDConfig,
    batch: int = 65536,
    predict_fn=None,
) -> torch.Tensor:
    """All entries of the approximated tensor (reordered coordinates) as a
    flat f32 tensor on the params' device.  The flat indices of each batch
    are made on that device."""
    device = params_device(params)
    n = spec.n_entries
    out = torch.empty((n,), dtype=torch.float32, device=device)
    fn = predict_fn or make_predict(spec, cfg)
    dims_np = np.array(spec.shape, dtype=np.int64)
    radix_np = np.concatenate([np.cumprod(dims_np[::-1])[::-1][1:], [1]])
    dims = torch.as_tensor(dims_np, device=device)
    radix = torch.as_tensor(radix_np, device=device)
    for start in range(0, n, batch):
        stop = min(start + batch, n)
        flat = torch.arange(start, stop, dtype=torch.int64, device=device)
        pos = (flat[:, None] // radix) % dims
        out[start:stop] = fn(params, pos)
    return out


def generate_tensor(
    params: Params,
    spec: FoldingSpec,
    cfg: NTTDConfig,
    batch: int = 65536,
    predict_fn=None,
) -> np.ndarray:
    """Materialize the full approximated tensor (reordered coordinates)."""
    flat = generate_flat(params, spec, cfg, batch, predict_fn)
    return flat.reshape(spec.shape).cpu().numpy()
