"""Adam / AdamW over the port's params, as in ``repro.optim.optimizers``.

The optimizer is an (init, update) pair over a nested dict of tensors
(the port's params tree), with the reference's contract: ``update(grads,
state, params) -> (updates, state)`` and ``apply_updates(params,
updates)``.  The moments are f32 whatever the params' dtype, and every
scalar of the update is an f32 tensor on the params' device, computed in
the reference's order: the bias scales ``1 / (1 - b1**step)`` are f32
powers of an f32 step, as the reference's ``b1**stepf`` is (a Python float
power would be f64 and differ in the last bits), and nothing is read back
to the host.  ``torch.optim.Adam`` orders its arithmetic differently and
is not used.  Each elementwise operation runs over all leaves at once
(``torch._foreach_*``, the same f32 operation on each leaf), so an update
costs a few launches rather than a few per leaf: the reference's jitted
update is one XLA program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

F32 = torch.float32
Schedule = Callable[[torch.Tensor], torch.Tensor]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in string-sorted key order at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the params' device
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float) -> tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def adamw(
    lr: float | Schedule,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float | None = None,
) -> Optimizer:
    consts: dict = {}

    def scalars(device: torch.device) -> tuple[torch.Tensor, ...]:
        """(b1, b2, 1, lr) as f32 scalars on ``device``, made once: a tensor
        made from a Python number on the card is a host-to-device copy,
        which waits for the stream."""
        if device not in consts:
            consts[device] = tuple(torch.tensor(v, dtype=F32, device=device)
                                   for v in (b1, b2, 1.0, 0.0 if callable(lr) else lr))
        return consts[device]

    def sched(step: torch.Tensor) -> torch.Tensor:
        return lr(step) if callable(lr) else scalars(step.device)[3]

    def init(params):
        device = tree_leaves(params)[0].device
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
            nu=tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
        )

    def update(grads, state: AdamState, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        stepf = step.to(F32)
        g = [x.to(F32) for x in tree_leaves(grads)]
        # mu = b1 m + (1 - b1) g;  nu = b2 v + (1 - b2) g^2
        mu = torch._foreach_add(torch._foreach_mul(tree_leaves(state.mu), b1),
                                torch._foreach_mul(g, 1 - b1))
        nu = torch._foreach_add(torch._foreach_mul(tree_leaves(state.nu), b2),
                                torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        b1_t, b2_t, one, _ = scalars(step.device)
        mu_hat_scale = one / (one - torch.pow(b1_t, stepf))
        nu_hat_scale = one / (one - torch.pow(b2_t, stepf))
        lr_t = sched(step)
        # u = (m mu_hat) / (sqrt(v nu_hat) + eps) [+ wd p];  update = -lr u
        u = torch._foreach_div(
            torch._foreach_mul(mu, mu_hat_scale),
            torch._foreach_add(torch._foreach_sqrt(torch._foreach_mul(nu, nu_hat_scale)), eps))
        p = tree_leaves(params)
        if weight_decay:
            u = torch._foreach_add(u, torch._foreach_mul([x.to(F32) for x in p], weight_decay))
        upd = [x.to(q.dtype) for x, q in zip(torch._foreach_mul(u, -lr_t), p)]
        return tree_unflatten(params, upd), AdamState(
            step=step, mu=tree_unflatten(params, mu), nu=tree_unflatten(params, nu))

    return Optimizer(init=init, update=update)


def adam(lr: float | Schedule, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


def apply_updates(params, updates):
    """New params ``p + u``; the old tensors are left as they were."""
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params),
                                                     tree_leaves(updates)))
