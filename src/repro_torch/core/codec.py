"""TensorCodec: the compressed payload and the compressor (paper Alg. 1),
as in ``repro.core.codec``.

Alternating optimization:
  1. init pi (2-approx metric TSP, §IV-D) and theta (NTTD, §IV-B)
  2. minibatch-Adam epochs on theta over entries of the reordered, folded
     tensor
  3. every ``reorder_every`` epochs: Alg. 3 pi refinement, then Adam state
     re-initialization (paper: the loss surface changed)
  4. stop when fitness converges; return the best state seen

``compress`` runs on the card unless ``device`` says otherwise.  An epoch
is a loop of training steps on the device with one host read, the summed
loss.  On the card every step runs the hand-written ``lstm_scan`` and
``tt_contract`` kernels forward and backward, and the fitness and Alg. 3
predictions run the fused decode kernel (``nttd.apply`` documents the
split).  ``CompressedTensor`` and the §V-A size accounting are the decode
half.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.codecs.indexing import flat_to_multi
from repro_torch.core import nttd, reorder
from repro_torch.core.folding import FoldingSpec, make_folding_spec
from repro_torch.devices import resolve_device
from repro_torch.optim import optimizers


@dataclasses.dataclass
class CodecConfig:
    """The reference's ``CodecConfig``, field for field, but for the
    default ``kernel_impl``: "auto" here, the kernels on the card (the
    unfused ones to train, the fused decode to predict), where the
    reference's default is "ref".  On purpose: the reference fits through
    its jnp oracles because its Pallas kernels have no backward; the port's
    kernels have one.  "ref" runs the plain versions on whatever device (the
    tests' and ``chip_smoke.py``'s comparison route)."""

    rank: int = 8
    hidden: int = 16
    d_prime: int | None = None
    epochs: int = 60
    batch_size: int = 16384
    lr: float = 5e-3
    init_reorder: bool = True      # TSP init (off => TensorCodec-T ablation)
    update_reorder: bool = True    # Alg.3 refinement (off => TensorCodec-R)
    reorder_every: int = 5         # epochs between Alg.3 sweeps
    reorder_warmup: int = 5        # epochs of theta fitting before first sweep
    reorder_samples: int = 4096    # sampled entries per slice for delta-loss
    normalize: bool = True         # standardize input (2 floats in payload)
    seed: int = 0
    kernel_impl: str = "auto"
    entries_per_epoch: int | None = None  # cap for very large tensors
    tol: float = 1e-4              # fitness convergence tolerance
    patience: int = 3
    eval_batch: int = 65536
    verbose: bool = False


@dataclasses.dataclass
class CompressedTensor:
    """The compressed payload D = (theta, pi) plus folding/norm metadata.

    ``params`` live on one device; decoding runs there.
    """

    params: nttd.Params
    pi: list[np.ndarray]
    spec: FoldingSpec
    cfg: nttd.NTTDConfig
    norm_mean: float = 0.0
    norm_std: float = 1.0

    @property
    def device(self) -> torch.device:
        return nttd.params_device(self.params)

    @functools.cached_property
    def inv_pi(self) -> list[np.ndarray]:
        """Per-mode inverse permutations (original index -> position)."""
        return [np.argsort(p) for p in self.pi]

    @functools.cached_property
    def decode_operands(self) -> tuple[torch.Tensor, ...]:
        """The fused decode kernel's operands (``nttd.decode_operands``),
        stacked and padded once: the params are fixed for a payload."""
        return nttd.decode_operands(self.params, self.spec, self.cfg)

    def _predict(self, params: nttd.Params, positions: torch.Tensor) -> torch.Tensor:
        """``generate_flat``'s predict over this payload's ``params``."""
        fused = nttd.uses_fused_decode(self.spec, self.cfg)
        return nttd.apply_at_positions(params, positions, self.spec, self.cfg,
                                       self.decode_operands if fused else None)

    # -- reconstruction ------------------------------------------------------
    def decode(self, indices: np.ndarray) -> np.ndarray:
        """Approximate entries at ORIGINAL indices [B, d] -> [B]."""
        pos = self._orig_to_pos(indices)
        vals = self._predict(
            self.params, torch.as_tensor(pos, dtype=torch.int64, device=self.device)
        )
        return vals.cpu().numpy() * self.norm_std + self.norm_mean

    def to_dense(self, batch: int = 65536) -> np.ndarray:
        """Full reconstruction in ORIGINAL index order.  The entries are
        decoded and un-permuted on the params' device."""
        approx = nttd.generate_flat(self.params, self.spec, self.cfg, batch, self._predict)
        approx = approx.reshape(self.spec.shape) * self.norm_std + self.norm_mean
        for k, inv in enumerate(self.inv_pi):
            approx = approx.index_select(
                k, torch.as_tensor(inv, dtype=torch.int64, device=approx.device)
            )
        return approx.cpu().numpy()

    def fitness(self, x: np.ndarray, batch: int = 65536) -> float:
        norm = float(np.linalg.norm(x.astype(np.float64)))
        approx = self.to_dense(batch)
        err = float(np.linalg.norm((x - approx).astype(np.float64)))
        return 1.0 - err / max(norm, 1e-30)

    def _orig_to_pos(self, indices: np.ndarray) -> np.ndarray:
        inv = self.inv_pi
        pos = np.empty_like(indices)
        for j in range(indices.shape[-1]):
            pos[..., j] = inv[j][indices[..., j]]
        return pos

    # -- payload accounting (paper §V-A conventions) ---------------------------
    def payload_bits(self, bytes_per_param: int = 8) -> int:
        return nttd_payload_bits(
            nttd.count_params(self.params), self.spec.shape, bytes_per_param
        )

    def payload_bytes(self, bytes_per_param: int = 8) -> int:
        return (self.payload_bits(bytes_per_param) + 7) // 8


def nttd_payload_bits(
    n_params: int, shape: tuple[int, ...], bytes_per_param: int = 8
) -> int:
    """Paper §V-A: theta at ``bytes_per_param``, pi at ceil(log2 N_k) bits
    per index, plus the two normalization floats."""
    theta_bits = n_params * bytes_per_param * 8
    pi_bits = sum(
        n * max(int(np.ceil(np.log2(n))), 1) if n > 1 else 0 for n in shape
    )
    norm_bits = 2 * bytes_per_param * 8
    return theta_bits + pi_bits + norm_bits


@dataclasses.dataclass
class CompressionLog:
    fitness_history: list[float]
    loss_history: list[float]
    reorder_stats: list[list[reorder.SwapStats]]
    seconds_init_order: float = 0.0
    seconds_train: float = 0.0
    seconds_reorder: float = 0.0
    epochs_run: int = 0


def training_impl(kernel_impl: str) -> str:
    """The impl the training forward runs: "ref" stays the plain route;
    every kernel impl trains through the unfused kernels ("cuda"), the one
    route with backward kernels."""
    return "ref" if kernel_impl == "ref" else "cuda"


def _make_value_and_grad(spec: FoldingSpec, cfg: nttd.NTTDConfig):
    """(params, positions [B, d], values [B]) -> (loss, grads): the summed
    squared error, a device scalar, and its gradient as a params tree."""

    def value_and_grad(params, positions, values):
        with torch.enable_grad():
            tracked = optimizers.tree_map(lambda p: p.detach().requires_grad_(), params)
            preds = nttd.apply_at_positions(tracked, positions, spec, cfg)
            loss = torch.sum(torch.square(preds - values))
            loss.backward()
        # a leaf the loss does not reach (head_mid at d' = 2) gets zeros, as
        # jax.grad gives it
        return loss.detach(), optimizers.tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad, tracked)

    return value_and_grad


def _make_train_step(spec: FoldingSpec, cfg: nttd.NTTDConfig, opt):
    """(params, opt_state, positions [B, d], values [B]) -> (params,
    opt_state, loss): one Adam step on the summed squared error, the loss a
    device scalar."""
    value_and_grad = _make_value_and_grad(spec, cfg)

    def step(params, opt_state, positions, values):
        loss, grads = value_and_grad(params, positions, values)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optimizers.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def _make_train_epoch(spec: FoldingSpec, cfg: nttd.NTTDConfig, opt):
    """One epoch, the reference's ``lax.scan`` over minibatches as a loop
    of steps on the device: positions [S, B, d] and values [S, B] on the
    params' device -> (params, opt_state, summed loss as a device scalar).
    Nothing is read back to the host."""
    step = _make_train_step(spec, cfg, opt)

    def epoch(params, opt_state, positions, values):
        losses = []
        for s in range(positions.shape[0]):
            params, opt_state, loss = step(params, opt_state, positions[s], values[s])
            losses.append(loss)
        return params, opt_state, torch.sum(torch.stack(losses))

    return epoch


def _fitness(params: nttd.Params, spec: FoldingSpec, cfg: nttd.NTTDConfig, pos: np.ndarray,
             truth: np.ndarray, mean: float, std: float, batch: int) -> float:
    """Fitness on the RAW tensor over positions ``pos`` [N, d] whose
    normalized values are ``truth`` [N]: predictions in batches of
    ``batch`` on the params' device (the fused decode's operands built
    once), both sides un-normalized, sums in f64 on the host."""
    device = nttd.params_device(params)
    pos_dev = torch.as_tensor(pos, device=device)
    operands = (nttd.decode_operands(params, spec, cfg)
                if nttd.uses_fused_decode(spec, cfg) else None)
    preds = torch.empty((pos.shape[0],), dtype=torch.float32, device=device)
    with torch.no_grad():
        for s in range(0, pos.shape[0], batch):
            preds[s:s + batch] = nttd.apply_at_positions(params, pos_dev[s:s + batch], spec,
                                                         cfg, operands)
    truth = truth.astype(np.float64)
    err2 = float(((preds.cpu().numpy().astype(np.float64) - truth) ** 2).sum()) * std * std
    norm2 = float(((truth * std + mean) ** 2).sum())
    return 1.0 - np.sqrt(err2) / max(np.sqrt(norm2), 1e-30)


def compress(
    x: np.ndarray, config: CodecConfig | None = None, device=None
) -> tuple[CompressedTensor, CompressionLog]:
    """Alg. 1 on ``x``; the payload's params live on ``device`` (CUDA
    unless given).  The NumPy ``Generator`` seeded with ``config.seed`` is
    consumed in the reference's order (each epoch's positions, sampled
    fitness, Alg. 3), so both packages see the same index stream; theta's
    initial draws come from a ``torch.Generator`` with the same seed and
    differ from JAX's.  TF32 is off for the run (the head matmuls and the
    weight-gradient products run in full f32) and restored after."""
    config = config or CodecConfig()
    device = resolve_device(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _compress(np.asarray(x, dtype=np.float32), config, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _compress(x: np.ndarray, config: CodecConfig, device: torch.device):
    rng = np.random.default_rng(config.seed)
    d = x.ndim
    spec = make_folding_spec(x.shape, config.d_prime)
    cfg = nttd.NTTDConfig(
        rank=config.rank, hidden=config.hidden, kernel_impl=config.kernel_impl
    )
    train_cfg = dataclasses.replace(cfg, kernel_impl=training_impl(config.kernel_impl))

    mean, std = 0.0, 1.0
    if config.normalize:
        mean = float(x.mean())
        std = float(x.std()) or 1.0
    xn = (x - mean) / std

    log = CompressionLog([], [], [])

    # ---- pi init ------------------------------------------------------------
    t0 = time.time()
    if config.init_reorder:
        pi = reorder.tsp_init(xn)
    else:
        pi = reorder.identity_orders(x.shape)
    log.seconds_init_order = time.time() - t0

    # ---- theta init ------------------------------------------------------------
    params = nttd.init_params(torch.Generator().manual_seed(config.seed), spec, cfg, device)
    opt = optimizers.adam(config.lr)
    opt_state = opt.init(params)
    train_epoch = _make_train_epoch(spec, train_cfg, opt)
    predict = nttd.make_predict(spec, cfg)

    n_entries = int(np.prod(x.shape))
    per_epoch = min(config.entries_per_epoch or n_entries, n_entries)
    bsz = min(config.batch_size, per_epoch)
    steps = max(per_epoch // bsz, 1)

    def epoch_positions() -> np.ndarray:
        if per_epoch == n_entries:
            flat = rng.permutation(n_entries)[: steps * bsz]
        else:
            flat = rng.integers(0, n_entries, size=steps * bsz)
        return flat_to_multi(flat, x.shape)  # [steps*bsz, d]

    def values_at(pos: np.ndarray) -> np.ndarray:
        orig = np.empty_like(pos)
        for j in range(d):
            orig[:, j] = pi[j][pos[:, j]]
        return xn[tuple(orig[:, j] for j in range(d))]

    # fitness in position space: ||X_pi - approx|| == ||X - approx_orig||
    eval_n = min(n_entries, 4_000_000)
    eval_exhaustive = eval_n == n_entries

    def eval_fitness() -> float:
        if eval_exhaustive:
            flat = np.arange(n_entries, dtype=np.int64)
        else:
            flat = rng.integers(0, n_entries, size=eval_n)
        pos = flat_to_multi(flat, x.shape)
        return _fitness(params, spec, cfg, pos, values_at(pos), mean, std, config.eval_batch)

    best_fit = -np.inf
    best_snapshot = None
    stall = 0
    for epoch in range(config.epochs):
        t0 = time.time()
        pos_all = epoch_positions()
        vals_all = values_at(pos_all)
        params, opt_state, total_loss = train_epoch(
            params,
            opt_state,
            torch.as_tensor(pos_all.reshape(steps, bsz, d), device=device),
            torch.as_tensor(vals_all.reshape(steps, bsz), device=device),
        )
        total_loss = float(total_loss)  # the epoch's one host read
        log.seconds_train += time.time() - t0
        log.loss_history.append(total_loss)
        log.epochs_run = epoch + 1

        # ---- Alg. 3 reorder + Adam reinit ------------------------------------
        if (
            config.update_reorder
            and epoch + 1 >= config.reorder_warmup
            and (epoch + 1) % config.reorder_every == 0
            and epoch != config.epochs - 1
        ):
            t0 = time.time()
            pi, stats = reorder.update_orders(
                xn, params, pi, spec, cfg, rng, config.reorder_samples,
                predict_fn=predict,
            )
            log.reorder_stats.append(stats)
            opt_state = opt.init(params)  # paper: reinit optimizer after reorder
            log.seconds_reorder += time.time() - t0
            # the loss surface changed: restart the convergence tracker so a
            # transient post-reorder dip is not mistaken for a stall
            stall = 0
            best_fit = -np.inf

        fit = eval_fitness()
        log.fitness_history.append(fit)
        if config.verbose:
            print(f"epoch {epoch}: loss={total_loss:.5g} fitness={fit:.5f}")
        if best_snapshot is None or fit > best_snapshot[0]:
            # a copy: params updated in place later must not change it
            best_snapshot = (fit, optimizers.tree_map(torch.clone, params),
                             [p.copy() for p in pi])
        if fit > best_fit + config.tol:
            best_fit = fit
            stall = 0
        else:
            stall += 1
            if stall >= config.patience:
                break

    # return the best state seen (reorder sweeps can transiently regress)
    _, params, pi = best_snapshot
    return CompressedTensor(params, pi, spec, cfg, mean, std), log
