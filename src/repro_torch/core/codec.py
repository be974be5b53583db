"""The decode half of TensorCodec's compressed payload, as in
``repro.core.codec``: ``CompressedTensor`` and the §V-A size accounting.
Fitting (``CodecConfig``, ``compress``) comes with the fitting slice.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import nttd
from repro_torch.core.folding import FoldingSpec


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
