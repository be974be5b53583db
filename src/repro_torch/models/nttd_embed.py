"""NTTD-compressed embedding layer, as in ``repro.models.nttd_embed``.

Stores NTTD parameters instead of the full [vocab, d] table and
reconstructs only the looked-up rows: token id i -> its row in the
reordered tensor -> the folded indices of all d columns -> the chain
products.  ``fit`` compresses a trained table through the port's
``core.codec.compress`` (on the card: the training kernels), and
``lookup`` decodes through ``nttd.apply_at_positions`` with the payload's
cached operands, which on the card is one launch of the fused decode
kernel per call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import codec as codec_lib


@dataclasses.dataclass
class NTTDEmbedding:
    """Frozen compressed embedding (built offline from a trained table)."""

    ct: codec_lib.CompressedTensor
    vocab: int
    d_model: int

    @classmethod
    def fit(cls, table: np.ndarray, rank: int = 8, hidden: int = 16,
            epochs: int = 150, seed: int = 0, lr: float = 2e-2,
            batch_size: int = 2048, reorder: bool = True,
            device=None) -> "NTTDEmbedding":
        """The reference's fit; runs on ``device`` (CUDA unless given)."""
        # reordering matters here: embedding rows have cluster structure but
        # arbitrary ids — exactly the paper's argument for pi
        ct, _ = codec_lib.compress(
            np.asarray(table, np.float32),
            codec_lib.CodecConfig(
                rank=rank, hidden=hidden, epochs=epochs, seed=seed, lr=lr,
                batch_size=min(batch_size, table.size),
                entries_per_epoch=min(table.size, 4_000_000),
                init_reorder=reorder, update_reorder=reorder,
                # space out pi sweeps: each one reinitializes Adam (paper
                # Alg. 1), so theta needs room to converge in between
                reorder_every=10, reorder_warmup=30,
                patience=40,
            ),
            device=device,
        )
        return cls(ct=ct, vocab=table.shape[0], d_model=table.shape[1])

    def lookup(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids [B, S] -> embeddings [B, S, d] (reconstructed), on the
        payload's device."""
        device = self.ct.device
        b, s = token_ids.shape
        flat = torch.as_tensor(token_ids, device=device).reshape(-1).long()
        # positions in the reordered tensor
        inv_rows, inv_cols = (torch.as_tensor(p, dtype=torch.int64, device=device)
                              for p in self.ct.inv_pi)
        rows = inv_rows[flat]                                            # [B*S]
        cols = inv_cols[torch.arange(self.d_model, device=device)]       # [d]
        pos = torch.stack([rows.repeat_interleave(self.d_model),
                           cols.repeat(flat.shape[0])], dim=1)
        vals = self.ct._predict(self.ct.params, pos)
        vals = vals * self.ct.norm_std + self.ct.norm_mean
        return vals.reshape(b, s, self.d_model)

    def payload_bytes(self) -> int:
        return self.ct.payload_bytes(4)

    def raw_bytes(self) -> int:
        return self.vocab * self.d_model * 4
