"""Deterministic, rank-sharded token pipeline: a NumPy copy of
``repro.data.pipeline`` (which imports no JAX either; the port keeps its
own copy so that it imports nothing of the JAX package).  The batches are
the reference's bit for bit for every ``(seed, rank, world, step)``.

Two sources:
  * ``SyntheticSource`` — seeded on-the-fly token streams (tests, smoke
    training, dry-runs); Zipfian unigram mix with injected n-gram structure
    so the loss actually decreases.
  * ``MMapSource`` — memory-mapped binary token file (production path;
    ``write_corpus`` builds one).

Determinism contract (straggler/elasticity story): ``batch_at(step)`` is a
pure function of (seed, rank, world, step) — a restarted or replacement
worker resumes mid-run by just asking for the right step, and a backup
worker can shadow a straggler without coordination.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int           # per-rank sequences per step
    seq_len: int
    vocab: int
    seed: int = 0
    rank: int = 0
    world: int = 1


class SyntheticSource:
    """Zipf unigrams + planted bigram transitions (learnable structure)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks**1.2)
        self.unigram /= self.unigram.sum()
        # each token has a preferred successor (cyclic shift by a fixed map)
        self.successor = rng.permutation(v)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 131 + cfg.rank * 7 + 13
        )
        b, s = cfg.batch_size, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(b, s), p=self.unigram).astype(np.int32)
        # 60% of positions follow the planted bigram map (structure to learn)
        follow = rng.random((b, s - 1)) < 0.6
        nxt = self.successor[toks[:, :-1]]
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = 0
        return {"tokens": toks, "labels": labels}


class MMapSource:
    """Flat binary int32 token file, rank-strided sampling."""

    def __init__(self, path: str, cfg: PipelineConfig):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
        # all ranks draw from the same permutation stream, then take their
        # disjoint stripe — changing `world` reshuffles cleanly (elastic)
        idx = rng.integers(0, self.n_windows, size=cfg.batch_size * cfg.world)
        idx = idx[cfg.rank :: cfg.world][: cfg.batch_size]
        toks = np.stack(
            [self.data[i * cfg.seq_len : i * cfg.seq_len + cfg.seq_len] for i in idx]
        ).astype(np.int32)
        labels = np.stack(
            [
                self.data[i * cfg.seq_len + 1 : i * cfg.seq_len + cfg.seq_len + 1]
                for i in idx
            ]
        ).astype(np.int32)
        return {"tokens": toks, "labels": labels}


def write_corpus(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, dtype=np.int32).tofile(path)
