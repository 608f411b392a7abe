"""Deterministic synthetic token pipeline.

Port of ``repro/data/tokens.py`` (numpy code, copied so that the port
imports nothing of the reference): the same batches, bit for bit.

Every batch is a pure function of ``(seed, step)`` -- the property that
makes checkpoint/restart *exact*: resuming at step k regenerates the same
batch k that the failed run would have consumed.

The synthetic distribution is a Zipfian unigram mixed with a repeated-
n-gram process so that a small LM actually has something learnable.
Per-host sharding: each data-parallel host draws only its slice, keyed by
``(seed, step, shard)`` -- no cross-host I/O.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_repeat_p: float = 0.3     # P(copy an earlier window)
    n_shards: int = 1
    shard: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.n_shards} shards")
        return self.global_batch // self.n_shards


class TokenPipeline:
    """``batch(step) -> (tokens, labels)`` -- stateless, deterministic,
    int32 numpy arrays of (local_batch, seq_len)."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        # Zipf unigram table (static, seed-independent shape)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(probs / probs.sum())

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.shard]))

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        b, s = cfg.local_batch, cfg.seq_len
        u = rng.random((b, s + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.minimum(toks, cfg.vocab - 1)
        # repeated n-grams: with prob p, copy a window from earlier in-row
        n_rep = max(1, int(cfg.ngram_repeat_p * b))
        for i in rng.choice(b, size=n_rep, replace=False):
            w = int(rng.integers(8, 64))
            if s + 1 > 2 * w:
                src = int(rng.integers(0, s + 1 - 2 * w))
                dst = int(rng.integers(src + w, s + 1 - w))
                toks[i, dst:dst + w] = toks[i, src:src + w]
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def feature_batch(cfg: TokenPipelineConfig, step: int, d_model: int,
                  dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Stub modality frontend (hubert audio frames / vision patches):
    deterministic Gaussian frame embeddings + integer targets."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard, 7]))
    b, s = cfg.local_batch, cfg.seq_len
    feats = rng.standard_normal((b, s, d_model)).astype(dtype)
    labels = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    return feats, labels
