"""Deterministic synthetic token pipeline (shardable, restart-exact).

A copy of the JAX package's ``data/tokens.py`` (numpy only, so the batches
are the same arrays in both packages).

Every batch is a pure function of (seed, step, host), so data order is
reproducible across restarts and elastic re-meshes — the data-side half of
the fault-tolerance story. Token statistics are Zipf-like to keep the
softmax/embedding access patterns realistic.

``PsiWeightedSampler`` is the paper-technique integration (DESIGN.md §5):
documents are attributed to synthetic users and sampled ∝ ψ-score, i.e.
training data is curated by user influence.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline", "PsiWeightedSampler"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        raw = rng.zipf(self.zipf_a, (self.global_batch, self.seq_len + 1))
        toks = (raw - 1) % self.vocab
        return dict(tokens=toks[:, :-1].astype(np.int32),
                    labels=toks[:, 1:].astype(np.int32))

    def host_batch(self, step: int, host: int, n_hosts: int
                   ) -> dict[str, np.ndarray]:
        full = self.batch(step)
        per = self.global_batch // n_hosts
        sl = slice(host * per, (host + 1) * per)
        return {k: v[sl] for k, v in full.items()}


class PsiWeightedSampler:
    """Sample document owners ∝ ψ-score (influence-curated data mixing)."""

    def __init__(self, psi: np.ndarray, *, temperature: float = 1.0,
                 seed: int = 0):
        w = np.asarray(psi, np.float64) ** (1.0 / max(temperature, 1e-6))
        self._p = w / w.sum()
        self._rng = np.random.default_rng(seed)

    def sample_users(self, k: int) -> np.ndarray:
        return self._rng.choice(self._p.shape[0], size=k, p=self._p)

    def mixture_stats(self, k: int = 10_000) -> dict:
        users = self.sample_users(k)
        uniq = np.unique(users).size
        return dict(unique_users=int(uniq),
                    top1_share=float(np.bincount(users).max() / k))
