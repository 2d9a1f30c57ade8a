"""Deterministic synthetic data pipeline.

Counter-based (Philox) generation keyed on (seed, step): any host can
materialize any step's batch without coordination or state — exactly what a
restarted/elastically-rescaled job needs (the checkpoint only stores the
step counter).  ``host_shard`` slices the global batch for a host, matching
the ``(pod, data)``-sharded in_shardings of the train step.

``MarkovSynthetic`` adds learnable sequential structure (noisy affine
next-token map) so convergence tests and the quickstart example show real
loss movement rather than ln(V) noise floor.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=[self.seed & 0xFFFFFFFFFFFFFFFF,
                                  (step << 16) ^ 0xDA7A]))

    def batch(self, step: int) -> dict:
        rng = self._rng(step)
        tokens = rng.integers(0, self.vocab_size,
                              size=(self.global_batch, self.seq_len),
                              dtype=np.int32)
        return {"tokens": tokens}


@dataclass(frozen=True)
class MarkovSynthetic(SyntheticDataset):
    """next = (a * prev + b) % V with prob (1-noise); uniform otherwise."""

    a: int = 5
    b: int = 17
    noise: float = 0.1

    def batch(self, step: int) -> dict:
        rng = self._rng(step)
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        tokens = np.empty((b, s), dtype=np.int32)
        tokens[:, 0] = rng.integers(0, v, size=b)
        flip = rng.random((b, s)) < self.noise
        rand = rng.integers(0, v, size=(b, s), dtype=np.int32)
        for t in range(1, s):
            nxt = (self.a * tokens[:, t - 1] + self.b) % v
            tokens[:, t] = np.where(flip[:, t], rand[:, t], nxt)
        return {"tokens": tokens}


def host_shard(batch: dict, host_index: int, n_hosts: int) -> dict:
    """Slice a global batch into this host's contiguous shard."""
    def slice_one(x):
        bsz = x.shape[0]
        assert bsz % n_hosts == 0, (bsz, n_hosts)
        per = bsz // n_hosts
        return x[host_index * per:(host_index + 1) * per]

    return {k: slice_one(v) for k, v in batch.items()}
