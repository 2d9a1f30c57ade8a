"""Per-request sampling controls, greedy subset.

The PyTorch port's counterpart of ``repro/runtime/sampling.py``:
``SamplingParams``, ``matches_stop`` and ``key_data``.  Sampled decoding
(``temperature > 0``: top-k / top-p and the threefry draw) comes in a later
slice; the serving engine rejects such requests.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls.

    * ``temperature`` — 0 (default) decodes greedily; > 0 samples.
    * ``top_k`` — keep only the k most likely tokens (0 = off).
    * ``top_p`` — nucleus sampling threshold (1.0 = off).
    * ``seed`` — per-request PRNG seed; ``None`` derives one from the
      request id.
    * ``stop`` — stop sequences: token ids or sequences of token ids.
      Generation finishes the step the output ends with one of them;
      matched tokens stay in the output.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop: Tuple = ()

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0: {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @functools.cached_property
    def stop_sequences(self) -> Tuple[Tuple[int, ...], ...]:
        """``stop`` normalized to tuples of ints (bare ids become 1-grams)."""
        out = []
        for s in self.stop:
            if isinstance(s, (int, np.integer)):
                out.append((int(s),))
            else:
                seq = tuple(int(t) for t in s)
                if seq:
                    out.append(seq)
        return tuple(out)

    def key_data(self, req_id: int) -> np.ndarray:
        """Raw (2,) uint32 PRNG key for this request (seed or req_id): the
        value ``jax.random.PRNGKey(s)`` holds, which for 0 <= s < 2**31 is
        [0, s] (high word, low word)."""
        seed = self.seed if self.seed is not None else req_id
        return np.array([0, seed % (2 ** 31)], np.uint32)


def matches_stop(output: Sequence[int], params: SamplingParams,
                 eos_id: int = -1) -> Optional[str]:
    """Host-side stop check: the finish reason the tail of ``output``
    triggers ("eos" / "stop"), or None."""
    n = len(output)
    if not n:
        return None
    if eos_id >= 0 and output[-1] == eos_id:
        return "eos"
    for seq in params.stop_sequences:
        k = len(seq)
        if k <= n and tuple(output[n - k:]) == seq:
            return "stop"
    return None
