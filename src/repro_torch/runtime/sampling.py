"""Per-request sampling: temperature / top-k / top-p with per-slot PRNG
keys.

The PyTorch port's counterpart of ``repro/runtime/sampling.py``.  The
sampling parameters ride along as per-slot arrays (``temp[B]``,
``top_k[B]``, ``top_p[B]``, ``keys[B, 2]``), so one step serves every mix
of greedy and sampled requests.  A request's key is derived from its seed
once and folded with the decode position each step, so a seeded request
draws the same tokens whichever slot it lands in.

The draw is the reference's, rebuilt in torch integer ops: jax's
threefry2x32 (20 rounds), ``fold_in``, the partitionable ``random_bits``
(jax 0.9 with ``jax_threefry_partitionable``), the uniform in
[tiny, 1) and the Gumbel-argmax ``categorical`` in mode "low".  The
uint32 words are carried in int64 and masked to 32 bits after every add
and shift (torch's uint32 lacks most arithmetic).  The raw bits and the
uniforms are bitwise jax's; ``log`` is not (XLA's and torch's differ in
the last bit), so the Gumbel noise agrees to ~5e-7 and a sampled token
agrees unless two perturbed scores lie within a few ulp.  The top-p
cumsum sums in torch's order, so a row whose mass at the boundary lies
within ~1e-6 of ``top_p`` may keep one token more or fewer.

``temperature <= 0`` is the greedy contract: the token is the raw f32
``argmax`` of the logits, bitwise the greedy path.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


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


# ------------------------------------------------------------- threefry
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """jax's threefry2x32 hash of the counter words (x1, x2) under the key
    words (k1, k2): int64 tensors holding uint32 values, broadcast
    together.  Returns the two output words, int64 in [0, 2**32)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def as_key_words(keys, device=None) -> torch.Tensor:
    """(..., 2) uint32 key data (numpy or a tensor) -> int64 tensor."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64) & _M32
    return torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                           device=device)


def fold_in(keys, data):
    """``jax.random.fold_in`` of raw keys (..., 2) int64 with uint32 data
    (...,): the hash of the counter ``threefry_seed(data)`` = (0, data)."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M32
    w1, w2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([w1, w2], dim=-1)


def random_bits(keys, v: int):
    """Partitionable 32-bit ``random_bits`` of shape (v,) for each key
    (..., 2) int64: the counters are the flat index's high and low words,
    the bits the two output words xor'd.  Returns (..., v) int64."""
    lo = torch.arange(v, dtype=torch.int64, device=keys.device)
    w1, w2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(lo), lo)
    return w1 ^ w2


def uniform(keys, v: int):
    """``jax.random.uniform(key, (v,), minval=tiny, maxval=1.)`` per key,
    f32 (..., v): 23 random mantissa bits under the exponent of 1, minus 1,
    scaled, clamped below by ``tiny``."""
    bits = (random_bits(keys, v) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_TINY, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys, v: int):
    """Gumbel noise in mode "low": ``-log(-log(u))`` on ``uniform``."""
    return -torch.log(-torch.log(uniform(keys, v)))


def categorical(keys, logits):
    """The Gumbel-max draw of ``jax.random.categorical``: the first index
    of the max of ``gumbel + logits`` per row; logits (..., V) f32."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


# -------------------------------------------------------------- sampling
def _topk_topp_mask(scaled, top_k, top_p):
    """Additive mask (0 keep / -inf drop) for per-row top-k + top-p.

    Both filters apply in the sorted domain of one stable argsort (as
    ``jnp.argsort``), then scatter back through the permutation; the best
    token is always kept.  The softmax is the reference's formula
    (``exp(x - max) / sum``) in f32."""
    v = scaled.shape[-1]
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    srt = torch.gather(scaled, -1, sort_idx)
    unnorm = torch.exp(srt - srt[:, :1])
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    ranks = torch.arange(v, device=scaled.device)[None, :]
    keep = torch.where(top_k[:, None] > 0, ranks < top_k[:, None], True)
    # exclusive cumulative mass below top_p keeps the crossing token too
    keep = keep & ((cum - probs) < top_p[:, None])
    keep[:, 0] = True
    mask_sorted = torch.where(keep, 0.0, float("-inf")).to(scaled.dtype)
    return torch.empty_like(scaled).scatter_(-1, sort_idx, mask_sorted)


def _rows(x, device, dtype):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype).reshape(-1)


def sample_tokens(logits, pos, temp, top_k, top_p, keys):
    """Sample (or greedily pick) one token per row.

    logits (B, V) f32; pos (B,) (folded into each row's key, clamped at 0);
    temp (B,) f32; top_k (B,) int (0 = off); top_p (B,) f32 (1 = off);
    keys (B, 2) uint32 key data (numpy, or a tensor of its values).  The
    per-row arrays may be numpy or tensors; they move to the logits'
    device.  Rows with ``temp <= 0`` return the raw-logit argmax, bitwise
    the greedy path.  Returns (B,) int32 on the logits' device."""
    dev = logits.device
    temp = _rows(temp, dev, torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.clamp(temp, min=1e-6)[:, None]
    scaled = (logits / safe_t).float()
    masked = scaled + _topk_topp_mask(scaled, _rows(top_k, dev, torch.int64),
                                      _rows(top_p, dev, torch.float32))
    folded = fold_in(as_key_words(keys, dev).reshape(-1, 2),
                     torch.clamp(_rows(pos, dev, torch.int64), min=0))
    sampled = categorical(folded, masked)
    return torch.where(temp > 0, sampled, greedy).to(torch.int32)


def sample_tokens_multi(logits, pos, temp, top_k, top_p, keys):
    """Per-row target draws for a speculative verify block.

    logits (B, T, V) f32, row ``t`` of slot ``b`` the target's
    distribution at absolute position ``pos[b] + t``; the other arrays
    are per slot, shared by the slot's rows.  Each row folds its own
    absolute position into the slot's key, the fold the plain step makes
    at that position, so an accepted draw is bitwise the token the plain
    engine samples there.  Returns (B, T) int32."""
    b, t, v = logits.shape
    dev = logits.device
    pos = _rows(pos, dev, torch.int64)
    pos_rows = (pos[:, None] + torch.arange(t, device=dev)[None, :])
    rep = lambda x, dt: _rows(x, dev, dt).repeat_interleave(t, dim=0)
    keys = as_key_words(keys, dev).reshape(-1, 2).repeat_interleave(t, dim=0)
    out = sample_tokens(logits.reshape(b * t, v), pos_rows.reshape(-1),
                        rep(temp, torch.float32), rep(top_k, torch.int64),
                        rep(top_p, torch.float32), keys)
    return out.reshape(b, t)


def speculative_accept(draft, target) -> int:
    """The number of draft tokens the verify pass confirms: draft token
    ``t`` survives iff every earlier one did and ``draft[t] ==
    target[t]``; the engine then emits ``target[:m + 1]``, the accepted
    drafts plus the correction token, which is what plain decode would
    have produced token by token."""
    m = 0
    for d, t in zip(draft, target):
        if int(d) != int(t):
            break
        m += 1
    return m
