"""Plain PyTorch versions of the decode kernels (the correctness contract).

Deliberately naive: full score matrices, explicit masks, f32 throughout.
Kernel layout, as ``repro/kernels/ref.py``: q (B, H, T, D), caches
(B, KV, S, D).  The dispatch in ``ops.py`` passes transposed *views* of the
model-layout tensors, so nothing is copied.

``active`` (B,) 0/1 gates each slot (default ``pos >= 0``); an inactive
slot returns zeros, as the kernels write them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _prep(q, pos, active):
    b, t = q.shape[0], q.shape[2]
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).long().expand(b)
    if active is None:
        active = pos >= 0
    else:
        active = torch.as_tensor(active, device=q.device).reshape(-1)
        active = active.expand(b) != 0
    qpos = pos[:, None] + torch.arange(t, device=q.device)[None, :]  # (B,T)
    return pos, active, qpos


def _mask(qpos, s, window, device):
    kpos = torch.arange(s, device=device)
    mask = kpos[None, None, :] <= qpos[:, :, None]  # (B, T, S)
    if window:
        mask &= qpos[:, :, None] - kpos[None, None, :] < window
    return mask


def _scores(q, k_cache):
    """(B,H,T,S) f32 scores, scale applied after the dot."""
    h, kv = q.shape[1], k_cache.shape[1]
    kx = k_cache.repeat_interleave(h // kv, dim=1).float()
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * q.shape[-1] ** -0.5


def decode_attention_ref(q, k_cache, v_cache, pos, *, active=None, window=0):
    """q (B,H,T,D); caches (B,KV,S,D) -> (B,H,T,D).

    Row ``t`` of slot ``b`` sits at absolute position ``pos[b] + t`` and
    attends keys ``kpos <= pos[b] + t`` (and ``pos[b] + t - kpos < window``
    when ``window > 0``).  Mirrors ``repro/kernels/ref.py``
    ``decode_attention_ref``.
    """
    h, kv, s = q.shape[1], k_cache.shape[1], k_cache.shape[2]
    pos, active, qpos = _prep(q, pos, active)
    sc = _scores(q, k_cache)
    mask = _mask(qpos, s, window, q.device)[:, None]  # (B,1,T,S)
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    vx = v_cache.repeat_interleave(h // kv, dim=1).float()
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx)
    out = torch.where(active[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


def decode_attention_splitk_ref(q, k_cache, v_cache, pos, *, active=None,
                                window=0, num_splits=2):
    """Two-phase plain version of the split-K decode, T = 1.

    Phase 1: for each of ``num_splits`` disjoint key ranges an
    unnormalised ``(acc, m, l)``; an empty range keeps m = -1e30, l = 0.
    Phase 2: combine with ``exp(m_i - m*)`` and divide by
    ``max(sum l_i exp(m_i - m*), 1e-30)``.
    """
    b, h, t, d = q.shape
    s = k_cache.shape[2]
    kv = k_cache.shape[1]
    assert t == 1, "split-K decode is single-token"
    ns = num_splits
    assert s % ns == 0, (s, ns)
    pos, active, qpos = _prep(q, pos, active)
    sc = _scores(q, k_cache)[:, :, 0].reshape(b, h, ns, s // ns)
    mask = _mask(qpos, s, window, q.device)[:, 0].reshape(b, 1, ns, s // ns)
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(dim=-1)  # (B,H,ns)
    p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)  # (B,H,ns)
    vx = v_cache.repeat_interleave(h // kv, dim=1).float().reshape(
        b, h, ns, s // ns, d)
    acc = torch.einsum("bhnk,bhnkd->bhnd", p, vx)  # (B,H,ns,D)
    # combine
    m_star = m.amax(dim=-1, keepdim=True)
    alpha = torch.exp(m - m_star)  # empty splits: exp(-1e30 - m*) == 0
    denom = torch.clamp((l * alpha).sum(dim=-1, keepdim=True), min=1e-30)
    out = (acc * alpha[..., None]).sum(dim=2) / denom  # (B,H,D)
    out = torch.where(active[:, None, None], out, 0.0)
    return out[:, :, None].to(q.dtype)
