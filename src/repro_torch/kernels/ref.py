"""Plain PyTorch versions of the attention and SSD kernels (the
correctness contract).

Deliberately naive: full score (and SSD decay) matrices, explicit masks,
f32 throughout.  Kernel layout, as ``repro/kernels/ref.py``: q (B, H, T,
D), caches (B, KV, S, D), page pools (P, KV, page_size, D) (quantized
pools with scales (P, KV, page_size, 1)).  The dispatch in ``ops.py``
passes transposed *views* of the model-layout tensors, so nothing is
copied on the way in; the paged versions gather each slot's pages into a
dense view, the quantized ones after dequantizing the whole pool.

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


def _gather_pages(pages, page_idx):
    """Pool (P, KV, page_size, D) through page table (B, max_pages) ->
    dense (B, KV, max_pages * page_size, D); unmapped entries gather the
    null page 0 (masked by position)."""
    b, n = page_idx.shape
    _, kv, page_size, d = pages.shape
    x = pages[page_idx.long()]  # (B, max_pages, KV, page_size, D)
    return x.transpose(1, 2).reshape(b, kv, n * page_size, d)


def paged_decode_attention_ref(q, k_pages, v_pages, page_idx, pos, *,
                               active=None, window=0):
    """q (B,H,T,D); pools (P,KV,page_size,D); page_idx (B,max_pages) ->
    (B,H,T,D).  Gathers each slot's pages into a dense view and defers to
    ``decode_attention_ref``: the page indirection never changes the mask
    math.  Mirrors ``repro/kernels/ref.py`` ``paged_decode_attention_ref``.
    """
    return decode_attention_ref(q, _gather_pages(k_pages, page_idx),
                                _gather_pages(v_pages, page_idx), pos,
                                active=active, window=window)


def paged_decode_attention_splitk_ref(q, k_pages, v_pages, page_idx, pos, *,
                                      active=None, window=0, num_splits=2):
    """Two-phase paged split-K, T = 1.  Split ``i`` owns the logical pages
    ``[i * pps, (i + 1) * pps)`` of each slot's page-table row
    (``max_pages % num_splits == 0``, pps = max_pages / num_splits), so
    the splits tile whole pages; over the gathered view those are key
    ranges of ``pps * page_size``, and the combine is the dense split-K
    plain version's."""
    assert page_idx.shape[1] % num_splits == 0, (page_idx.shape, num_splits)
    return decode_attention_splitk_ref(
        q, _gather_pages(k_pages, page_idx), _gather_pages(v_pages, page_idx),
        pos, active=active, window=window, num_splits=num_splits)


def paged_prefill_attention_ref(q, k_pages, v_pages, page_row, q_offset, *,
                                window=0):
    """q (1,H,C,D): one slot's chunk at absolute ``q_offset``; pools
    (P,KV,page_size,D); page_row (max_pages,).  Row ``t`` attends keys
    ``kpos <= q_offset + t``: the decode contract with T = C and
    pos = q_offset.  Mirrors ``repro/kernels/ref.py``
    ``paged_prefill_attention_ref``."""
    return paged_decode_attention_ref(q, k_pages, v_pages, page_row[None],
                                      q_offset, window=window)


def dequantize_ref(pages, scales):
    """Per-token/per-head dequantization: pages (..., page_size, D)
    int8/fp8, scales (..., page_size, 1) f32 -> f32 values.  Mirrors
    ``repro/kernels/ref.py`` ``dequantize_ref``."""
    return pages.float() * scales


def paged_decode_attention_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                                     page_idx, pos, *, active=None,
                                     window=0):
    """The quantized paged decode: pools (P,KV,page_size,D) int8/fp8 with
    per-token scales (P,KV,page_size,1) f32.  Dequantizes the whole pool
    and defers to ``paged_decode_attention_ref``, so a kernel reading the
    same quantized values must match it within f32 rounding.  Mirrors
    ``repro/kernels/ref.py`` ``paged_decode_attention_quant_ref``."""
    return paged_decode_attention_ref(
        q, dequantize_ref(k_pages, k_scale), dequantize_ref(v_pages, v_scale),
        page_idx, pos, active=active, window=window)


def paged_decode_attention_splitk_quant_ref(q, k_pages, v_pages, k_scale,
                                            v_scale, page_idx, pos, *,
                                            active=None, window=0,
                                            num_splits=2):
    """The quantized paged split-K decode, built as
    ``paged_decode_attention_quant_ref``: the dequantized pools through
    ``paged_decode_attention_splitk_ref``."""
    return paged_decode_attention_splitk_ref(
        q, dequantize_ref(k_pages, k_scale), dequantize_ref(v_pages, v_scale),
        page_idx, pos, active=active, window=window, num_splits=num_splits)


def paged_prefill_attention_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                                      page_row, q_offset, *, window=0):
    """The quantized fused paged prefill: the dequantized pools through
    ``paged_prefill_attention_ref``."""
    return paged_prefill_attention_ref(
        q, dequantize_ref(k_pages, k_scale), dequantize_ref(v_pages, v_scale),
        page_row, q_offset, window=window)


def attention_ref(q, k, v, *, causal=True, window=0):
    """q (B,H,Sq,D); k,v (B,KV,Sk,D) -> (B,H,Sq,D): one full softmax per
    row, f32.  Query row i attends key j when ``j <= i`` (``causal``) and
    ``i - j < window`` (``window > 0``).  Mirrors ``repro/kernels/ref.py``
    ``attention_ref``, whose fully masked rows (possible only when
    Sq > Sk) average v over every key."""
    sq, sk = q.shape[2], k.shape[2]
    sc = _scores(q, k)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    vx = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def ssd_chunk_ref(x, b, c, dt, cum):
    """Mamba2 SSD within each chunk.  x (B,NC,NH,Q,hp); b,c (B,NC,G,Q,ds),
    head h reading group h // (NH // G); dt, cum (B,NC,NH,Q) f32 (the
    softplus'd step and the inclusive cumsum of dt * a) ->
    (y (B,NC,NH,Q,hp) in x's dtype, state (B,NC,NH,ds,hp) f32):

        att[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   (j <= i)
        y = att @ x;  state = (B * exp(cum_last - cum) * dt)^T @ x

    The mask selects after the exp, so the overflowing exp(cum_i - cum_j)
    of j > i never multiplies a 0.  Mirrors ``repro/kernels/ref.py``
    ``ssd_chunk_ref``."""
    rep = x.shape[2] // b.shape[2]
    q = x.shape[3]
    bx = b.repeat_interleave(rep, dim=2).float()  # (B,NC,NH,Q,ds)
    cx = c.repeat_interleave(rep, dim=2).float()
    cb = torch.einsum("bnhqs,bnhks->bnhqk", cx, bx)
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])
    att = cb * decay * dt[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    att = torch.where(mask, att, 0.0)
    xf = x.float()
    y = torch.einsum("bnhqk,bnhkp->bnhqp", att, xf).to(x.dtype)
    w = torch.exp(cum[..., -1:] - cum) * dt  # (B,NC,NH,Q)
    st = torch.einsum("bnhqs,bnhqp->bnhsp", bx * w[..., None], xf)
    return y, st
