"""Attention, dense subset: GQA projections, blocked chunked-prefill
attention, the plain decode attention and the dense cache writes.

The PyTorch counterpart of ``repro/models/attention.py``.  Weights keep
the head-explicit layout wq (dm, H, hd), wk/wv (dm, KV, hd), wo (H, hd, dm).
Caches are (B, S, KV, D) and are written IN PLACE: the reference's buffer
donation becomes a row write into the caller's tensor, so a decode tick
never rebuilds or copies a cache.
"""
from __future__ import annotations

import torch

from .layers import _init, apply_rope

NEG_INF = -1e30


# ------------------------------------------------------------------ params
def attention_init(gen, *, d_model, num_heads, num_kv_heads, head_dim,
                   qkv_bias, dtype=torch.float32, device="cpu"):
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": _init(gen, (d_model, num_heads, head_dim), **kw),
        "wk": _init(gen, (d_model, num_kv_heads, head_dim), **kw),
        "wv": _init(gen, (d_model, num_kv_heads, head_dim), **kw),
        "wo": _init(gen, (num_heads, head_dim, d_model), **kw),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((num_heads, head_dim), **kw)
        p["bk"] = torch.zeros((num_kv_heads, head_dim), **kw)
        p["bv"] = torch.zeros((num_kv_heads, head_dim), **kw)
    return p


def qkv_project(params, x, positions, rope_theta):
    """x (B,S,dm) -> q (B,S,H,hd), k,v (B,S,KV,hd) with RoPE applied."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attn_output(params, ctx):
    return torch.einsum("bshk,hkd->bsd", ctx, params["wo"])


# ------------------------------------------------------- grouped attention
def _grouped_scores(q, k):
    """q (B,bq,KV,G,D), k (B,Sk,KV,D) -> scores (B,KV,G,bq,Sk) fp32."""
    scale = q.shape[-1] ** -0.5
    return torch.einsum("bqhgd,bshd->bhgqs", q, k).float() * scale


def _grouped_context(probs, v):
    """probs (B,KV,G,bq,Sk) fp32, v (B,Sk,KV,D) -> (B,bq,KV,G,D).  The
    probabilities are cast to v's dtype before the product (as the
    reference), which matters with a bf16 cache."""
    return torch.einsum("bhgqs,bshd->bqhgd", probs.to(v.dtype), v)


def flash_attention_xla(q, k, v, *, causal=True, window=0, q_chunk=512,
                        q_offset=0):
    """Blocked attention.  q (B,Sq,H,D); k,v (B,Sk,KV,D); GQA-aware.

    Loops over query chunks with a transient (B, KV, G, q_chunk, span)
    score tile.  ``window > 0`` reads only the (window + q_chunk)-long KV
    slice a chunk can see.  ``q_offset`` is the absolute position of the
    first query (chunked prefill).  Plain tensor ops: the reference runs
    no kernel here either.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    q_chunk = min(q_chunk, sq)
    assert sq % q_chunk == 0, (sq, q_chunk)
    kv_span = min(sk, window + q_chunk) if window else sk
    outs = []
    for idx in range(sq // q_chunk):
        qc = q[:, idx * q_chunk:(idx + 1) * q_chunk].reshape(
            b, q_chunk, kv, g, d)
        qs = idx * q_chunk + int(q_offset)
        qpos = qs + torch.arange(q_chunk, device=q.device)
        if window and kv_span < sk:
            start = min(max(qs + q_chunk - kv_span, 0), sk - kv_span)
            kc, vc = k[:, start:start + kv_span], v[:, start:start + kv_span]
            kpos = start + torch.arange(kv_span, device=q.device)
        else:
            kc, vc, kpos = k, v, torch.arange(sk, device=q.device)
        scores = _grouped_scores(qc, kc)  # (B,KV,G,bq,span)
        mask = torch.ones((q_chunk, kpos.shape[0]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        outs.append(_grouped_context(probs, vc))  # (B,bq,KV,G,D)
    return torch.cat(outs, dim=1).reshape(b, sq, h, d)


def _pos_vector(pos, b, device):
    """Scalar or (B,) position -> (B,) int64 tensor on ``device``."""
    pos = torch.as_tensor(pos, device=device).reshape(-1).long()
    return pos.expand(b)


def decode_attention_xla(q, k_cache, v_cache, pos, *, window=0):
    """Decode-time attention over the whole cache.  q (B,T,H,D); caches
    (B,S,KV,D); ``pos`` scalar or (B,).  Query row ``t`` of slot ``b``
    attends keys ``kpos <= pos[b] + t``; slots with pos < 0 return zeros.
    """
    b, t, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    pos = _pos_vector(pos, b, q.device)
    qpos = pos[:, None] + torch.arange(t, device=q.device)[None, :]  # (B,T)
    scores = _grouped_scores(q.reshape(b, t, kv, g, d), k_cache)
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]  # (B, T, S)
    if window:
        mask &= qpos[:, :, None] - kpos[None, None, :] < window
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _grouped_context(probs, v_cache)  # (B,T,KV,G,D)
    out = torch.where((pos >= 0)[:, None, None, None, None], out, 0.0)
    return out.reshape(b, t, h, d).to(q.dtype)


# ------------------------------------------------------------ cache writes
def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Write (B,1,KV,D) rows at ``pos`` of (B,S,KV,D) caches, in place.

    ``pos`` scalar writes every slot at one position; (B,) writes each slot
    at its own.  Out-of-range positions CLAMP to [0, S-1], as JAX's
    ``dynamic_update_slice`` does: an inactive slot (pos = -1) writes row 0,
    never row S-1 as a torch ``[-1]`` index would.
    """
    b, s = k_cache.shape[0], k_cache.shape[1]
    rows = _pos_vector(pos, b, k_cache.device).clamp(0, s - 1)
    bidx = torch.arange(b, device=k_cache.device)
    k_cache[bidx, rows] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, rows] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def cache_update_multi(k_cache, v_cache, k_new, v_new, pos):
    """Write a (B,T,KV,D) block at rows ``pos[b] + t``, in place; each row
    clips to [0, S-1] individually (as the reference)."""
    t = k_new.shape[1]
    b, s = k_cache.shape[0], k_cache.shape[1]
    pos = _pos_vector(pos, b, k_cache.device)
    rows = (pos[:, None] + torch.arange(t, device=k_cache.device)[None, :]
            ).clamp(0, s - 1)
    bidx = torch.arange(b, device=k_cache.device)[:, None]
    k_cache[bidx, rows] = k_new.to(k_cache.dtype)
    v_cache[bidx, rows] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def prefill_chunk_update(k_cache, v_cache, k_new, v_new, slot, offset):
    """Write one slot's (1,C,KV,D) chunk at rows offset..offset+C-1, in
    place.  The start clamps so the block fits, as the reference's
    ``dynamic_update_slice`` does."""
    c, s = k_new.shape[1], k_cache.shape[1]
    start = min(max(int(offset), 0), s - c)
    k_cache[slot, start:start + c] = k_new[0].to(k_cache.dtype)
    v_cache[slot, start:start + c] = v_new[0].to(v_cache.dtype)
    return k_cache, v_cache
