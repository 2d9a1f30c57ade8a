"""Attention: GQA projections, blocked chunked-prefill attention, the
plain decode attention (dense and paged) and the cache writes (dense
stripes and the paged pool).

The PyTorch counterpart of ``repro/models/attention.py``.  Weights keep
the head-explicit layout wq (dm, H, hd), wk/wv (dm, KV, hd), wo
(H, hd, dm).  Dense caches are (B, S, KV, D); paged pools are
(P, page_size, KV, D) shared by every slot, addressed through an int32
page table (slots, max_pages) whose unmapped entries are the null page 0.
Both are written IN PLACE: the reference's buffer donation becomes a row
write into the caller's tensor, so a decode tick never rebuilds or copies
a cache.

Quantized pools (int8 or fp8 e4m3) hold K/V rows quantized per token and
KV head, with f32 scale pools (P, page_size, KV, 1) beside them, written
through the same page table (``quantize_kv``, ``*_quant``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .layers import _init, apply_rope, remat

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


def _promoted(*xs):
    """``xs`` cast to their promoted dtype, as ``jnp.einsum`` promotes its
    operands (f32 with bf16 is f32); a no-op when they already agree."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return [x.to(dt) for x in xs]


def attn_output(params, ctx):
    """ctx (B,S,H,hd) -> (B,S,dm); a bf16 ctx (the chunked prefill over a
    bf16 cache) is promoted to the weights' dtype, as the reference's
    einsum promotes it."""
    return torch.einsum("bshk,hkd->bsd", *_promoted(ctx, params["wo"]))


# ------------------------------------------------------- grouped attention
def _grouped_scores(q, k):
    """q (B,bq,KV,G,D), k (B,Sk,KV,D) -> scores (B,KV,G,bq,Sk) fp32.  An
    f32 q against a bf16 cache multiplies in f32 (the reference's einsum
    promotes the operands)."""
    scale = q.shape[-1] ** -0.5
    return torch.einsum("bqhgd,bshd->bhgqs", *_promoted(q, k)).float() * scale


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
    no kernel here either.  Under autograd each chunk is rematerialized
    (``remat``, the reference's nested ``jax.checkpoint``): the backward
    then keeps no chunk's f32 probabilities, which together are the whole
    (Sq, Sk) attention matrix.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    q_chunk = min(q_chunk, sq)
    assert sq % q_chunk == 0, (sq, q_chunk)
    kv_span = min(sk, window + q_chunk) if window else sk

    def body(qc, kc, vc, qpos, kpos):
        scores = _grouped_scores(qc, kc)  # (B,KV,G,bq,span)
        mask = torch.ones((q_chunk, kpos.shape[0]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        return _grouped_context(probs, vc)  # (B,bq,KV,G,D)

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
        outs.append(remat(body, qc, kc, vc, qpos, kpos))
    return torch.cat(outs, dim=1).reshape(b, sq, h, d)


def _host_values(pos):
    """``pos`` as a numpy array when it is host data (numpy, a number, a
    CPU tensor), else None: reading a device tensor would sync."""
    if isinstance(pos, torch.Tensor):
        return pos.numpy() if pos.device.type == "cpu" else None
    return np.asarray(pos)


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
def cache_write_index(pos, b, s, t=1, device="cpu"):
    """Where a (B,T,KV,D) block at ``pos`` (scalar or (B,)) lands in
    (B,S,KV,D) caches: (batch index (B,1), rows (B,T)).  It depends on
    ``pos`` only, so a decode step computes it once for every layer.

    T = 1 follows the reference's ``cache_update`` under jax 0.9, whose
    ``dynamic_update_slice`` takes a negative start index from the end: a
    position in [-S, -1] writes row S + pos (a parked slot at pos -1 writes
    row S-1), anything lower row 0, and a position past the end row S-1.
    The reference's own docstring says negative positions clamp to row 0;
    its behaviour is what the port matches.  A parked slot's row S-1 is
    written again before any read: a slot at pos S-1 writes that row before
    it attends it, and the engine finishes a slot at ``max_len - 1``.
    T > 1 follows ``cache_update_multi``: each row ``pos[b] + t`` clips to
    [0, S-1] on its own."""
    pos = _pos_vector(pos, b, device)
    if t == 1:
        rows = torch.where(pos < 0, pos + s, pos)[:, None]
    else:
        rows = pos[:, None] + torch.arange(t, device=device)[None, :]
    return torch.arange(b, device=device)[:, None], rows.clamp(0, s - 1)


def write_cache_rows(k_cache, v_cache, k_new, v_new, index):
    """Write a (B,T,KV,D) block at ``index`` (``cache_write_index``), in
    place."""
    bidx, rows = index
    k_cache[bidx, rows] = k_new.to(k_cache.dtype)
    v_cache[bidx, rows] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Write (B,1,KV,D) rows at ``pos`` (scalar: every slot at one
    position; (B,): each slot at its own) of (B,S,KV,D) caches, in place;
    out-of-range positions as ``cache_write_index`` says (pos -1 writes row
    S-1, as the reference does)."""
    b, s = k_cache.shape[0], k_cache.shape[1]
    index = cache_write_index(pos, b, s, 1, k_cache.device)
    return write_cache_rows(k_cache, v_cache, k_new, v_new, index)


def cache_update_multi(k_cache, v_cache, k_new, v_new, pos):
    """Write a (B,T,KV,D) block at rows ``pos[b] + t``, in place; each row
    clips to [0, S-1] individually (as the reference)."""
    b, s = k_cache.shape[0], k_cache.shape[1]
    index = cache_write_index(pos, b, s, k_new.shape[1], k_cache.device)
    return write_cache_rows(k_cache, v_cache, k_new, v_new, index)


def prefill_chunk_update(k_cache, v_cache, k_new, v_new, slot, offset):
    """Write one slot's (1,C,KV,D) chunk at rows offset..offset+C-1, in
    place.  The start clamps so the block fits, as the reference's
    ``dynamic_update_slice`` does."""
    c, s = k_new.shape[1], k_cache.shape[1]
    start = min(max(int(offset), 0), s - c)
    k_cache[slot, start:start + c] = k_new[0].to(k_cache.dtype)
    v_cache[slot, start:start + c] = v_new[0].to(v_cache.dtype)
    return k_cache, v_cache


# ------------------------------------------------------------- paged pool
def paged_write_index(pos, page_idx, page_size, t=1):
    """Where a (B,T,KV,D) block at logical ``pos[b] + t`` lands in the
    pools through the page table (B, max_pages): (page (B,T), offset (B,T),
    drop).  It depends on ``pos`` and the table only, so a decode step
    computes it once for every layer.

    Slot ``b`` writes page ``page_idx[b, p // page_size]`` at offset
    ``p % page_size``.  A parked slot (pos < 0) writes the null page 0 --
    computed explicitly, never through a torch ``[-1]`` index, which would
    hit the slot's last mapped page.  Positions past the table's span: for
    T > 1 they go to the null page (the reference's
    ``paged_cache_update_multi``, so padding never touches a page the slot
    does not hold) and ``drop`` is None; for T = 1 the write is dropped, as
    the reference's ``paged_cache_update`` drops it (its out-of-bounds
    table read makes the scatter skip the row).  When ``pos`` is host data
    (numpy, an int, a CPU tensor) and no row is past the span, ``drop`` is
    None.  Otherwise, without a host sync, ``drop = (src, live)`` makes a
    dropped row repeat the first kept row's write (same page, offset and
    value, so the duplicate is harmless); when no row is kept, every row
    rewrites page 0 offset 0 with what it holds."""
    b, device = page_idx.shape[0], page_idx.device
    max_len = page_idx.shape[1] * page_size
    host = _host_values(pos)
    pos = _pos_vector(pos, b, device)[:, None]
    pos_t = pos + torch.arange(t, device=device)[None, :]
    posc = pos_t.clamp(0, max_len - 1)
    page = torch.gather(page_idx.long(), 1, posc // page_size)
    page = torch.where((pos >= 0) & (pos_t < max_len), page, 0)
    off = posc % page_size
    if t > 1 or (host is not None and bool((host < max_len).all())):
        return page, off, None
    # row b takes row src[b]'s write: itself if kept, else the first kept
    # row (argmax of a bool is its first True; 0 when there is none)
    keep = pos[:, 0] < max_len
    src = torch.where(keep, torch.arange(b, device=device),
                      keep.int().argmax())
    live = keep[src][:, None]
    return (torch.where(live, page[src], 0), torch.where(live, off[src], 0),
            (src, live))


def _raw(pages, new):
    """A 1-byte pool and its rows as uint8 views (the same bytes), so that
    an fp8 pool is indexed and selected as plain bytes on any device."""
    if pages.element_size() == 1:
        return pages.view(torch.uint8), new.view(torch.uint8)
    return pages, new


def write_paged_rows(k_pages, v_pages, k_new, v_new, index):
    """Write a (B,T,KV,D) block at ``index`` (``paged_write_index``) of the
    (P,page_size,KV,D) pools, in place."""
    page, off, drop = index
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        pages, new = _raw(pages, new.to(pages.dtype))
        if drop is not None:
            src, live = drop
            new = torch.where(live[:, :, None, None], new[src], pages[0, 0])
        pages[page, off] = new
    return k_pages, v_pages


def paged_cache_update(k_pages, v_pages, k_new, v_new, pos, page_idx,
                       page_size):
    """Write (B,1,KV,D) rows at logical ``pos`` through the page table, in
    place; a parked slot writes the null page and a position past the
    table's span writes nothing (``paged_write_index``)."""
    index = paged_write_index(pos, page_idx, page_size, 1)
    return write_paged_rows(k_pages, v_pages, k_new, v_new, index)


def paged_cache_update_multi(k_pages, v_pages, k_new, v_new, pos, page_idx,
                             page_size):
    """Write a (B,T,KV,D) block at logical ``pos[b] + t`` through the page
    table, in place.  Positions clip to [0, max_len - 1] and rows of a
    parked slot or past the table's span go to the null page 0
    (``paged_write_index``)."""
    index = paged_write_index(pos, page_idx, page_size, k_new.shape[1])
    return write_paged_rows(k_pages, v_pages, k_new, v_new, index)


def paged_prefill_chunk_update(k_pages, v_pages, k_new, v_new, slot, offset,
                               page_idx, page_size):
    """Write one slot's chunk (1,C,KV,D), C a multiple of ``page_size`` and
    ``offset`` page-aligned, into the C // page_size pages its table row
    maps from block ``offset // page_size``, in place.  The chunk must fit
    the row (the reference's ``dynamic_slice`` would clamp its start; the
    engine's chunks always fit, so anything else is an error).  Entries
    past the slot's reservation are the null page 0, which several padded
    blocks then share: it takes the last of them on every device (on the
    card an index write with repeated indices keeps any one of them, and
    the padded rows that read the null page back feed an MoE FFN whose
    capacity they share with the real rows)."""
    c, kv, d = k_new.shape[1], k_new.shape[2], k_new.shape[3]
    offset = int(offset)
    if c % page_size or offset % page_size:
        raise ValueError(f"chunk {c} at offset {offset} is not page-aligned "
                         f"(page_size {page_size})")
    m, start = c // page_size, offset // page_size
    if offset < 0 or start + m > page_idx.shape[1]:
        raise ValueError(f"chunk [{offset}, {offset + c}) outside the "
                         f"{page_idx.shape[1] * page_size} positions of the "
                         f"page table")
    pages = page_idx[int(slot), start:start + m].long()
    # every null block writes the last null block's rows
    blk = torch.arange(m, device=pages.device)
    null = pages == 0
    src = torch.where(null, torch.where(null, blk, -1).amax(), blk)
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        pool, new = _raw(pool, new.reshape(m, page_size, kv, d).to(
            pool.dtype))
        pool[pages] = new[src]
    return k_pages, v_pages


def _gather(pages, rows, scale=None):
    """Pool (P,page_size,KV,D) through table rows (B,max_pages) -> dense
    (B, max_pages * page_size, KV, D); with the pool's ``scale``
    (P,page_size,KV,1) the gathered rows are dequantized to f32."""
    b, n = rows.shape
    _, page_size, kv, d = pages.shape
    x = pages[rows.long()].reshape(b, n * page_size, kv, d)
    if scale is None:
        return x
    return dequantize_kv(x, scale[rows.long()].reshape(b, n * page_size,
                                                       kv, 1))


def gather_slot_pages(k_pages, v_pages, page_idx, slot, k_scale=None,
                      v_scale=None):
    """Dense (1, S, KV, D) views of one slot's page chain, S = max_pages *
    page_size; unmapped blocks gather the null page (masked by position).
    With ``k_scale``/``v_scale`` the quantized pools are gathered and
    dequantized: the views are f32."""
    row = page_idx[int(slot)][None]
    return _gather(k_pages, row, k_scale), _gather(v_pages, row, v_scale)


def paged_decode_attention_xla(q, k_pages, v_pages, page_idx, pos, *,
                               window=0, k_scale=None, v_scale=None):
    """Paged decode attention, plain tensor ops: q (B,T,H,D); pools
    (P,page_size,KV,D); page_idx (B,max_pages).  Gathers each slot's pages
    into a dense view (dequantized with ``k_scale``/``v_scale``
    (P,page_size,KV,1) f32 when the pools are quantized) and defers to
    ``decode_attention_xla``."""
    return decode_attention_xla(q, _gather(k_pages, page_idx, k_scale),
                                _gather(v_pages, page_idx, v_scale), pos,
                                window=window)


# ------------------------------------------------------------ quantized KV
KV_QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# qmax of each pool dtype (448: e4m3fn's largest finite value)
_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def kv_quant_dtype(kv_quant: str):
    """Pool dtype for a ``RuntimeKnobs.kv_quant`` mode string ("" -- the
    unquantized default -- maps to None: store at cache_dtype)."""
    return KV_QUANT_DTYPES[kv_quant] if kv_quant else None


def quantize_kv(x, qdtype):
    """Per-token/per-head symmetric quantization of fresh K/V rows, as the
    reference's: x (..., D) -> (q (..., D) ``qdtype``, scale (..., 1) f32)
    with scale = absmax / qmax over the head dim.  The rows are multiplied
    by ``inv = 1 / max(scale, 1e-30)`` (not divided by the scale); int8
    rounds half to even and clips to +-127, fp8 is a plain cast.  All-zero
    rows get scale 0 and inv 0, so they dequantize to exact zeros."""
    qmax = _QMAX[qdtype]
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax / qmax
    inv = torch.where(amax > 0, 1.0 / torch.clamp(scale, min=1e-30), 0.0)
    if qdtype == torch.int8:
        q = torch.clamp(torch.round(xf * inv), -qmax, qmax).to(torch.int8)
    else:
        q = (xf * inv).to(qdtype)
    return q, scale


def dequantize_kv(q, scale):
    """Inverse of ``quantize_kv``: (..., D) quantized and (..., 1) f32 ->
    f32."""
    return q.float() * scale


def write_paged_rows_quant(k_pages, v_pages, k_scale, v_scale, k_new, v_new,
                           index):
    """``write_paged_rows`` for quantized pools: the (B,T,KV,D) rows are
    quantized per token and head, the values land in the int8/fp8 pools
    and the scales in the (P,page_size,KV,1) scale pools at the same
    ``index``, in place."""
    kq, ks = quantize_kv(k_new, k_pages.dtype)
    vq, vs = quantize_kv(v_new, v_pages.dtype)
    write_paged_rows(k_pages, v_pages, kq, vq, index)
    write_paged_rows(k_scale, v_scale, ks, vs, index)
    return k_pages, v_pages, k_scale, v_scale


def paged_cache_update_quant(k_pages, v_pages, k_scale, v_scale, k_new,
                             v_new, pos, page_idx, page_size):
    """Quantized ``paged_cache_update``: (B,1,KV,D) rows quantized and
    written, values and scales, through the page table, in place.  Every
    write is a fresh row: no page is read back and requantized, so the
    quantization error never accumulates."""
    index = paged_write_index(pos, page_idx, page_size, 1)
    return write_paged_rows_quant(k_pages, v_pages, k_scale, v_scale, k_new,
                                  v_new, index)


def paged_cache_update_multi_quant(k_pages, v_pages, k_scale, v_scale,
                                   k_new, v_new, pos, page_idx, page_size):
    """Quantized ``paged_cache_update_multi`` (the verify block): the
    (B,T,KV,D) rows quantized and written, values and scales, at logical
    ``pos[b] + t``, in place; rows of a parked slot or past the table's
    span send both to the null page 0."""
    index = paged_write_index(pos, page_idx, page_size, k_new.shape[1])
    return write_paged_rows_quant(k_pages, v_pages, k_scale, v_scale, k_new,
                                  v_new, index)


def paged_prefill_chunk_update_quant(k_pages, v_pages, k_scale, v_scale,
                                     k_new, v_new, slot, offset, page_idx,
                                     page_size):
    """Quantized ``paged_prefill_chunk_update``: the chunk's values and
    scales land in the pages the slot's table row maps, in place."""
    kq, ks = quantize_kv(k_new, k_pages.dtype)
    vq, vs = quantize_kv(v_new, v_pages.dtype)
    paged_prefill_chunk_update(k_pages, v_pages, kq, vq, slot, offset,
                               page_idx, page_size)
    paged_prefill_chunk_update(k_scale, v_scale, ks, vs, slot, offset,
                               page_idx, page_size)
    return k_pages, v_pages, k_scale, v_scale
