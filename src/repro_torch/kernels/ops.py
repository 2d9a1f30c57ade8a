"""Model-layout dispatch of the attention and SSD kernels (the counterpart
of ``repro/kernels/ops.py``).

The device decides the path: tensors on the CPU take the plain versions in
``ref.py`` (through transposed views); CUDA tensors launch the
hand-written kernels, or the call raises.  There is no fallback: a
quantized pool on the card is read by the kernels, never dequantized into
an f32 pool for them.  Paged pools stay in the model layout
(P, page_size, KV, D), scale pools (P, page_size, KV, 1): the kernels read
them through strides, so no pool is transposed or copied per call.

Tensors on the meta device (the dry run, ``launch/dryrun.py``) run
nothing: each wrapper returns its output's shape on meta and records the
kernel's work (``cost.py``, the function the kernels' bounds use too)
with the active recorder.  That is no fallback: nothing is computed.
"""
from __future__ import annotations

import torch

from . import cost, ref
from .decode_attention import (decode_attention_cuda,
                               decode_attention_splitk_cuda)
from .flash_attention import flash_attention_cuda
from .paged_attention import (paged_decode_attention_cuda,
                              paged_decode_attention_splitk_cuda,
                              paged_prefill_attention_cuda)
from .ssd_scan import ssd_chunk_cuda


def _meta(name, work, *outs):
    """The meta device's call: record ``work`` and return empty outputs
    of the given (shape, dtype) pairs on meta."""
    cost.record(name, work)
    out = [torch.empty(shape, dtype=dt, device="meta") for shape, dt in outs]
    return out[0] if len(out) == 1 else tuple(out)


def _decode_meta(name, q, k, span, pos, page_size=0, k_scale=None):
    """One decode call on meta (#1-#3, #5 and the scaled pools) against
    a prefix of ``span`` rows: ``pos`` counts where it is host data, else
    every slot sits at the last row (``cost._positions``)."""
    if isinstance(pos, torch.Tensor):
        pos = pos.numpy() if pos.device.type == "cpu" else None
    b, t, h, d = q.shape
    work = cost.decode_work(b, t, h, d, k.shape[2], span, q.element_size(),
                            k.element_size(), pos, page_size=page_size,
                            scales=k_scale is not None,
                            rate=cost.decode_rate(q, k))
    return _meta(name, work, (q.shape, q.dtype))


def _split(q, num_splits):
    """Split-K only for one-token decode; T > 1 always runs single pass,
    as in the reference."""
    return num_splits > 1 and q.shape[1] == 1


def _row_by_row(plain, q, pos, active):
    """A T > 1 block through ``plain(q_t, pos_t, active)`` one row at a
    time: row t is the one-token call at ``pos + t`` under the block's
    ``active`` (default ``pos >= 0``), in the one-token call's layout.  So
    a row does not depend on T, as the kernels' rows do not (the CPU's
    batched products choose their blocking by the row count)."""
    t = q.shape[1]
    if t == 1:
        return plain(q, pos, active)
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).long()
    if active is None:
        active = pos >= 0
    return torch.cat([plain(q[:, i:i + 1].contiguous(), pos + i, active)
                      for i in range(t)], dim=1)


def decode_attention_plain(q, k_cache, v_cache, pos, *, active=None,
                           window=0, num_splits=1):
    """The plain versions in model layout, on any device (the CPU path of
    ``decode_attention``; the on-card checks compare the kernels with it).
    A T > 1 block goes row by row (``_row_by_row``).
    """
    kt, vt = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    if _split(q, num_splits):
        out = ref.decode_attention_splitk_ref(
            q.transpose(1, 2), kt, vt, pos, active=active, window=window,
            num_splits=num_splits)
        return out.transpose(1, 2)
    return _row_by_row(lambda qr, p, a: ref.decode_attention_ref(
        qr.transpose(1, 2), kt, vt, p, active=a,
        window=window).transpose(1, 2), q, pos, active)


def decode_attention(q, k_cache, v_cache, pos, *, active=None, window=0,
                     num_splits=1):
    """Model layout: q (B,T,H,D); caches (B,S,KV,D) -> (B,T,H,D).

    ``pos`` scalar or (B,); ``active`` (B,) 0/1 (default ``pos >= 0``).
    ``num_splits > 1`` with T = 1 takes the split-K path; T > 1
    always takes the single-pass kernel, as in the reference.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos,
                                      active=active, window=window,
                                      num_splits=num_splits)
    if q.device.type == "meta":
        return _decode_meta("decode_attention_splitk" if _split(q, num_splits)
                            else "decode_attention", q, k_cache,
                            k_cache.shape[1], pos)
    if _split(q, num_splits):
        return decode_attention_splitk_cuda(q, k_cache, v_cache, pos,
                                            active=active, window=window,
                                            num_splits=num_splits)
    return decode_attention_cuda(q, k_cache, v_cache, pos, active=active,
                                 window=window)


def _t(x):
    """The kernel-layout view of a model-layout tensor (None stays None)."""
    return None if x is None else x.transpose(1, 2)


def paged_decode_attention_plain(q, k_pages, v_pages, page_idx, pos, *,
                                 active=None, window=0, num_splits=1,
                                 k_scale=None, v_scale=None):
    """The paged plain versions in model layout, on any device (the CPU
    path of ``paged_decode_attention``; the on-card checks compare the
    kernels with it).  With ``k_scale``/``v_scale`` the quantized pools
    are dequantized whole first.  A T > 1 block goes row by row
    (``_row_by_row``)."""
    kt, vt, kst, vst = map(_t, (k_pages, v_pages, k_scale, v_scale))
    if _split(q, num_splits):
        kw = dict(active=active, window=window, num_splits=num_splits)
        if k_scale is None:
            out = ref.paged_decode_attention_splitk_ref(
                q.transpose(1, 2), kt, vt, page_idx, pos, **kw)
        else:
            out = ref.paged_decode_attention_splitk_quant_ref(
                q.transpose(1, 2), kt, vt, kst, vst, page_idx, pos, **kw)
        return out.transpose(1, 2)

    def one_row(qr, p, a):
        kw = dict(active=a, window=window)
        if k_scale is None:
            out = ref.paged_decode_attention_ref(qr.transpose(1, 2), kt, vt,
                                                 page_idx, p, **kw)
        else:
            out = ref.paged_decode_attention_quant_ref(
                qr.transpose(1, 2), kt, vt, kst, vst, page_idx, p, **kw)
        return out.transpose(1, 2)

    return _row_by_row(one_row, q, pos, active)


def paged_decode_attention(q, k_pages, v_pages, page_idx, pos, *,
                           active=None, window=0, num_splits=1, k_scale=None,
                           v_scale=None):
    """Model layout: q (B,T,H,D); pools (P,page_size,KV,D); page_idx
    (B,max_pages) int32, unmapped entries 0 -> (B,T,H,D).

    ``num_splits > 1`` with T = 1 takes the paged split-K path
    (``max_pages % num_splits == 0``); T > 1 always takes the single-pass
    kernel, as in the reference.  ``k_scale``/``v_scale``
    (P,page_size,KV,1) f32 go with int8/fp8 pools: the kernels read the
    quantized pools and dequantize on the card (no swap to the TPU
    layout: they read the scales through strides).
    """
    kw = dict(active=active, window=window, k_scale=k_scale,
              v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_idx, pos, num_splits=num_splits, **kw)
    if q.device.type == "meta":
        page = k_pages.shape[1]
        return _decode_meta(
            "paged_decode_attention_splitk" if _split(q, num_splits)
            else "paged_decode_attention", q, k_pages,
            page_idx.shape[1] * page, pos, page, k_scale)
    if _split(q, num_splits):
        return paged_decode_attention_splitk_cuda(
            q, k_pages, v_pages, page_idx, pos, num_splits=num_splits, **kw)
    return paged_decode_attention_cuda(q, k_pages, v_pages, page_idx, pos,
                                       **kw)


def paged_prefill_attention_plain(q, k_pages, v_pages, page_idx, slot,
                                  offset, *, window=0, k_scale=None,
                                  v_scale=None):
    """The fused paged prefill's plain version in model layout, on any
    device (quantized pools dequantized whole first)."""
    qt, kt, vt, kst, vst = map(_t, (q, k_pages, v_pages, k_scale, v_scale))
    if k_scale is None:
        out = ref.paged_prefill_attention_ref(qt, kt, vt, page_idx[slot],
                                              offset, window=window)
    else:
        out = ref.paged_prefill_attention_quant_ref(
            qt, kt, vt, kst, vst, page_idx[slot], offset, window=window)
    return out.transpose(1, 2)


def paged_prefill_attention(q, k_pages, v_pages, page_idx, slot, offset, *,
                            window=0, k_scale=None, v_scale=None):
    """Model layout: q (1,C,H,D), one slot's prefill chunk at absolute
    ``offset``, against pools (P,page_size,KV,D) through row ``slot`` of
    ``page_idx`` (slots, max_pages) -> (1,C,H,D).  The chunk's K/V must
    already be written to its pages; ``k_scale``/``v_scale`` as for
    ``paged_decode_attention``."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, page_idx, slot, offset, window=window,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "meta":
        _, c, h, d = q.shape
        work = cost.prefill_work(c, h, d, k_pages.shape[2], int(offset),
                                 q.element_size(), k_pages.element_size(),
                                 k_pages.shape[1], cost.tc_class(q, k_pages),
                                 scales=k_scale is not None)
        return _meta("paged_prefill_attention", work, (q.shape, q.dtype))
    return paged_prefill_attention_cuda(q, k_pages, v_pages,
                                        page_idx[int(slot)], int(offset),
                                        window=window, k_scale=k_scale,
                                        v_scale=v_scale)


def flash_attention_plain(q, k, v, *, causal=True, window=0):
    """The full-sequence plain version in model layout, on any device (the
    CPU path of ``flash_attention``; the on-card checks compare the kernel
    with it)."""
    out = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, window=0):
    """Model layout: q (B,S,H,D); k,v (B,S,KV,D) -> (B,S,H,D).  Query row
    i attends key j when ``j <= i`` (``causal``) and ``i - j < window``
    (``window > 0``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        b, s, h, d = q.shape
        work = cost.flash_work(b, s, h, d, k.shape[2], q.element_size(),
                               k.element_size(), cost.tc_class(q, k),
                               causal=causal, window=window)
        return _meta("flash_attention", work, (q.shape, q.dtype))
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def ssd_chunk_plain(x, b, c, dt, cum):
    """The SSD chunk's plain version, on any device (the CPU path of
    ``ssd_chunk``; the on-card checks compare the kernel with it)."""
    return ref.ssd_chunk_ref(x, b, c, dt, cum)


def ssd_chunk(x, b, c, dt, cum):
    """SSD intra-chunk compute in the kernel layout of
    ``repro/kernels/ssd_scan.py``: x (B,NC,NH,Q,hp); b,c (B,NC,G,Q,ds);
    dt,cum (B,NC,NH,Q) f32 -> (y (B,NC,NH,Q,hp), state (B,NC,NH,ds,hp)
    f32)."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, b, c, dt, cum)
    if x.device.type == "meta":
        bb, nc, nh, q, hp = x.shape
        g, ds = b.shape[2], b.shape[4]
        work = cost.ssd_work(bb, nc, nh, q, hp, g, ds, x.element_size())
        return _meta("ssd_chunk", work, (x.shape, x.dtype),
                     ((bb, nc, nh, ds, hp), torch.float32))
    return ssd_chunk_cuda(x, b, c, dt, cum)
