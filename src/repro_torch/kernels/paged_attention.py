"""Wrappers of the hand-written CUDA paged attention kernels
(``csrc/paged_attention.cu``): decode, split-K decode and fused chunked
prefill over the shared page pool.  Decode and split-K decode launch one
kernel, the chunked decode kernel of ``csrc/chunked_decode.cuh`` (shared
with the dense decode), over the chunk grid of
``decode_attention.decode_chunks``.

Model layout in and out: q (B, T, H, D) (prefill: (1, C, H, D)), pools
(P, page_size, KV, D), result in q's dtype and q's shape.  The pools are
passed by pointer and strides in that layout; nothing is transposed,
gathered or copied.  Quantized pools (int8, float8_e4m3fn) come with f32
scale pools ``k_scale``/``v_scale`` (P, page_size, KV, 1), also read
through strides: the kernels dequantize each K/V row as it arrives.  The page table is an int32 CUDA tensor
(B, max_pages) whose unmapped entries are the null page 0.  Each wrapper
checks what the kernel takes and raises on anything else, allocates its
output and scratch with ``torch.empty``, launches on the current stream and
raises if the launch returns a CUDA error.  ``<wrapper>.launches`` counts
its launches; ``paged_decode_attention_cuda.verify_launches`` those of
them with T > 1 (the speculative verify block).

The plain versions live in ``ref.py``; ``ops.paged_decode_attention`` and
``ops.paged_prefill_attention`` choose between them by the tensors'
device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import (_DTYPE_CODE, QUANT_DTYPES, _check_device,
                               _check_shapes, _pos_active, _strides,
                               launch_chunked_decode, refuse_grad)
from .flash_attention import check_grouping, launch_many_row

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DECODE_ARGS = [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                _P, _I, _I, _P]
_PREFILL_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                 _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P]


def _lib(head_dim):
    lib = _build.load(_build.lib_name("paged_attention", head_dim))
    if lib.paged_decode_attention_fwd.argtypes is None:
        for fn, args in (("paged_decode_attention_fwd", _DECODE_ARGS),
                         ("paged_prefill_attention_fwd", _PREFILL_ARGS)):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = _I
    return lib


def _check_pools(q, k_pages, v_pages, k_scale, v_scale):
    """Shape checks of q against the pools, and of the scale pools: an
    int8/fp8 pool needs both, an f32/bf16 pool takes none.  Returns
    (page_size, KV, the scale arguments of the C entry points)."""
    _check_shapes(q, k_pages, v_pages, "pool", "(P,page_size,KV,D)",
                  quant=True)
    h, d = q.shape[2], q.shape[3]
    _, page_size, kv, kd = k_pages.shape
    if kd != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)}")
    quant = k_pages.dtype in QUANT_DTYPES
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError(f"a {k_pages.dtype} pool takes "
                         f"{'both' if quant else 'no'} scale pools")
    if not quant:
        zero = (ctypes.c_longlong * 3)()
        return page_size, kv, (None, None, zero, zero)
    want = k_pages.shape[:-1] + (1,)
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc.dtype != torch.float32 or sc.shape != want \
                or sc.device != k_pages.device:
            raise ValueError(f"{name} must be float32 {tuple(want)} on "
                             f"{k_pages.device}, got {sc.dtype} "
                             f"{tuple(sc.shape)} on {sc.device}")
    return page_size, kv, (k_scale.data_ptr(), v_scale.data_ptr(),
                           _strides(k_scale), _strides(v_scale))


def _check_table(table, q, rows, name):
    """An int32 page table on q's device with contiguous rows."""
    if table.dtype != torch.int32 or table.device != q.device:
        raise ValueError(f"{name} must be an int32 tensor on {q.device}, got "
                         f"{table.dtype} on {table.device}")
    if table.dim() != rows or table.stride(-1) != 1:
        raise ValueError(f"{name} must be {rows}-D with contiguous rows, got "
                         f"shape {tuple(table.shape)}")


def _check_decode(q, k_pages, v_pages, page_idx, pos, active, k_scale,
                  v_scale):
    page_size, kv, scales = _check_pools(q, k_pages, v_pages, k_scale,
                                         v_scale)
    _check_table(page_idx, q, 2, "page_idx")
    b, t, h, d = q.shape
    if page_idx.shape[0] != b:
        raise ValueError(f"page_idx has {page_idx.shape[0]} rows for "
                         f"{b} slots")
    _check_device(q, k_pages, v_pages, "pool")
    pos, active = _pos_active(pos, active, b, q.device)
    return pos, active, page_size, kv, scales


def _launch_decode(name, q, k_pages, v_pages, page_idx, pos, active, window,
                   num_splits, k_scale, v_scale):
    """Launch the chunked decode kernel in its paged mode; returns the
    (B, T, H, D) output."""
    pos, active, page_size, kv, scales = _check_decode(
        q, k_pages, v_pages, page_idx, pos, active, k_scale, v_scale)
    b, t, h, d = q.shape
    max_pages = page_idx.shape[1]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    launch_chunked_decode(
        _lib(d).paged_decode_attention_fwd, name, q, k_pages, max_pages,
        page_size, num_splits,
        (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
         out.data_ptr(), pos.data_ptr(), active.data_ptr(),
         page_idx.data_ptr(), page_idx.stride(0), b, t, h, kv, max_pages,
         page_size, d, int(window), int(num_splits)),
        (_strides(q), _strides(k_pages), _strides(v_pages), *scales))
    return out


def paged_decode_attention_cuda(q, k_pages, v_pages, page_idx, pos, *,
                                active=None, window=0, k_scale=None,
                                v_scale=None):
    """Single-pass paged decode (replaces ``paged_decode_attention_tpu``).
    q (B, T, H, D), any G*T rows per KV head (``row_tiles``); pools (P,
    page_size, KV, D), D one of ``HEAD_DIMS``; page_idx
    (B, max_pages) int32; ``pos`` scalar or (B,); ``active`` (B,) 0/1,
    default ``pos >= 0``; ``k_scale``/``v_scale`` (P, page_size, KV, 1) f32
    with int8/fp8 pools."""
    refuse_grad("paged_decode_attention_cuda", q, k_pages, v_pages, k_scale,
                v_scale)
    out = _launch_decode("paged_decode_attention", q, k_pages, v_pages,
                         page_idx, pos, active, window, 1, k_scale, v_scale)
    paged_decode_attention_cuda.launches += 1
    paged_decode_attention_cuda.verify_launches += int(q.shape[1] > 1)
    return out


def paged_decode_attention_splitk_cuda(q, k_pages, v_pages, page_idx, pos,
                                       *, active=None, window=0,
                                       num_splits=2, k_scale=None,
                                       v_scale=None):
    """Paged split-K decode (replaces
    ``paged_decode_attention_splitk_tpu``): T = 1, ``max_pages %
    num_splits == 0`` so that each split owns whole pages of the table.
    The chunks are clipped at the split boundaries and merged, as the
    splits' (acc, m, l) are combined, in the same launch."""
    refuse_grad("paged_decode_attention_splitk_cuda", q, k_pages, v_pages,
                k_scale, v_scale)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"split-K decode is single-token, got q "
                         f"{tuple(q.shape)}")
    if num_splits < 1 or page_idx.dim() != 2 \
            or page_idx.shape[1] % num_splits:
        raise ValueError(f"num_splits {num_splits} must divide max_pages "
                         f"{tuple(page_idx.shape[1:])}")
    out = _launch_decode("paged_decode_attention_splitk", q, k_pages,
                         v_pages, page_idx, pos, active, window, num_splits,
                         k_scale, v_scale)
    paged_decode_attention_splitk_cuda.launches += 1
    return out


def paged_prefill_attention_cuda(q, k_pages, v_pages, page_row, q_offset, *,
                                 window=0, k_scale=None, v_scale=None):
    """Fused paged prefill (replaces ``paged_prefill_attention_tpu``): one
    slot's chunk q (1, C, H, D) at absolute ``q_offset`` against its own
    page chain ``page_row`` (max_pages,) int32, causal, with the chunk's
    K/V already written to the pool.  ``q_offset + C`` must fit the row's
    ``max_pages * page_size`` positions; H / KV at most 64;
    ``k_scale``/``v_scale`` as for ``paged_decode_attention_cuda``."""
    refuse_grad("paged_prefill_attention_cuda", q, k_pages, v_pages, k_scale,
                v_scale)
    page_size, kv, scales = _check_pools(q, k_pages, v_pages, k_scale,
                                         v_scale)
    _check_table(page_row, q, 1, "page_row")
    _, c, h, d = q.shape
    q_offset = int(q_offset)
    if q.shape[0] != 1:
        raise ValueError(f"fused paged prefill is one slot per call, got q "
                         f"{tuple(q.shape)}")
    check_grouping(h // kv)
    if q_offset < 0 or q_offset + c > page_row.shape[0] * page_size:
        raise ValueError(f"chunk [{q_offset}, {q_offset + c}) outside the "
                         f"{page_row.shape[0] * page_size} positions of the "
                         f"page row")
    _check_device(q, k_pages, v_pages, "pool")
    out = torch.empty((1, c, h, d), dtype=q.dtype, device=q.device)
    strides = ((ctypes.c_longlong * 2)(q.stride(1), q.stride(2)),
               _strides(k_pages), _strides(v_pages))
    launch_many_row(
        _lib(d).paged_prefill_attention_fwd, out, kv, q_offset + c,
        (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
         out.data_ptr(), page_row.data_ptr(), c, h, kv, page_size, d,
         q_offset, int(window), *strides, *scales),
        (_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype]))
    paged_prefill_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
paged_decode_attention_cuda.verify_launches = 0
paged_decode_attention_splitk_cuda.launches = 0
paged_prefill_attention_cuda.launches = 0
