"""Wrappers of the hand-written CUDA decode kernels
(``csrc/decode_attention.cu``).

Model layout in and out: q (B, T, H, D), caches (B, S, KV, D), result
(B, T, H, D) in q's dtype.  The caches are passed by pointer and strides;
nothing is transposed or copied.  Each wrapper checks what the kernel
takes and raises on anything else, allocates its output and scratch with
``torch.empty``, launches on the current stream and raises if the launch
returns a CUDA error.  ``<wrapper>.launches`` counts its kernel launches.

The plain versions live in ``ref.py``; ``ops.decode_attention`` chooses
between them by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_ROWS = 16  # G * T query rows one CTA serves (csrc MAX_ROWS)
HEAD_DIMS = (128,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _P, _P, _P, _I, _I, _P]
_SPLITK_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _P, _P, _P, _P, _P, _P, _I, _I, _P]


def _lib():
    lib = _build.load("decode_attention")
    if lib.decode_attention_fwd.argtypes is None:
        lib.decode_attention_fwd.argtypes = _FWD_ARGS
        lib.decode_attention_fwd.restype = _I
        lib.decode_attention_splitk_fwd.argtypes = _SPLITK_ARGS
        lib.decode_attention_splitk_fwd.restype = _I
    return lib


def _check(q, k_cache, v_cache, pos, active):
    """Validate the inputs; return (pos, active) as (B,) int32 device
    tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA decode kernel needs CUDA tensors, got "
                         f"q on {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"expected q (B,T,H,D) and caches (B,S,KV,D), got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v cache shapes differ: {tuple(k_cache.shape)} "
                         f"vs {tuple(v_cache.shape)}")
    b, t, h, d = q.shape
    kb, _, kv, kd = k_cache.shape
    if kb != b or kd != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built (kernel takes {HEAD_DIMS})")
    if (h // kv) * t > MAX_ROWS:
        raise ValueError(f"G*T = {(h // kv) * t} query rows per KV head "
                         f"exceeds {MAX_ROWS}")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes q={q.dtype} cache={k_cache.dtype}: kernel "
                         f"takes float32/bfloat16")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError(f"k/v cache dtypes differ: {k_cache.dtype} vs "
                         f"{v_cache.dtype}")
    if q.stride(-1) != 1:
        raise ValueError("q's head dim must be contiguous")
    esize = k_cache.element_size()
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        # 16-byte vector loads: base and every row start 16-byte aligned
        if c.data_ptr() % 16 or any((c.stride(i) * esize) % 16
                                    for i in range(3)):
            raise ValueError(f"{name} rows are not 16-byte aligned")
    pos = torch.as_tensor(pos, device=q.device).reshape(-1)
    pos = pos.expand(b).to(torch.int32).contiguous()
    if active is None:
        active = (pos >= 0).to(torch.int32)
    else:
        active = torch.as_tensor(active, device=q.device).reshape(-1)
        active = active.expand(b).to(torch.int32).contiguous()
    return pos, active


def _strides(x):
    return (ctypes.c_longlong * 3)(x.stride(0), x.stride(1), x.stride(2))


def decode_attention_cuda(q, k_cache, v_cache, pos, *, active=None,
                          window=0):
    """Single-pass ragged decode (replaces ``decode_attention_tpu``).
    q (B, T, H, D) with G*T <= 16; caches (B, S, KV, D); ``pos`` scalar or
    (B,); ``active`` (B,) 0/1, default ``pos >= 0``."""
    pos, active = _check(q, k_cache, v_cache, pos, active)
    b, t, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    strides = (_strides(q), _strides(k_cache), _strides(v_cache))
    err = _lib().decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        pos.data_ptr(), active.data_ptr(), b, t, h, kv, s, d, int(window),
        *strides, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention_fwd launch failed: "
                           f"cudaError {err}")
    decode_attention_cuda.launches += 1
    return out


def decode_attention_splitk_cuda(q, k_cache, v_cache, pos, *, active=None,
                                 window=0, num_splits=2):
    """Two-phase split-K decode (replaces ``decode_attention_splitk_tpu``):
    T = 1, ``S % num_splits == 0``.  Partials go to f32 scratch; the
    combine kernel writes the (B, 1, H, D) result."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"split-K decode is single-token, got q "
                         f"{tuple(q.shape)}")
    if num_splits < 1 or k_cache.dim() != 4 \
            or k_cache.shape[1] % num_splits:
        raise ValueError(f"num_splits {num_splits} must divide the cache "
                         f"length {k_cache.shape[1:2]}")
    pos, active = _check(q, k_cache, v_cache, pos, active)
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    o_part = torch.empty((b, h, num_splits, d), dtype=torch.float32,
                         device=q.device)
    m_part = torch.empty((b, h, num_splits), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    strides = (_strides(q), _strides(k_cache), _strides(v_cache))
    err = _lib().decode_attention_splitk_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        pos.data_ptr(), active.data_ptr(), b, h, kv, s, d, int(window),
        int(num_splits), *strides, o_part.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention_splitk_fwd launch failed: "
                           f"cudaError {err}")
    decode_attention_splitk_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
decode_attention_splitk_cuda.launches = 0
