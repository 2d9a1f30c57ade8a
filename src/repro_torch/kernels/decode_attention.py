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
# dtype codes of the C entry points; int8 and float8_e4m3fn are the
# quantized paged pools, which only the paged kernels take (with scales)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)

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


def _check_shapes(q, k, v, what, layout, quant=False):
    """Shape and dtype checks the kernels of both layouts share: q
    (B,T,H,D) and k/v 4-D (``layout``) of one shape and dtype,
    float32/bfloat16 (``quant``: or int8/float8_e4m3fn), a built head
    dim."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (B,T,H,D) and {what}s {layout}, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k/v {what} shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    kv_dtypes = FLOAT_DTYPES + (QUANT_DTYPES if quant else ())
    if q.dtype not in FLOAT_DTYPES or k.dtype not in kv_dtypes:
        names = "/".join(str(t).removeprefix("torch.") for t in kv_dtypes)
        raise ValueError(f"dtypes q={q.dtype} {what}={k.dtype}: kernel "
                         f"takes {names}")
    if v.dtype != k.dtype:
        raise ValueError(f"k/v {what} dtypes differ: {k.dtype} vs "
                         f"{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not built (kernel takes "
                         f"{HEAD_DIMS})")


def _check_device(q, k, v, what):
    """CUDA tensors on one device, contiguous head dims and 16-byte
    aligned K/V rows (the kernels load 16 bytes at a time)."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA attention kernel needs CUDA tensors, got "
                         f"q on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} {what} on {t.device}, q on {q.device}")
    if q.stride(-1) != 1:
        raise ValueError("q's head dim must be contiguous")
    esize = k.element_size()
    for name, c in (("k", k), ("v", v)):
        if c.stride(-1) != 1:
            raise ValueError(f"{name} {what}'s head dim must be contiguous")
        if c.data_ptr() % 16 or any((c.stride(i) * esize) % 16
                                    for i in range(3)):
            raise ValueError(f"{name} {what} rows are not 16-byte aligned")


def _pos_active(pos, active, b, device):
    """``pos`` and ``active`` (default ``pos >= 0``) as (B,) int32 device
    tensors."""
    pos = torch.as_tensor(pos, device=device).reshape(-1)
    pos = pos.expand(b).to(torch.int32).contiguous()
    if active is None:
        active = (pos >= 0).to(torch.int32)
    else:
        active = torch.as_tensor(active, device=device).reshape(-1)
        active = active.expand(b).to(torch.int32).contiguous()
    return pos, active


def _check(q, k_cache, v_cache, pos, active):
    """Validate the inputs; return (pos, active) as (B,) int32 device
    tensors."""
    _check_shapes(q, k_cache, v_cache, "cache", "(B,S,KV,D)")
    b, t, h, d = q.shape
    kb, _, kv, kd = k_cache.shape
    if kb != b or kd != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)}")
    if (h // kv) * t > MAX_ROWS:
        raise ValueError(f"G*T = {(h // kv) * t} query rows per KV head "
                         f"exceeds {MAX_ROWS}")
    _check_device(q, k_cache, v_cache, "cache")
    return _pos_active(pos, active, b, q.device)


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
