"""Wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``), forward only.

Model layout in and out: q (B, Sq, H, D), k/v (B, Sk, KV, D), result
(B, Sq, H, D) in q's dtype.  The inputs are passed by pointer and strides;
nothing is transposed or copied.  The wrapper checks what the kernel takes
and raises on anything else, allocates its output with ``torch.empty``,
launches on the current stream and raises if the launch returns a CUDA
error.  ``flash_attention_cuda.launches`` counts its launches.

The plain version is ``ref.attention_ref``; ``ops.flash_attention``
chooses between them by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import (_DTYPE_CODE, _check_device, _check_shapes,
                               _strides)

ROWS = 64  # query rows (positions x heads) one CTA serves (csrc PF_ROWS)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I,
         _P]


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _ARGS
        lib.flash_attention_fwd.restype = _I
    return lib


def flash_attention_cuda(q, k, v, *, causal=True, window=0):
    """Full-sequence attention (replaces ``flash_attention_tpu``): q
    (B, Sq, H, D), k/v (B, Sk, KV, D) with Sq <= Sk (every query row then
    sees at least one key), H / KV dividing 64.  Row i attends key j when
    ``j <= i`` (``causal``) and ``i - j < window`` (``window > 0``)."""
    _check_shapes(q, k, v, "input", "(B,S,KV,D)")
    b, sq, h, d = q.shape
    kb, sk, kv, kd = k.shape
    if kb != b or kd != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if ROWS % (h // kv):
        raise ValueError(f"G = {h // kv} query heads per KV head must "
                         f"divide {ROWS}")
    if sq > sk:
        raise ValueError(f"Sq = {sq} > Sk = {sk}: a query row past the last "
                         f"key would see no key")
    if window < 0:
        raise ValueError(f"window {window} must be >= 0")
    _check_device(q, k, v, "input")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, kv, d, int(bool(causal)), int(window), _strides(q), _strides(k),
        _strides(v), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"cudaError {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
