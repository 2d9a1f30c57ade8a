"""Wrapper of the hand-written CUDA Mamba2 SSD chunk kernel
(``csrc/ssd_scan.cu``), forward only.

Kernel layout in and out, as ``repro/kernels/ssd_scan.py``: x (B, NC, NH,
Q, hp); b, c (B, NC, G, Q, ds); dt, cum (B, NC, NH, Q) f32 -> y (B, NC, NH,
Q, hp) in x's dtype and state (B, NC, NH, ds, hp) f32.  The inputs are
passed by pointer and strides, so the transposed views the model hands in
are not copied.  The wrapper checks what the kernel takes and raises on
anything else, allocates its outputs with ``torch.empty``, launches on the
current stream and raises if the launch returns a CUDA error.
``ssd_chunk_cuda.launches`` counts its launches.

The plain version is ``ref.ssd_chunk_ref``; ``ops.ssd_chunk`` chooses
between them by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import _DTYPE_CODE, FLOAT_DTYPES

HEAD_DIM = 64  # hp, the built width (csrc HP)
MAX_CHUNK = 256
MAX_STATE = 128
HEADS_PER_CTA = 8  # heads that share one C.B^T block (csrc hpc, at most)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
         _P, _P, _P, _I, _P]


def _lib():
    lib = _build.load("ssd_scan")
    if lib.ssd_chunk_fwd.argtypes is None:
        lib.ssd_chunk_fwd.argtypes = _ARGS
        lib.ssd_chunk_fwd.restype = _I
    return lib


def _strides4(t):
    return (ctypes.c_longlong * 4)(*t.stride()[:4])


def _check(x, b, c, dt, cum):
    if x.dim() != 5 or b.dim() != 5 or c.shape != b.shape:
        raise ValueError(f"expected x (B,NC,NH,Q,hp) and b/c (B,NC,G,Q,ds) "
                         f"of one shape, got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bb, nc, nh, q, hp = x.shape
    g, ds = b.shape[2], b.shape[4]
    if b.shape[:2] != (bb, nc) or b.shape[3] != q or g == 0 or nh % g:
        raise ValueError(f"b/c {tuple(b.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    for name, t in (("dt", dt), ("cum", cum)):
        if t.shape != (bb, nc, nh, q) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 (B,NC,NH,Q) = "
                             f"{(bb, nc, nh, q)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if x.dtype not in FLOAT_DTYPES or b.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise ValueError(f"x/b/c must share one dtype of float32/bfloat16, "
                         f"got {x.dtype}, {b.dtype}, {c.dtype}")
    if hp != HEAD_DIM or ds % 32 or ds > MAX_STATE or q % 32 \
            or q > MAX_CHUNK:
        raise ValueError(f"kernel takes hp = {HEAD_DIM}, ds a multiple of "
                         f"32 up to {MAX_STATE}, Q a multiple of 32 up to "
                         f"{MAX_CHUNK}; got hp={hp} ds={ds} Q={q}")
    for name, t in (("x", x), ("b", b), ("c", c), ("dt", dt), ("cum", cum)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"CUDA SSD kernel needs CUDA tensors on one "
                             f"device, got {name} on {t.device}")
    esize = x.element_size()
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        if t.data_ptr() % (4 * esize) or any(s % 4 for s in t.stride()[:4]):
            raise ValueError(f"{name} rows are not aligned to 4 elements")
    rep = nh // g
    return max(d for d in range(1, HEADS_PER_CTA + 1) if rep % d == 0)


def ssd_chunk_cuda(x, b, c, dt, cum):
    """SSD intra-chunk compute (replaces ``ssd_chunk_tpu``): y = (C.B^T *
    exp(cum_i - cum_j) * dt_j, j <= i) @ x and the chunk's state
    (B * exp(cum_last - cum) * dt)^T @ x, per (batch, chunk, head); head h
    reads group h // (NH // G).  Needs hp = 64, ds a multiple of 32 up to
    128, Q a multiple of 32 up to 256."""
    hpc = _check(x, b, c, dt, cum)
    bb, nc, nh, q, hp = x.shape
    g, ds = b.shape[2], b.shape[4]
    y = torch.empty((bb, nc, nh, q, hp), dtype=x.dtype, device=x.device)
    st = torch.empty((bb, nc, nh, ds, hp), dtype=torch.float32,
                     device=x.device)
    err = _lib().ssd_chunk_fwd(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
        cum.data_ptr(), y.data_ptr(), st.data_ptr(), bb, nc, nh, g, q, ds,
        hp, hpc, _strides4(x), _strides4(b), _strides4(c), _strides4(dt),
        _strides4(cum), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_chunk_fwd launch failed: cudaError {err}")
    ssd_chunk_cuda.launches += 1
    return y, st


ssd_chunk_cuda.launches = 0
