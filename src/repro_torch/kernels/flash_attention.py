"""Wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``), forward only.

Model layout in and out: q (B, Sq, H, D), k/v (B, Sk, KV, D), result
(B, Sq, H, D) in q's dtype.  The inputs are passed by pointer and strides;
nothing is transposed or copied.  The wrapper checks what the kernel takes
and raises on anything else, allocates its output with ``torch.empty``,
launches on the current stream and raises if the launch returns a CUDA
error.  ``flash_attention_cuda.launches`` counts its launches.

A launch of fewer CTAs than the card has SMs splits each CTA's key range
(``num_splits``, shared with the paged prefill of ``paged_attention.py``);
the splits' partial sums go to f32 scratch that the wrapper allocates.

The plain version is ``ref.attention_ref``; ``ops.flash_attention``
chooses between them by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .decode_attention import (_DTYPE_CODE, _check_device, _check_shapes,
                               _strides)

ROWS = 64  # query rows (positions x heads) one CTA serves (csrc MR_ROWS)
CTAS_PER_SM = 2  # CTAs of the many-row kernel one SM holds (csrc)
MIN_SPLIT_KEYS = 256  # fewest keys a split of the longest CTA should get

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P,
         _P, _P, _I, _I, _P]


def _lib(head_dim):
    lib = _build.load(_build.lib_name("flash_attention", head_dim))
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _ARGS
        lib.flash_attention_fwd.restype = _I
    return lib


def check_grouping(g: int):
    """Raise unless ``g`` query heads per KV head fit one CTA's ``ROWS``
    query rows: a CTA holds floor(ROWS / g) positions of all g heads (g =
    5: 12 positions, 60 rows; g = 48: one position, 48 rows)."""
    if g > ROWS:
        raise ValueError(f"G = {g} query heads per KV head exceeds the "
                         f"{ROWS} query rows of a CTA")


def num_splits(ctas: int, keys: int, sms: int) -> int:
    """Key-range splits for a many-row launch of ``ctas`` CTAs whose longest
    key range is ``keys``, on a card of ``sms`` SMs: 1 when the launch fills
    every SM; otherwise as many as bring it to one full wave of
    ``CTAS_PER_SM`` CTAs per SM, no more than give each split
    ``MIN_SPLIT_KEYS`` keys."""
    if ctas >= sms:
        return 1
    return max(1, min(CTAS_PER_SM * sms // ctas, keys // MIN_SPLIT_KEYS))


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_many_row(fn, out, kv, keys, args, tail):
    """Launch ``fn`` (a many-row entry point writing ``out`` (B, Sq, H, D)
    from ``kv`` KV heads, longest key range ``keys``) with its split count
    and f32 scratch between ``args`` and ``tail``; raises on a CUDA
    error."""
    b, sq, h, d = out.shape
    ctas = kv * -(-sq // (ROWS // (h // kv))) * b
    ns = num_splits(ctas, keys, _sm_count(out.device))
    ptrs = (0, 0, 0)
    if ns > 1:  # freed after the launch: the allocator orders by stream
        rows = ns * b * sq * h  # o_part (rows, D), then m_part and l_part
        scratch = torch.empty(rows * (d + 2), dtype=torch.float32,
                              device=out.device)
        base = scratch.data_ptr()
        ptrs = (base, base + 4 * rows * d, base + 4 * rows * (d + 1))
    err = fn(*args, ns, *ptrs, *tail,
             torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def flash_attention_cuda(q, k, v, *, causal=True, window=0):
    """Full-sequence attention (replaces ``flash_attention_tpu``): q
    (B, Sq, H, D), k/v (B, Sk, KV, D) with Sq <= Sk (every query row then
    sees at least one key), H / KV at most 64, D one of ``HEAD_DIMS``.
    Row i attends key j when ``j <= i`` (``causal``) and ``i - j <
    window`` (``window > 0``)."""
    _check_shapes(q, k, v, "input", "(B,S,KV,D)")
    b, sq, h, d = q.shape
    kb, sk, kv, kd = k.shape
    if kb != b or kd != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    check_grouping(h // kv)
    if sq > sk:
        raise ValueError(f"Sq = {sq} > Sk = {sk}: a query row past the last "
                         f"key would see no key")
    if window < 0:
        raise ValueError(f"window {window} must be >= 0")
    _check_device(q, k, v, "input")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    launch_many_row(
        _lib(d).flash_attention_fwd, out, kv, sk,
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
         h, kv, d, int(bool(causal)), int(window), _strides(q), _strides(k),
         _strides(v)),
        (_DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype]))
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
