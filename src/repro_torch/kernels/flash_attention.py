"""Wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``), forward only: a call that autograd would
record raises (``refuse_grad``).

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
                               _strides, refuse_grad)

WARPGROUPS = 2  # consumer warpgroups of a many-row CTA (csrc MR_WG)
ROWS = 64 * WARPGROUPS  # flattened (position, head) rows a CTA (MR_ROWS)
TILE_KEYS = 32  # keys a tile; tiles start at its multiples (csrc MR_TK)
MAX_GROUP = 64  # query heads per KV head, at most (csrc MR_MAX_G)
CTAS_PER_SM = 1  # CTAs of the many-row kernel one SM holds (csrc)
MIN_SPLIT_KEYS = 256  # fewest keys a split of the longest CTA should get
SPLIT_COST_KEYS = 128  # a split's start and merge, in keys of its walk

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
    """Raise unless the kernel takes ``g`` query heads per KV head: at most
    ``MAX_GROUP`` (no arch needs more).  The rows of one (batch row, KV
    head) are (position, head) pairs flattened, position-major, and a CTA
    takes ``ROWS`` consecutive ones whatever ``g`` is (``row_plan``)."""
    if g > MAX_GROUP:
        raise ValueError(f"G = {g} query heads per KV head exceeds the "
                         f"{MAX_GROUP} query rows of one position that the "
                         f"many-row kernel takes")


def row_blocks(sq: int, g: int) -> int:
    """CTAs of one (batch row, KV head) at ``sq`` positions of ``g`` heads:
    ``ROWS`` flattened rows each, the last one partial."""
    return -(-sq * g // ROWS)


def many_row_ctas(b: int, sq: int, h: int, kv: int) -> int:
    """CTAs of a many-row launch before the key-range split (the kernel's
    grid (kv, row_blocks, b))."""
    return kv * row_blocks(sq, h // kv) * b


def row_plan(sq, g, sk, *, q_offset=0, causal=True, window=0, rows=ROWS):
    """The kernel's row blocks of one (batch row, KV head), as
    ``csrc/many_row_attention.cuh`` computes them with ``rows`` rows a CTA
    (``ROWS``; another count models the same rows in other CTAs): for
    block i, its flattened rows ``[r0, r1)`` (row r is position ``r // g``,
    at absolute
    position ``q_offset + r // g``, query head ``r % g`` of the group) and
    its key range ``[kbeg, hi)``: from its first row's window start,
    rounded down to a multiple of ``TILE_KEYS``, to its last row's position
    (causal) or ``sk``.  An empty range has ``kbeg == hi``."""
    n = sq * g
    blocks = []
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        qfirst, qlast = q_offset + r0 // g, q_offset + (r1 - 1) // g
        hi = min(sk, qlast + 1) if causal else sk
        lo = max(0, qfirst - window + 1) if window else 0
        kbeg = lo // TILE_KEYS * TILE_KEYS if lo < hi else hi
        blocks.append((r0, r1, kbeg, hi))
    return blocks


def num_splits(ctas: int, keys: int, sms: int) -> int:
    """Key-range splits for a many-row launch of ``ctas`` CTAs whose longest
    key range is ``keys``, on a card of ``sms`` SMs: 1 when the launch fills
    every SM; otherwise the count, at most the one that leaves each split
    ``MIN_SPLIT_KEYS`` keys, whose launch ends soonest: waves of
    ``CTAS_PER_SM`` CTAs per SM times the keys a split walks, plus
    ``SPLIT_COST_KEYS`` for its own start and merge; the fewest on a tie.
    (96 CTAs of 4096 keys take 4 splits, 3 waves of 1024 keys: sooner
    than one wave of 4096.)"""
    if ctas >= sms:
        return 1
    slots = CTAS_PER_SM * sms
    return min(range(1, max(1, keys // MIN_SPLIT_KEYS) + 1),
               key=lambda ns: (-(-ctas * ns // slots)
                               * (keys / ns + SPLIT_COST_KEYS), ns))


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_many_row(fn, out, kv, keys, args, tail):
    """Launch ``fn`` (a many-row entry point writing ``out`` (B, Sq, H, D)
    from ``kv`` KV heads, longest key range ``keys``) with its split count
    and f32 scratch between ``args`` and ``tail``; raises on a CUDA
    error."""
    b, sq, h, d = out.shape
    ns = num_splits(many_row_ctas(b, sq, h, kv), keys,
                    _sm_count(out.device))
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
    sees at least one key), H / KV at most ``MAX_GROUP``, D one of
    ``HEAD_DIMS``.
    Row i attends key j when ``j <= i`` (``causal``) and ``i - j <
    window`` (``window > 0``)."""
    refuse_grad("flash_attention_cuda", q, k, v)
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
