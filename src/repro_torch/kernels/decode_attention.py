"""Wrappers of the hand-written CUDA decode kernels over a dense cache
(``csrc/decode_attention.cu``), and the chunk grid they share with the
paged decode.

Decode and split-K decode launch the chunked decode kernel of
``csrc/chunked_decode.cuh`` (the paged decode's too), once per call over
the chunk grid of ``decode_chunks``: split-K's splits are chunks clipped at
``S / num_splits``, merged in the same launch (on the tensor-core routes by
a second kernel).

Model layout in and out: q (B, T, H, D), caches (B, S, KV, D), result
(B, T, H, D) in q's dtype, D one of ``HEAD_DIMS`` (each head dim is its
own library).  Any G * T query rows per KV head: ``decode_route`` picks
the arithmetic by grouping and head dim, one of three routes (on f32 and
bf16 pools: at head dim 128 the tensor cores' warpgroup products at G >=
16 and their warp-level products at 2 <= G < 16; at head dim 64 the
warp-level products at every G; the CUDA cores elsewhere), and
``row_tiles`` the kernel's instance on that route (``max_rows`` names the
largest CUDA-core instance a head dim has) and, past it, spreads the rows
over row tiles, one CTA each.  The caches are passed by pointer and
strides; nothing is transposed or copied.  Each
wrapper checks what the kernel takes and raises on anything else,
allocates its output and scratch with ``torch.empty``, launches on the
current stream and raises if the launch returns a CUDA error.
``<wrapper>.launches`` counts its kernel launches;
``decode_attention_cuda.verify_launches`` counts those of them with T > 1
(the speculative verify block); ``ROUTE_LAUNCHES`` counts the chunked
decode kernel's launches (dense and paged) by route.

The plain versions live in ``ref.py``; ``ops.decode_attention`` chooses
between them by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_ROWS = 16  # the largest instance: G * T rows of one CTA (csrc MAX_ROWS)
CHUNK_KEYS = 256  # keys per chunk of the chunked decode, before whole pages
HEAD_DIMS = _build.HEAD_DIMS  # 64, 80, 128: one library each
# head dims 64 and 80 (archs with G = 1) are built up to the 8-row instance
_ROWS = {64: 8, 80: 8, 128: MAX_ROWS}
# rows of a row tile where G * T passes the largest instance: the 8-row
# instance's (at head dim 128 its tiles ran 1.5-1.6x faster than the
# 16-row instance's, PERF.md)
TILE_ROWS = 8
# the tensor-core routes (decode_route): their head dim; the wgmma route's
# least grouping and its row tile, two warpgroups of 64 rows (csrc
# TC_ROWS); the warp-mma route's least grouping at head dim 128 (it takes
# those below TC_MIN_GROUP), its blocks of 8 columns and its largest
# instance, which is its row tile past that (csrc MMA_ROWS); its head dim
# with the keys over the warps (every grouping) and the largest instance
# and row tile there (csrc MMA64_D, MMA64_ROWS)
TC_HEAD_DIM = 128
TC_MIN_GROUP = 16
TC_ROWS = 128
MMA_MIN_GROUP = 2
MMA_COLS = 8
MMA_ROWS = 32
MMA64_HEAD_DIM = 64
MMA64_ROWS = 16
# the routes, numbered as the C entry points take them (csrc ROUTE_*)
ROUTES = ("cuda_cores", "tensor_cores", "warp_mma")
# dtype codes of the C entry points; int8 and float8_e4m3fn are the
# quantized paged pools, which only the paged kernels take (with scales)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)

_P = ctypes.c_void_p
_I = ctypes.c_int
# both entry points: 6 pointers, 12 ints, strides, scratch, tickets, codes
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P]


def max_rows(head_dim: int) -> int:
    """Query rows of the largest decode instance built at ``head_dim``:
    16 at 128, 8 at 64 and 80 (more rows go in row tiles); a head dim not
    built raises."""
    if head_dim not in _ROWS:
        raise ValueError(f"head_dim {head_dim} not built (kernel takes "
                         f"{HEAD_DIMS})")
    return _ROWS[head_dim]


def decode_route(g: int, head_dim: int, kv_dtype) -> str:
    """The chunked decode kernel's arithmetic for ``g`` query heads per KV
    head at ``head_dim`` on a cache or pool of ``kv_dtype``:
    ``"tensor_cores"`` (``csrc/chunked_decode_tc.cuh``: ``wgmma`` TF32,
    3xTF32 for f32 operands, rows on M in row tiles of ``TC_ROWS``),
    ``"warp_mma"`` (``csrc/chunked_decode_mma.cuh``: ``mma.sync`` TF32,
    3xTF32 for f32 operands, keys on M and the rows on N in blocks of
    ``MMA_COLS``; at head dim 128 each warp over a quarter of D, at 64 over
    its own keys) or ``"cuda_cores"`` (``csrc/chunked_decode.cuh``'s f32
    FMAs).  It takes no T: a verify row is bitwise the one-token launch at
    pos + t only on one arithmetic, so a model's T = 1 ticks and its verify
    blocks take the same route.

    Thresholds (PERF.md section 6, an NVIDIA H100 80GB HBM3 at 700 W,
    each pair from one run), f32 or bf16 pools (q f32 or bf16, as the
    wrappers take).  Head dim 128: G >= ``TC_MIN_GROUP`` = 16 takes the
    wgmma route: granite's G = 48 and qwen3-moe's G = 16 ran at 5-8% of
    their bound on the CUDA cores; on the tensor cores 1·G48 takes 0.0550
    ms against 0.1040, 1·G48v (T = 4) 0.0580 against 0.2637, 1·G16 0.0962
    against 0.1589, 1·G16v 0.1009 against 0.3306.  At G = 2, 4 and 5 its
    128-row tiles made the T = 1 rows 2.1-2.9x slower (G = 2 0.0619 ->
    0.1748 ms).  ``MMA_MIN_GROUP`` = 2 <= G < 16 takes the warp-mma route,
    where every row of those groupings ran faster than on the CUDA cores,
    the T = 1 ones too: internlm2 and gemma3's G = 2 0.0626 -> 0.0602 ms
    (paged 0.0655 -> 0.0638), its T = 4 verify block 0.1087 -> 0.0619;
    mixtral and llava's G = 4 0.0754 -> 0.0607, verify 0.2831 -> 0.0811;
    qwen2.5's G = 5 0.0812 -> 0.0609, verify 0.2420 -> 0.1032.  Head dim
    ``MMA64_HEAD_DIM`` = 64 (musicgen, G = 1) takes the warp-mma route at
    every G, with the keys split over the warps: its T = 9 verify block
    0.3099 -> 0.1162 ms, the one-token and split rows within 1.4% of the
    CUDA cores (1·D64 0.0944 -> 0.0942, 2·D64 0.0938 -> 0.0946, paged
    0.1004 -> 0.1015, paged split-K 0.1002 -> 0.1016); a quarter of D a
    warp, as at 128, had taken the paged one-token rows 9-10% slower.
    Head dim 80 (zamba2), G = 1 at 128 and the 1-byte pools (int8, fp8:
    codes on the CUDA cores) keep the CUDA cores."""
    if kv_dtype not in FLOAT_DTYPES:
        return "cuda_cores"
    if head_dim == MMA64_HEAD_DIM:
        return "warp_mma"
    if head_dim != TC_HEAD_DIM or g < MMA_MIN_GROUP:
        return "cuda_cores"
    return "tensor_cores" if g >= TC_MIN_GROUP else "warp_mma"


def row_tiles(g: int, t: int, head_dim: int, route: str = "cuda_cores"):
    """The chunked decode kernel's row plan for ``g * t`` query rows per
    KV head at ``head_dim`` on ``route`` (``decode_route``): ``(instance
    rows, row tiles)``.  On the tensor cores: ``ceil(g * t / TC_ROWS)``
    tiles of ``TC_ROWS`` rows.  On the warp-mma route, rows that fit an
    instance of 8 or 16 columns take the smaller in one tile; more take
    ``ceil(g * t / MMA_ROWS)`` tiles of ``MMA_ROWS`` (head dim 128) or of
    ``MMA64_ROWS`` = 16 (head dim 64: musicgen's one-token rows one block
    of 8 columns, its T = 9 verify block 16 columns with 9 live).  On the
    CUDA cores, rows that fit an instance take the smallest that holds
    them (2, 8, or 16 at head dim 128) in one tile; more take ``ceil(g * t
    / TILE_ROWS)`` tiles of the ``TILE_ROWS`` instance.  Tile i holds rows
    [i * rows, (i + 1) * rows) of the instance's.  A head dim not built
    raises."""
    rows, largest = g * t, max_rows(head_dim)
    if route == "tensor_cores":
        return TC_ROWS, -(-rows // TC_ROWS)
    if route == "warp_mma":
        for inst in (MMA_COLS, 2 * MMA_COLS):
            if rows <= inst:
                return inst, 1
        tile = MMA64_ROWS if head_dim == MMA64_HEAD_DIM else MMA_ROWS
        return tile, -(-rows // tile)
    for inst in (2, 8, largest):
        if rows <= inst:
            return inst, 1
    return TILE_ROWS, -(-rows // TILE_ROWS)


def _lib(head_dim):
    lib = _build.load(_build.lib_name("decode_attention", head_dim))
    if lib.decode_attention_fwd.argtypes is None:
        for fn in (lib.decode_attention_fwd, lib.decode_attention_splitk_fwd):
            fn.argtypes = _ARGS
            fn.restype = _I
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


def refuse_grad(name, *tensors):
    """Raise, by the wrapper's ``name``, when autograd would record this
    call: the kernels write their outputs through ctypes into
    ``torch.empty`` tensors, which carry no ``grad_fn``, so a gradient
    through them would be lost without a word.  The kernels are forward
    only, as the reference's Pallas kernels are (it trains on its XLA
    route, and so does the port).  Checked before anything else, so that
    it shows on the CPU too."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward only: an input requires "
                           f"grad, and the kernel's output would carry no "
                           f"gradient (train through LM.loss, which "
                           f"reaches no kernel)")


def rows_aligned(c):
    """Whether every row of the 4-D tensor ``c`` (a cache, a pool, or q on
    the tensor-core route) starts on 16 bytes (its pointer and its three
    outer strides), as the kernels' 16-byte loads need."""
    return c.data_ptr() % 16 == 0 and all(
        (c.stride(i) * c.element_size()) % 16 == 0 for i in range(3))


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
    for name, c in (("k", k), ("v", v)):
        if c.stride(-1) != 1:
            raise ValueError(f"{name} {what}'s head dim must be contiguous")
        if not rows_aligned(c):
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
    _check_device(q, k_cache, v_cache, "cache")
    return _pos_active(pos, active, b, q.device)


def _strides(x):
    return (ctypes.c_longlong * 3)(x.stride(0), x.stride(1), x.stride(2))


@functools.lru_cache(maxsize=None)
def decode_chunks(max_pages: int, page_size: int, num_splits: int = 1):
    """The chunked decode kernel's grid: ``(chunk, chunks_per_split,
    ranges)``.  The S = max_pages * page_size key positions (a dense
    cache: S pages of one token) are cut at multiples of ``chunk``
    (CHUNK_KEYS rounded up to whole pages) and at the split boundaries
    (multiples of S / num_splits); ``ranges[z]`` is (lo, hi), the keys of
    chunk z: chunk slot c of split i is the part of cell ``i * split //
    chunk + c`` inside split i, empty (lo >= hi) past its end.  It depends
    on the shapes only, never on positions; the kernel computes the same
    ranges (``chunk_keys``)."""
    chunk = -(-CHUNK_KEYS // page_size) * page_size
    split = max_pages * page_size // num_splits
    cps = max(((i + 1) * split - 1) // chunk - i * split // chunk + 1
              for i in range(num_splits))
    ranges = []
    for z in range(num_splits * cps):
        i, c = divmod(z, cps)
        cell = i * split // chunk + c
        ranges.append((max(cell * chunk, i * split),
                       min((cell + 1) * chunk, (i + 1) * split)))
    return chunk, cps, tuple(ranges)


_TICKETS: dict = {}
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def _tickets(device, stream, n):
    """At least ``n`` int32 ticket counters for launches on ``stream`` of
    ``device``, zero: each launch (dense or paged) leaves the counters it
    used at 0 again, and launches on one stream never overlap."""
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(n, dtype=torch.int32, device=device)
        _TICKETS[(device, stream)] = t
    return t


def chunk_scratch(rows, d, device):
    """f32 scratch of ``rows`` chunk rows: each row's accumulator (``d``
    floats, first) and its (m, l) (two floats, after all accumulators)."""
    return torch.empty(rows * (d + 2), dtype=torch.float32, device=device)


def launch_chunked_decode(fn, name, q, k, max_pages, page_size, num_splits,
                          head, mid):
    """Launch ``fn``, a C entry point of the chunked decode kernel, once
    over ``decode_chunks(max_pages, page_size, num_splits)``'s grid, the
    rows of a KV head in ``row_tiles``' plan on ``decode_route``'s route
    (counted in ``ROUTE_LAUNCHES``): ``fn(*head, chunk,
    chunks_per_split, instance rows, row tiles, the route's index in
    ROUTES, *mid, o_part, ml_part, tickets, q's dtype code, k's dtype
    code, stream)``, with f32 scratch
    for each chunk's (acc, m, l) and the stream's tickets, one per (slot,
    KV head, row tile; the tensor-core routes merge by a second kernel of
    the launch and leave them alone).  ``k`` is a cache (B, S, KV, D) or a
    pool (P, page_size, KV, D).  Raises if the launch returns a CUDA
    error, or on the tensor-core route if q's rows do not start on 16
    bytes."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    route = decode_route(h // kv, d, k.dtype)
    if route == "tensor_cores" and not rows_aligned(q):
        raise ValueError(f"{name}: q's rows must start on 16 bytes on the "
                         f"tensor-core route (it copies q 16 bytes at a "
                         f"time)")
    chunk, cps, _ = decode_chunks(max_pages, page_size, num_splits)
    inst, tiles = row_tiles(h // kv, t, d, route)
    rows = b * kv * num_splits * cps * (h // kv) * t  # o_part (rows, D)
    scratch = chunk_scratch(rows, d, q.device)
    base = scratch.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*head, chunk, cps, inst, tiles, ROUTES.index(route), *mid,
             base,
             base + 4 * rows * d,
             _tickets(q.device, stream, b * kv * tiles).data_ptr(),
             _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    ROUTE_LAUNCHES[route] += 1


def _launch(fn, name, q, k_cache, v_cache, pos, active, num_splits, head):
    """Launch the dense chunked decode through ``fn`` with the C arguments
    ``head`` that follow the pointers, pos and active; returns the
    (B, T, H, D) output."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch_chunked_decode(
        fn, name, q, k_cache, k_cache.shape[1], 1, num_splits,
        (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
         out.data_ptr(), pos.data_ptr(), active.data_ptr(), *head),
        (_strides(q), _strides(k_cache), _strides(v_cache)))
    return out


def decode_attention_cuda(q, k_cache, v_cache, pos, *, active=None,
                          window=0):
    """Single-pass ragged decode (replaces ``decode_attention_tpu``).
    q (B, T, H, D), any G*T rows per KV head (``decode_route``,
    ``row_tiles``); caches (B,
    S, KV, D); ``pos`` scalar or (B,); ``active`` (B,) 0/1, default
    ``pos >= 0``."""
    refuse_grad("decode_attention_cuda", q, k_cache, v_cache)
    pos, active = _check(q, k_cache, v_cache, pos, active)
    b, t, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    out = _launch(_lib(d).decode_attention_fwd, "decode_attention_fwd", q,
                  k_cache, v_cache, pos, active, 1,
                  (b, t, h, kv, s, d, int(window)))
    decode_attention_cuda.launches += 1
    decode_attention_cuda.verify_launches += int(t > 1)
    return out


def decode_attention_splitk_cuda(q, k_cache, v_cache, pos, *, active=None,
                                 window=0, num_splits=2):
    """Split-K decode (replaces ``decode_attention_splitk_tpu``): T = 1,
    ``S % num_splits == 0``.  The splits are chunks clipped at
    ``S / num_splits``, merged as the reference's combine does in the same
    launch: one kernel launch, no combine launch."""
    refuse_grad("decode_attention_splitk_cuda", q, k_cache, v_cache)
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
    out = _launch(_lib(d).decode_attention_splitk_fwd,
                  "decode_attention_splitk_fwd", q, k_cache, v_cache, pos,
                  active, num_splits,
                  (b, h, kv, s, d, int(window), int(num_splits)))
    decode_attention_splitk_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
decode_attention_cuda.verify_launches = 0
decode_attention_splitk_cuda.launches = 0
