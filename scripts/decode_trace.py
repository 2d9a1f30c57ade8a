"""Timeline of the chunked decode kernel's CTAs, on one card.

Builds the paged attention library at ``--head-dim`` (128; 64, 80) with
``-DCD_TRACE`` (a library of its own: ``_build.build_all(...,
extra_flags=...)``), has the wrappers launch that build, runs the paged
decode at ``chip_smoke.py``'s phase 3 shape (4 slots at pos [-1, 1000,
4200, 8191], 512 pages of 16 tokens a slot, KV heads (8), H heads, T rows a
slot) on a pool of each dtype named, on the route ``decode_route`` gives
(the wgmma instance at H / KV >= 16 and the warp-mma one at 2 <= H / KV <
16 on f32 and bf16 pools at head dim 128, the warp-mma one with the keys
over the warps at head dim 64), and prints for the traced launch: its span
and CUDA-event time, the working CTAs and how many shared an SM at once, when
they started and ended, and the median (and 90th percentile) of each
stretch of a working CTA in SM cycles: the prologue (page table, q), the
wait for its first tile, a tile, the last tile and the warps' merge, the
partial's write, and the slot's last CTA's merge of the chunks.

    python3 scripts/decode_trace.py --dtypes int8,float32 [--heads 16]
    python3 scripts/decode_trace.py --dtypes float32 --heads 48 --kv 1 --t 4
    python3 scripts/decode_trace.py --dtypes float32 --heads 32 --kv 32 \
        --head-dim 64 --t 9

Needs CUDA and nvcc; the numbers are device clocks of one launch.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

WORDS = 16  # per CTA: see chunked_decode.cuh's CD_TRACE
TRACE_WORDS = 1 << 17  # the trace buffer: CTAs past 8192 record nothing
DTYPES = ("float32", "bfloat16", "int8", "fp8")


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def trace_one(lib, dtype, heads, kv, t, head_dim=128):
    import torch

    import chip_smoke as c
    from repro_torch.kernels import decode_attention as tdecode
    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_cuda

    sc = {}
    with c._heads(heads, kv, head_dim):
        if dtype in ("int8", "fp8"):
            q, k, v, ks, vs, table, pos = c._quant_paged_inputs(t, dtype)
            sc = dict(k_scale=ks, v_scale=vs)
        else:
            q, k, v, table, pos = c._paged_inputs(t, torch.float32,
                                                  getattr(torch, dtype))
    run = lambda: paged_decode_attention_cuda(q, k, v, table, pos, **sc)
    ms = c._time_ms(run)
    assert lib.cd_trace_clear() == 0
    torch.cuda.synchronize()
    run()
    torch.cuda.synchronize()
    g = heads // kv
    route = tdecode.decode_route(g, q.shape[3], k.dtype)
    _, cps, ranges = tdecode.decode_chunks(table.shape[1], k.shape[1], 1)
    _, tiles = tdecode.row_tiles(g, t, q.shape[3], route)
    n = kv * tiles * q.shape[0] * len(ranges)
    if n * WORDS > TRACE_WORDS:
        raise SystemExit(f"{n} CTAs: the trace holds {TRACE_WORDS // WORDS}")
    buf = (ctypes.c_ulonglong * (n * WORDS))()
    assert lib.cd_trace_read(buf, ctypes.sizeof(buf)) == 0
    rec = [buf[i * WORDS:(i + 1) * WORDS] for i in range(n)]
    t0 = min(r[0] for r in rec)
    t1 = max(r[1] for r in rec)
    work = [r for r in rec if r[9]]
    last = [r for r in work if r[7]]
    print(f"[trace] {dtype} H={heads} KV={kv} D={head_dim} T={t} "
          f"({route}): chunk "
          f"{ranges[0][1]} keys, "
          f"{n} CTAs, {len(work)} working ({len(last)} merging); "
          f"span {(t1 - t0) / 1e3:.2f} us, CUDA events {ms * 1e3:.2f} us",
          flush=True)
    starts = [(r[0] - t0) / 1e3 for r in work]
    ends = [(r[1] - t0) / 1e3 for r in work]
    print(f"[trace]   working CTAs start at {pct(starts, 0):.2f}/"
          f"{pct(starts, 0.5):.2f}/{pct(starts, 1):.2f} us (min/med/max), "
          f"end at {pct(ends, 0):.2f}/{pct(ends, 0.5):.2f}/"
          f"{pct(ends, 1):.2f}", flush=True)
    per_sm = {}
    for r in work:
        per_sm.setdefault(r[8], []).append((r[0], r[1]))
    peak = max(max(sum(a <= s < b for a, b in iv) for s, _ in iv)
               for iv in per_sm.values())
    print(f"[trace]   {len(per_sm)} SMs held working CTAs, at most {peak} "
          f"at once", flush=True)
    tiles_of = [r[9] >> 16 for r in work]
    stretch = {
        "prologue (table, q)": [r[2] for r in work],
        "first tile's wait": [r[3] - r[2] for r in work],
        "a tile": [(r[4] - r[3]) / max(1, (r[9] >> 16) - 1)
                   for r in work if (r[9] >> 16) > 1],
        "last tile + warp merge": [r[5] - r[4] for r in work],
        "partial's write": [r[6] - r[5] for r in work],
        "last CTA's merge": [r[7] - r[6] for r in last],
    }
    # the tensor-core routes' finer marks (words 10-15): the wgmma
    # instance's prologue parts and second tile, the warp-mma instance's
    # second tile
    sub = [r for r in work if r[10] and r[15]]
    if sub and route == "warp_mma" and head_dim == 64:
        stretch.update({
            "tile 1: its wait, the barrier, next copies issued": [
                r[11] - r[10] for r in sub],
            "tile 1: the warp's S^T through its slice": [
                r[12] - r[11] for r in sub],
            "tile 1: the warp's softmax": [r[14] - r[12] for r in sub],
            "tile 1: P V, O += P V": [r[15] - r[14] for r in sub],
        })
    elif sub and route == "warp_mma":
        stretch.update({
            "tile 1: next copies issued, S^T quarters, exchange, V read": [
                r[12] - r[10] for r in sub],
            "tile 1: the exchange's barrier": [r[13] - r[12] for r in sub],
            "tile 1: scores summed, softmax": [r[14] - r[13] for r in sub],
            "tile 1: P V, O += P V": [r[15] - r[14] for r in sub],
        })
    elif sub:
        stretch.update({
            "prologue: table, position, first tile's copies issued": [
                r[11] for r in sub],
            "prologue: q into shared memory": [r[2] - r[11] for r in sub],
            "tile 0 and the barrier": [r[10] - r[3] for r in sub],
            "tile 1: next copies issued, S = q K^T": [
                r[12] - r[10] for r in sub],
            "tile 1: softmax, P V issued": [r[13] - r[12] for r in sub],
            "tile 1: next tile's wait and staging": [
                r[14] - r[13] for r in sub],
            "tile 1: P V's wait, O += P V": [r[15] - r[14] for r in sub],
        })
    print(f"[trace]   tiles a CTA {pct(tiles_of, 0)}-{pct(tiles_of, 1)}",
          flush=True)
    for name, xs in stretch.items():
        if xs:
            print(f"[trace]   {name}: {statistics.median(xs):.0f} cycles "
                  f"(p90 {pct(xs, 0.9):.0f})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", default="int8,float32")
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--kv", type=int, default=8)
    ap.add_argument("--t", type=int, default=1)
    ap.add_argument("--head-dim", type=int, default=128)
    args = ap.parse_args(argv)
    from repro_torch.kernels import _build

    name = _build.lib_name("paged_attention", args.head_dim)
    lib = ctypes.CDLL(str(_build.build_all(
        (name,), extra_flags=("-DCD_TRACE",))[name]))
    _build._LOADED[name] = lib  # the wrappers launch the traced build
    lib.cd_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    for dtype in args.dtypes.split(","):
        if dtype not in DTYPES:
            ap.error(f"--dtypes takes {DTYPES}")
        trace_one(lib, dtype, args.heads, args.kv, args.t, args.head_dim)
    return 0


if __name__ == "__main__":
    sys.exit(main())
