"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, each raising on failure:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all at once; print ptxas's registers, stack
   and spills of every kernel instance, and fail on a spill;
3. kernels: each of the five kernels against its plain PyTorch version on
   the card at the serving path's shapes (internlm2-1.8b attention: H=16,
   KV=8, D=128; 4 slots; 8192 positions each, as a dense cache or as 512
   pages of 16 tokens from a 2049-page pool through a randomly permuted
   page table; ragged positions including -1 and 8191; the four decode
   kernels -- one chunked kernel, dense and paged -- also at their chunk
   boundaries, positions 255, 256 and 257, and a slot's output alone
   against it in the batch, bitwise; dense split-K at 2, 4 and 8 splits
   against the dense single pass, bitwise (its splits are whole chunks);
   paged prefill chunks of 256 rows at offsets 0 and 3840 and the ragged
   last chunk of a 4200-token prompt, 104 rows at 4096, windows 0, 1024
   and 200), the decode kernel's working CTAs, then device times of the
   kernel, the plain version and one library call (behind a spin kernel,
   so the host's launch work is not in them), and the bound with the flop
   rate it assumes (the many-row kernel's tensor-core rate for the paged
   prefill and flash attention, 3xTF32 for f32);
3q. quantized pools: the three paged kernels on int8 and on fp8 pools
   (phase 3's pools quantized per token and KV head, with f32 scale pools)
   against their plain versions, which dequantize the same values --
   decode T = 1 and 4 and split-K 2 at both position sets, windows 0 and
   1024; prefill chunks of 256 rows at 3840 (windows 0, 1024) and of 104
   at 4096 (windows 0, 200) -- then timed as in phase 3, the library call
   being SDPA on pools dequantized and gathered outside the timed call,
   and the byte bound counting 1-byte values and 4-byte scales;
4. engine, dense cache: internlm2-1.8b at full width (24 layers, seeded
   random f32 weights, f32 cache) served by ``ServeEngine`` in continuous
   mode -- short requests plus one ~4200-token prompt, so the split-K
   autotuner engages -- then a short wave-mode trace; both dense kernels
   must have been launched by the serving run, and one decode step's
   logits through the kernels must match the plain path, and with 2
   splits equal those of the single pass bitwise; one decode tick
   is timed, single pass against split-K, over alternating rounds, and its
   device time is broken down by kernel with ``torch.profiler``;
4b. engine, paged pool (``cache="paged"``, 16-token pages, prefix cache):
   the same model serves a 4200-token prompt A and three short ones, then
   B = A[:4096] + 50 fresh tokens, which must hit the prefix cache; the
   three paged kernels must have been launched and the dense ones not; B
   served alone with the prefix cache off must give the same tokens; one
   paged decode step's and one paged prefill chunk's logits through the
   kernels must match the plain path; a paged decode tick is timed and
   profiled as in phase 4;
4c. engine, quantized pools: phase 4b's trace and checks with
   ``kv_dtype="int8"`` and then ``"fp8"``; the pools must be int8 /
   float8_e4m3fn with f32 scale leaves, and the logits of one decode step
   and one prefill chunk through the kernels must match the plain path on
   the same quantized pools; tokens/s, TTFT, the pool's bytes and its
   pages per GiB against phase 4b's f32 pool are printed, and a decode
   tick is timed and profiled;
3c. whole-sequence kernels: flash attention (B=2, S=4096, H=16, KV=8,
   D=128; causal with window 0 and 1024, not causal at S=1024, one bf16
   case, and S=1000, no multiple of the tiles, causal and not causal with
   window 300) and the SSD chunk (mamba2-1.3b's B=2, NC=16, NH=64, Q=256,
   hp=64, ds=128, G=1, the prefill's B=4, NC=8, a G=2 case, and Q=160
   with ds=96, f32; the first shape in bf16) against their plain versions,
   a batch row and a chunk alone against them in the batch, bitwise, then
   timed against the plain version, SDPA (flash attention only) and the
   bound (the SSD chunk's at its route's tensor-core rate, with the
   CUDA-core bound beside it);
5. the attention forward path: internlm2-1.8b's ``make_prefill_step`` on
   2 prompts x 4096 tokens must launch flash attention 24 times; its
   last-row logits must match the plain path and the dense engine's
   chunked prefill of the same prompt; the prefill is timed and profiled;
6. the SSM path: internlm2 is freed and mamba2-1.3b built at full width
   and depth (48 layers, seeded f32 weights); ``make_prefill_step`` on 4
   prompts x 2048 tokens must launch the SSD kernel 48 times, its logits
   must match the plain path, 32 greedy decode steps follow from its
   states; one 128-token prompt's prefill-then-decode logits must match
   the token-fed path the engine runs; ``ServeEngine`` serves mamba2 in
   continuous mode (more requests than slots, a reused slot checked
   against a fresh engine) and in wave mode; the prefill and a decode tick
   are timed and profiled.

The last lines are the nvidia-smi line, a JSON ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when CUDA is unavailable or anything fails.
"""
from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# The many-row kernel (#4, #6) multiplies on the tensor cores: f32 operands
# as three TF32 products (3xTF32, f32-accurate), so f32 work runs at most at
# a third of the 495 TFLOP/s TF32 rate; bf16 q and K/V at the bf16 rate.
TF32X3_FLOPS = 495e12 / 3
# int8 and e4m3 values are exact in TF32, so an f32-accurate product of f32
# q (or p) with a quantized pool's raw K (or V) takes two TF32 products
# (big and small part of the f32 side), the per-key scale applied outside.
TF32X2_FLOPS = 495e12 / 2
BF16_TC_FLOPS = 989e12
RATE_NAMES = {F32_FLOPS: "f32 CUDA cores, 67 TFLOP/s",
              TF32X3_FLOPS: "3xTF32 tensor cores, 165 TFLOP/s",
              TF32X2_FLOPS: "2xTF32 tensor cores, 247.5 TFLOP/s",
              BF16_TC_FLOPS: "bf16 tensor cores, 989 TFLOP/s"}
H, KV, D, B, S = 16, 8, 128, 4, 8192
POS = [-1, 1000, 4200, S - 1]
# the decode kernel's chunk boundaries (256 keys): the last key of a
# chunk, the first, the second, beside the row's last position
POS_EDGES = [255, 256, 257, S - 1]
PAGE, N_PAGES = 16, 2049  # the paged engine's default pool: 4 * 512 + 1
MAX_PAGES = S // PAGE
CHUNK = 256  # the engines' prefill chunk
RAGGED = 4200 - 4096  # the last chunk of a 4200-token prompt
# Kernel against plain version.  With these inputs (randn q, k, v) the
# scores have unit spread, so an output is a softmax average over n = 1k-8k
# keys: |out| ~ sqrt(e / n) ~ 0.02-0.05, at most ~0.2; a parked slot's are
# 0.  Leaving out one 32-key tile moves an output by ~9.3 / n rms (1e-3 at
# n = 8192, 9e-3 at n = 1000), so each tolerance stays below that.
# - f32 cache: both sides accumulate in f32 in other orders (tiled online
#   softmax against one full softmax); measured <= 2.7e-7.  The paged
#   prefill and the flash attention multiply on the tensor cores, each f32
#   product as three TF32 products (3xTF32, ~2^-21 relative) summed by the
#   mma's truncating f32 accumulation; measured <= 4.7e-6.  One TF32 product
#   alone (~2^-11) fails this tolerance.
# - bf16 cache: the kernel rounds p to bf16 before the PV product, as the
#   TPU kernel does, where the plain version keeps p in f32; measured
#   2.9e-4 to 3.3e-4 on an H100.  Rounding p on the plain side would not
#   match the kernel, which rounds exp(s - running max) tile by tile.
# - bf16 q (and so a bf16 output): both sides round an f32 result to bf16,
#   and a value next to a rounding boundary may round either way, so one
#   bf16 ulp of the output (<= 2^-7 |out|) is added.
# - paged kernels: the same arithmetic as the dense ones, so the same
#   bounds at the same positions.  A prefill row, though, may attend only a
#   few keys (row t of the chunk at offset 0 sees t + 1), where rounding p
#   to bf16 moves the output by up to 2^-9 * sum_k p_k |v_k| / l per
#   element; with a bf16 pool that bound (doubled), computed by the plain
#   version on |v|, is added to the prefill's tolerance.
# - int8 / fp8 pools: the kernels and the plain versions dequantize the same
#   stored values with the same scales (float(x) * scale, one f32 rounding,
#   bitwise the same values) and keep p in f32, so what differs is the f32
#   summation order, as with an f32 pool.
TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-3, torch.int8: 5e-5,
       torch.float8_e4m3fn: 5e-5}
BF16_ULP = 2.0 ** -7
# Logits after 24 layers: each layer's attention differs by ~1e-6, which
# the residual stream carries through to the unembedding.
LOGIT_TOL = 1e-3
# mamba2, the same prompt by two routes (one chunked-SSD prefill against
# 128 single-token recurrence steps): f32 both ways, the state summed in
# other orders over 48 layers.
SSM_FEED_TOL = 1e-3


def _log(msg):
    print(msg, flush=True)


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"[device] {name}; nvidia-smi: {smi}; "
         f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
         f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name, smi


def _ptxas_report(log):
    """{kernel: (registers, stack bytes, spill store bytes, spill load
    bytes)} from an ``nvcc -Xptxas -v`` log, names demangled where
    ``c++filt`` is installed."""
    found, cur = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            cur = line.split("Function properties for ")[1].strip()
            found[cur] = [None, 0, 0, 0]
        elif cur and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            found[cur][1:] = nums[:3]
        elif cur and "Used " in line and " registers" in line:
            found[cur][0] = int(line.split("Used ")[1].split()[0])
            cur = None
    names = list(found)
    with contextlib.suppress(OSError):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    return {n.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0]: tuple(v) for n, v in zip(names, found.values())}


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    _log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
         f"(nvcc: {_build.build_seconds})")
    spills = []
    for src, log in sorted(_build.build_logs.items()):
        for kern, (regs, stack, st, ld) in sorted(_ptxas_report(log).items()):
            _log(f"[build] ptxas {src}: {kern}: {regs} registers, {stack} B "
                 f"stack, {st} B spill stores, {ld} B spill loads")
            if st or ld:
                spills.append(kern)
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


SPIN_CYCLES = 2_000_000  # ~1 ms of the card's clock


def _time_ms(fn, iters=20, warmup=3, queued=True):
    """Median of ``iters`` CUDA-event timings of ``fn``.  ``queued``: a
    ~1 ms spin kernel (``torch.cuda._sleep``) goes ahead of each start
    event, so the host enqueues ``fn`` while the card spins and the events
    see ``fn``'s device time alone (a kernel of tens of microseconds would
    otherwise read the host's launch work).  The engine ticks, which the
    host bounds, are timed with ``queued=False``: host time included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _inputs(t, q_dtype, kv_dtype, seed=0, positions=POS):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, t, H, D), generator=g, device="cuda").to(q_dtype)
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(kv_dtype)
    v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(kv_dtype)
    return q, k, v, torch.tensor(positions, dtype=torch.int32, device="cuda")


def _check(label, got, want, kv_dtype, p_round=None):
    """Max abs error of ``got`` against ``want``; raises past the tolerance
    of the cache dtype (plus one bf16 ulp of ``want`` for a bf16 output,
    plus ``p_round``, the bound on rounding p to bf16, where given)."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = TOL[kv_dtype]
    limit = tol + (BF16_ULP * want.abs() if got.dtype == torch.bfloat16
                   else 0.0)
    extra = " + 2^-7 |want|" if got.dtype == torch.bfloat16 else ""
    if p_round is not None:
        limit = limit + p_round.float()
        extra += " + 2^-8 attn(|v|)"
    worst = float(err.max())
    _log(f"[kernels] {label}: max_abs_err {worst:.3g} (tol {tol}{extra})")
    if not bool((err <= limit).all()):
        raise AssertionError(f"{label} disagrees with its plain version")
    return worst


def _library_call(q, k, v, pos):
    """One PyTorch call computing the same function (GQA heads expanded
    and a boolean mask prepared outside the timed call)."""
    qt = q.transpose(1, 2)
    kx = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vx = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    kpos = torch.arange(S, device="cuda")
    mask = (kpos[None, :] <= pos[:, None].long())[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask)


def _bound(t_ops, t_bytes, rate):
    """(bound ms, what bounds it, the flop rate used); ``rate`` is a key of
    ``RATE_NAMES`` or, for mixed rates, their description."""
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", RATE_NAMES.get(rate, rate))


def _tc_rate(q, k):
    """The least-time flop rate of the many-row kernel's work for these
    operand dtypes: bf16 at the bf16 rate, a quantized (1-byte) pool at the
    2xTF32 rate, f32 at the 3xTF32 rate."""
    if q.dtype == k.dtype == torch.bfloat16:
        return BF16_TC_FLOPS
    return TF32X2_FLOPS if k.element_size() == 1 else TF32X3_FLOPS


def _scale_bytes(k):
    """Bytes of a pool's scales per key and KV head: one f32 for a
    quantized (1-byte) pool, none for f32/bf16."""
    return 4 if k.element_size() == 1 else 0


def _bound_ms(q, k, pos, paged=False):
    """Least time for the work these inputs need: the live K/V prefix of
    the active slots read once (``paged``: and the page-table entries that
    map it; a quantized, 1-byte pool: and its f32 scale per key and KV
    head), q read and the output written once, against the card's memory
    rate; and QK + PV flops against its f32 rate (the decode kernels run
    on the CUDA cores)."""
    live = sum(p + 1 for p in pos.tolist() if p >= 0)
    kv_bytes = 2 * live * KV * (D * k.element_size() + _scale_bytes(k))
    io_bytes = 2 * q.numel() * q.element_size() + 4 * len(pos)
    if paged:
        io_bytes += 4 * sum(-(-(p + 1) // PAGE) for p in pos.tolist()
                            if p >= 0)
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * live * H * D * q.shape[1] / F32_FLOPS * 1e3
    return _bound(t_ops, t_bytes, F32_FLOPS)


def phase_kernels():
    """The dense decode kernels (#1, #2: the chunked decode kernel in its
    dense mode) against their plain versions at both position sets, a
    slot alone against the batch and split-K against the single pass,
    bitwise, then timed at the dense engine's shapes."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.ops import decode_attention_plain

    errs = {"decode_attention": 0.0, "decode_attention_splitk": 0.0}
    cases = [(t, w, qd, kd) for t in (1, 4) for w in (0, 1024)
             for qd, kd in ((torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16))]
    cases.append((1, 0, torch.bfloat16, torch.bfloat16))
    for positions in (POS, POS_EDGES):
        for t, window, qd, kd in cases:
            q, k, v, pos = _inputs(t, qd, kd, positions=positions)
            err = _check(f"decode_attention pos={positions} T={t} "
                         f"window={window} q={qd} cache={kd}",
                         decode_attention_cuda(q, k, v, pos, window=window),
                         decode_attention_plain(q, k, v, pos,
                                                window=window), kd)
            if kd == torch.float32:
                errs["decode_attention"] = max(errs["decode_attention"], err)
        for window, kd in ((0, torch.float32), (1024, torch.float32),
                           (0, torch.bfloat16)):
            q, k, v, pos = _inputs(1, torch.float32, kd, positions=positions)
            one = decode_attention_cuda(q, k, v, pos, window=window)
            for ns in (2, 4, 8):
                got = decode_attention_splitk_cuda(q, k, v, pos,
                                                   window=window,
                                                   num_splits=ns)
                err = _check(
                    f"decode_attention_splitk pos={positions} ns={ns} "
                    f"window={window} cache={kd}", got,
                    decode_attention_plain(q, k, v, pos, window=window,
                                           num_splits=ns), kd)
                if kd == torch.float32:
                    errs["decode_attention_splitk"] = max(
                        errs["decode_attention_splitk"], err)
                same = torch.equal(got, one)
                _log(f"[kernels] decode_attention_splitk pos={positions} "
                     f"ns={ns} window={window} cache={kd}: equals "
                     f"decode_attention bitwise: {same}")
                if not same:
                    raise AssertionError("dense split-K with whole-chunk "
                                         "splits differs from the single "
                                         "pass")

    def dense(t, positions):
        q, k, v, pos = _inputs(t, torch.float32, torch.float32,
                               positions=positions)
        return (q, k, v, pos), (q[3:], k[3:], v[3:], pos[3:])

    _check_slot_alone("decode_attention", dense, decode_attention_cuda,
                      decode_attention_splitk_cuda)
    torch.cuda.synchronize()

    # times at the engine's decode shapes: T = 1, f32 cache, no window; the
    # autotuner gives split-K 2 splits at these positions
    q, k, v, pos = _inputs(1, torch.float32, torch.float32)
    for ns in (1, 2):
        work, grid = _working_ctas(pos, ns, S, 1)
        _log(f"[kernels] dense decode at pos {POS}, {ns} split(s): {work} "
             f"working CTAs of a {grid}-CTA grid")
    bound = _bound_ms(q, k, pos)
    lib_ms = _time_ms(_library_call(q, k, v, pos))
    rows = []
    for name, run, plain, replaces in (
            ("decode_attention",
             lambda: decode_attention_cuda(q, k, v, pos),
             lambda: decode_attention_plain(q, k, v, pos),
             "src/repro/kernels/decode_attention.py:131"),
            ("decode_attention_splitk",
             lambda: decode_attention_splitk_cuda(q, k, v, pos,
                                                  num_splits=2),
             lambda: decode_attention_plain(q, k, v, pos, num_splits=2),
             "src/repro/kernels/decode_attention.py:236")):
        rows.append(_timed_row(
            name, run, plain, lib_ms, bound,
            "src/repro_torch/kernels/csrc/decode_attention.cu", replaces,
            errs[name]))
    return rows


def _paged_inputs(t, q_dtype, kv_dtype, seed=0, chunk=0, positions=POS):
    """q (B, t, H, D) -- or one slot's chunk (1, chunk, H, D) -- random
    pools (N_PAGES, PAGE, KV, D) (the null page too), a (B, MAX_PAGES)
    page table drawn from a random permutation of pages 1..N_PAGES-1 and
    ``positions``; decode rows map only the pages up to each slot's last
    query position, the rest are the null page 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((1, chunk, H, D) if chunk else (B, t, H, D),
                    generator=g, device="cuda").to(q_dtype)
    k = torch.randn((N_PAGES, PAGE, KV, D), generator=g,
                    device="cuda").to(kv_dtype)
    v = torch.randn((N_PAGES, PAGE, KV, D), generator=g,
                    device="cuda").to(kv_dtype)
    perm = torch.randperm(N_PAGES - 1, generator=g, device="cuda") + 1
    table = perm[:B * MAX_PAGES].reshape(B, MAX_PAGES).to(torch.int32)
    if not chunk:
        for b, p in enumerate(positions):
            mapped = -(-(p + t) // PAGE) if p >= 0 else 0
            table[b, mapped:] = 0
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, k, v, table.contiguous(), pos


def _working_ctas(pos, num_splits, max_pages=MAX_PAGES, page_size=PAGE):
    """CTAs of the chunked decode kernel (T = 1, no window) that hold keys
    their slot sees, and the grid's KV x B x chunks; a dense cache is
    ``max_pages`` = S pages of one token."""
    from repro_torch.kernels.decode_attention import decode_chunks

    _, _, ranges = decode_chunks(max_pages, page_size, num_splits)
    work = sum(lo <= p for p in pos.tolist() for lo, hi in ranges if lo < hi)
    return KV * work, KV * len(pos) * len(ranges)


def _check_slot_alone(name, inputs, decode, splitk):
    """Slot 3's output computed alone equals, bitwise, its output in the
    batch of four, for the single-pass kernel (T = 1 and 4) and split-K
    (2 splits), at both position sets.  ``inputs(t, positions)`` gives the
    batch's arguments and slot 3's."""
    for positions in (POS, POS_EDGES):
        for label, t, run in (
                (name, 1, decode), (name, 4, decode),
                (f"{name}_splitk ns=2", 1,
                 functools.partial(splitk, num_splits=2))):
            args, alone_args = inputs(t, positions)
            batch = run(*args)
            alone = run(*alone_args)
            same = torch.equal(alone[0], batch[3])
            _log(f"[kernels] {label} pos={positions} T={t}: slot 3 alone "
                 f"equals it in the batch bitwise: {same}")
            if not same:
                raise AssertionError(f"a slot's {name} output depends on "
                                     f"the rest of the batch")


def _paged_library_call(q, k, v, table, pos):
    """One SDPA call on the already gathered dense view (the gather is not
    in the timed call), GQA heads expanded, with a boolean mask."""
    kd = k[table.long()].reshape(B, S, KV, D)
    vd = v[table.long()].reshape(B, S, KV, D)
    return _library_call(q, kd, vd, pos)


def _prefill_bound_ms(q, k, q_offset):
    """Least time of one chunk: its causal QK + PV flops at the tensor-core
    rate of ``_tc_rate`` against the live K/V prefix (a quantized pool: and
    its f32 scales), q and the output at the card's memory rate."""
    c = q.shape[1]
    keys = c * q_offset + c * (c + 1) // 2  # (row, key) pairs attended
    rate = _tc_rate(q, k)
    t_ops = 4 * H * D * keys / rate * 1e3
    kv_bytes = 2 * (q_offset + c) * KV * (D * k.element_size()
                                          + _scale_bytes(k))
    io_bytes = 2 * q.numel() * q.element_size() + 4 * (q_offset + c) // PAGE
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    return _bound(t_ops, t_bytes, rate)


def _prefill_library_call(q, k, v, row, q_offset):
    """One SDPA call on the slot's gathered prefix [0, q_offset + C) (the
    gather is not in the timed call), with the causal mask at the
    offset."""
    c = q.shape[1]
    n = q_offset + c
    kd = k[row.long()].reshape(1, S, KV, D)[:, :n]
    vd = v[row.long()].reshape(1, S, KV, D)[:, :n]
    qt = q.transpose(1, 2)
    kx = kd.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vx = vd.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    qpos = q_offset + torch.arange(c, device="cuda")
    mask = torch.arange(n, device="cuda")[None, :] <= qpos[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask)


def phase_paged_kernels():
    """The three paged kernels against their plain versions, then timed at
    the paged engine's shapes: T = 1 decode and split-K 2 at the dense
    phase's positions, and a 256-row prefill chunk at offset 3840."""
    from repro_torch.kernels.ops import (paged_decode_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)

    errs = {"paged_decode_attention": 0.0,
            "paged_decode_attention_splitk": 0.0,
            "paged_prefill_attention": 0.0}
    for positions in (POS, POS_EDGES):
        for t in (1, 4):
            for window in (0, 1024):
                for kd in (torch.float32, torch.bfloat16):
                    q, k, v, table, pos = _paged_inputs(
                        t, torch.float32, kd, positions=positions)
                    err = _check(
                        f"paged_decode_attention pos={positions} T={t} "
                        f"window={window} pool={kd}",
                        paged_decode_attention_cuda(q, k, v, table, pos,
                                                    window=window),
                        paged_decode_attention_plain(q, k, v, table, pos,
                                                     window=window), kd)
                    if kd == torch.float32:
                        errs["paged_decode_attention"] = max(
                            errs["paged_decode_attention"], err)
        for ns in (2, 4, 8):
            for window, kd in ((0, torch.float32), (1024, torch.float32),
                               (0, torch.bfloat16)):
                q, k, v, table, pos = _paged_inputs(1, torch.float32, kd,
                                                    positions=positions)
                err = _check(
                    f"paged_decode_attention_splitk pos={positions} "
                    f"ns={ns} window={window} pool={kd}",
                    paged_decode_attention_splitk_cuda(
                        q, k, v, table, pos, window=window,
                        num_splits=ns),
                    paged_decode_attention_plain(q, k, v, table, pos,
                                                 window=window,
                                                 num_splits=ns), kd)
                if kd == torch.float32:
                    errs["paged_decode_attention_splitk"] = max(
                        errs["paged_decode_attention_splitk"], err)
    def paged(t, positions):
        q, k, v, table, pos = _paged_inputs(t, torch.float32, torch.float32,
                                            positions=positions)
        return (q, k, v, table, pos), (q[3:], k, v, table[3:], pos[3:])

    _check_slot_alone("paged_decode_attention", paged,
                      paged_decode_attention_cuda,
                      paged_decode_attention_splitk_cuda)
    slot = B - 1  # a fully mapped row
    # full chunks at offsets 0 and 3840 (the latter split over the key
    # range), and the engine's ragged last chunk of a 4200-token prompt
    # (C = 104 at 4096), also under a window shorter than the chunk's span
    prefill_cases = [(CHUNK, q_offset, window)
                     for q_offset in (0, S // 2 - CHUNK)
                     for window in (0, 1024)]
    prefill_cases += [(RAGGED, S // 2, window) for window in (0, 200)]
    for c, q_offset, window in prefill_cases:
        for kd in (torch.float32, torch.bfloat16):
            q, k, v, table, _ = _paged_inputs(1, torch.float32, kd,
                                              chunk=c)
            p_round = None
            if kd == torch.bfloat16:
                p_round = 2.0 ** -8 * paged_prefill_attention_plain(
                    q, k, v.abs(), table, slot, q_offset, window=window)
            err = _check(
                f"paged_prefill_attention C={c} q_offset={q_offset} "
                f"window={window} pool={kd}",
                paged_prefill_attention_cuda(q, k, v, table[slot],
                                             q_offset, window=window),
                paged_prefill_attention_plain(q, k, v, table, slot,
                                              q_offset, window=window),
                kd, p_round)
            if kd == torch.float32:
                errs["paged_prefill_attention"] = max(
                    errs["paged_prefill_attention"], err)
    torch.cuda.synchronize()

    # times at the paged engine's shapes: f32 pool, no window
    src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    rows = []
    q, k, v, table, pos = _paged_inputs(1, torch.float32, torch.float32)
    for ns in (1, 2):
        work, grid = _working_ctas(pos, ns)
        _log(f"[kernels] paged decode at pos {POS}, {ns} split(s): {work} "
             f"working CTAs of a {grid}-CTA grid")
    bound = _bound_ms(q, k, pos, paged=True)
    lib_ms = _time_ms(_paged_library_call(q, k, v, table, pos))
    for name, run, plain, line in (
            ("paged_decode_attention",
             lambda: paged_decode_attention_cuda(q, k, v, table, pos),
             lambda: paged_decode_attention_plain(q, k, v, table, pos),
             131),
            ("paged_decode_attention_splitk",
             lambda: paged_decode_attention_splitk_cuda(
                 q, k, v, table, pos, num_splits=2),
             lambda: paged_decode_attention_plain(q, k, v, table, pos,
                                                  num_splits=2),
             325)):
        rows.append(_timed_row(name, run, plain, lib_ms, bound, src,
                               f"src/repro/kernels/paged_attention.py:"
                               f"{line}", errs[name]))
    q_offset = S // 2 - CHUNK
    q, k, v, table, _ = _paged_inputs(1, torch.float32, torch.float32,
                                      chunk=CHUNK)
    bound = _prefill_bound_ms(q, k, q_offset)
    lib_ms = _time_ms(_prefill_library_call(q, k, v, table[slot], q_offset))
    rows.append(_timed_row(
        "paged_prefill_attention",
        lambda: paged_prefill_attention_cuda(q, k, v, table[slot], q_offset),
        lambda: paged_prefill_attention_plain(q, k, v, table, slot,
                                              q_offset),
        lib_ms, bound, src, "src/repro/kernels/paged_attention.py:228",
        errs["paged_prefill_attention"]))
    return rows


QUANT = ("int8", "fp8")  # the quantized pools' kv_dtype names


def _quant_paged_inputs(t, name, chunk=0, positions=POS):
    """``_paged_inputs``' f32 pools quantized per token and KV head as the
    engine writes them: (q, k, v, k_scale, v_scale, table, pos)."""
    from repro_torch.models.attention import KV_QUANT_DTYPES, quantize_kv

    q, k, v, table, pos = _paged_inputs(t, torch.float32, torch.float32,
                                        chunk=chunk, positions=positions)
    (kq, ks), (vq, vs) = (quantize_kv(x, KV_QUANT_DTYPES[name])
                          for x in (k, v))
    return q, kq, vq, ks, vs, table, pos


def phase_quant_kernels():
    """The three paged kernels on int8 and fp8 pools (their scale branch)
    against their plain versions at phase 3's shapes, then timed at the
    paged engine's: T = 1 decode and split-K 2 at POS, and the 256-row
    prefill chunk at offset 3840.  The library call is SDPA on the pools
    dequantized and gathered outside the timed call."""
    from repro_torch.kernels.ops import (paged_decode_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)
    from repro_torch.models.attention import dequantize_kv

    src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    slot = B - 1
    rows = []
    for name in QUANT:
        errs = {"paged_decode_attention": 0.0,
                "paged_decode_attention_splitk": 0.0,
                "paged_prefill_attention": 0.0}
        for positions in (POS, POS_EDGES):
            for t, ns, window in ((1, 1, 0), (1, 1, 1024), (4, 1, 0),
                                  (4, 1, 1024), (1, 2, 0), (1, 2, 1024)):
                q, k, v, ks, vs, table, pos = _quant_paged_inputs(
                    t, name, positions=positions)
                sc = dict(k_scale=ks, v_scale=vs, window=window)
                if ns == 1:
                    kname = "paged_decode_attention"
                    got = paged_decode_attention_cuda(q, k, v, table, pos,
                                                      **sc)
                else:
                    kname = "paged_decode_attention_splitk"
                    got = paged_decode_attention_splitk_cuda(
                        q, k, v, table, pos, num_splits=ns, **sc)
                want = paged_decode_attention_plain(q, k, v, table, pos,
                                                    num_splits=ns, **sc)
                errs[kname] = max(errs[kname], _check(
                    f"{kname} pos={positions} T={t} ns={ns} "
                    f"window={window} pool={name}", got, want, k.dtype))
        for c, q_offset, window in ((CHUNK, S // 2 - CHUNK, 0),
                                    (CHUNK, S // 2 - CHUNK, 1024),
                                    (RAGGED, S // 2, 0),
                                    (RAGGED, S // 2, 200)):
            q, k, v, ks, vs, table, _ = _quant_paged_inputs(1, name,
                                                            chunk=c)
            sc = dict(k_scale=ks, v_scale=vs, window=window)
            errs["paged_prefill_attention"] = max(
                errs["paged_prefill_attention"], _check(
                    f"paged_prefill_attention C={c} q_offset={q_offset} "
                    f"window={window} pool={name}",
                    paged_prefill_attention_cuda(q, k, v, table[slot],
                                                 q_offset, **sc),
                    paged_prefill_attention_plain(q, k, v, table, slot,
                                                  q_offset, **sc), k.dtype))
        torch.cuda.synchronize()

        q, k, v, ks, vs, table, pos = _quant_paged_inputs(1, name)
        sc = dict(k_scale=ks, v_scale=vs)
        bound = _bound_ms(q, k, pos, paged=True)
        lib_ms = _time_ms(_paged_library_call(
            q, dequantize_kv(k, ks), dequantize_kv(v, vs), table, pos))
        for kname, run, plain, line in (
                ("paged_decode_attention",
                 lambda: paged_decode_attention_cuda(q, k, v, table, pos,
                                                     **sc),
                 lambda: paged_decode_attention_plain(q, k, v, table, pos,
                                                      **sc), 131),
                ("paged_decode_attention_splitk",
                 lambda: paged_decode_attention_splitk_cuda(
                     q, k, v, table, pos, num_splits=2, **sc),
                 lambda: paged_decode_attention_plain(
                     q, k, v, table, pos, num_splits=2, **sc), 325)):
            rows.append(_timed_row(
                f"{kname}_{name}", run, plain, lib_ms, bound, src,
                f"src/repro/kernels/paged_attention.py:{line}", errs[kname]))
        q_offset = S // 2 - CHUNK
        q, k, v, ks, vs, table, _ = _quant_paged_inputs(1, name, chunk=CHUNK)
        sc = dict(k_scale=ks, v_scale=vs)
        bound = _prefill_bound_ms(q, k, q_offset)
        lib_ms = _time_ms(_prefill_library_call(
            q, dequantize_kv(k, ks), dequantize_kv(v, vs), table[slot],
            q_offset))
        rows.append(_timed_row(
            f"paged_prefill_attention_{name}",
            lambda: paged_prefill_attention_cuda(q, k, v, table[slot],
                                                 q_offset, **sc),
            lambda: paged_prefill_attention_plain(q, k, v, table, slot,
                                                  q_offset, **sc),
            lib_ms, bound, src, "src/repro/kernels/paged_attention.py:228",
            errs["paged_prefill_attention"]))
        for row in rows[-3:]:
            row["dtype"] = name
    return rows


def _timed_row(name, run, plain, lib_ms, bound, source, replaces, err):
    """Times of the kernel and its plain version; ``bound`` is
    ``_bound``'s (ms, what bounds it, the flop rate used)."""
    bound, bound_by, rate = bound
    ms = _time_ms(run)
    plain_ms = _time_ms(plain)
    lib = ("none (no single PyTorch call)" if lib_ms is None
           else f"{lib_ms:.4f} ms")
    _log(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
         f"library {lib}, bound {bound:.4f} ms by {bound_by}; flops at "
         f"{rate})")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms}


@contextlib.contextmanager
def _plain_attention():
    """Route the model's kernels (dense decode, paged decode, paged
    prefill, flash attention, SSD chunk) through the plain versions for
    CUDA tensors (for the logits comparisons only)."""
    from repro_torch.kernels import ops

    names = ("decode_attention", "paged_decode_attention",
             "paged_prefill_attention", "flash_attention", "ssd_chunk")
    kernel_paths = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, getattr(ops, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in kernel_paths.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def _first_call_args(name):
    """Record the arguments of the first call the model makes to
    ``ops.<name>`` (the call itself goes through unchanged)."""
    from repro_torch.kernels import ops

    fn, seen = getattr(ops, name), []

    def record(*args, **kwargs):
        if not seen:
            seen.append(args)
        return fn(*args, **kwargs)

    setattr(ops, name, record)
    try:
        yield seen
    finally:
        setattr(ops, name, fn)


def _profile_tick(run, label, ticks=3, top=8):
    """Device time of ``run`` by kernel under ``torch.profiler``: the
    kernels that took the most, and the share of the window the card was
    busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not by_kernel:
        _log(f"[profile] {label}: not measured (the profiler saw no "
             f"device kernels)")
        return
    busy = sum(us for us, _ in by_kernel.values())
    _log(f"[profile] {label}: {wall / ticks * 1e3:.3f} ms per tick under "
         f"the profiler, device kernels {busy / ticks / 1e3:.3f} ms per "
         f"tick, busy {busy / (wall * 1e6):.3f} of the window")
    for name, (us, n) in sorted(by_kernel.items(), key=lambda kv: kv[1][0],
                                reverse=True)[:top]:
        _log(f"[profile]   {us / ticks / 1e3:8.3f} ms/tick {n / ticks:6.1f} "
             f"launches/tick  {name[:90]}")


def _all_kernels():
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)

    return (decode_attention_cuda, decode_attention_splitk_cuda,
            paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
            paged_prefill_attention_cuda)


def _time_ticks(ticks, label):
    """One decode tick per fan-out in ``ticks`` ({splits: run}), timed over
    alternated rounds (1, 2, 2, 1, 1, 2; median of 10 each), then each
    under the profiler."""
    readings = {s: [] for s in ticks}
    for splits in (1, 2, 2, 1, 1, 2):
        readings[splits].append(_time_ms(ticks[splits], iters=10, warmup=2,
                                         queued=False))
    for splits, ms in readings.items():
        _log(f"[engine] {label}, splits={splits}: "
             f"{', '.join(f'{x:.3f}' for x in ms)} ms (median of 10 each)")
    for splits, run in ticks.items():
        _profile_tick(run, f"{label} splits={splits}")


def make_model():
    from repro_torch.configs import get_config
    from repro_torch.models import LM, RuntimeKnobs

    cfg = get_config("internlm2-1.8b")
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    _log(f"[engine] {cfg.name}: {cfg.num_layers} layers d_model "
         f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} vocab "
         f"{cfg.vocab_size}; init {time.perf_counter() - t0:.1f}s")
    return model, params


def phase_engine(model, params):
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine
    from repro_torch.runtime.steps import compiled_step

    kernels = _all_kernels()
    cfg = model.cfg

    rng = np.random.default_rng(0)
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=S,
                                                 prefill_chunk=256))
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(
        np.int32), max_new_tokens=m)
        for i, (n, m) in enumerate(((4200, 16), (17, 24), (64, 24),
                                    (200, 24), (33, 8)))]
    handles = [eng.submit(r) for r in reqs]
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    toks = sum(len(r.output) for r in done)
    ttft = sorted(h.metrics()["ttft_s"] for h in handles)
    _log(f"[engine] dense continuous: {len(done)}/{len(reqs)} requests, {toks} "
         f"tokens in {wall:.3f}s = {toks / wall:.2f} tok/s; ttft p50 "
         f"{statistics.median(ttft) * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} "
         f"ms; launches {launches}")
    if len(done) != len(reqs) or not all(
            len(r.output) == r.max_new_tokens for r in done):
        raise AssertionError("continuous run did not finish every request")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
        raise AssertionError("token outside the vocabulary")
    if min(launches["decode_attention_cuda"],
           launches["decode_attention_splitk_cuda"]) <= 0 \
            or any(n.startswith("paged") and c for n, c in launches.items()):
        raise AssertionError(f"dense run: a dense kernel was not launched, "
                             f"or a paged one was: {launches}")

    # one decode step, kernels against the plain path, on the run's cache
    toks_in = torch.tensor([[5], [6], [7], [8]], device="cuda")
    pos = np.array([4300, 300, -1, 4200], np.int32)
    logits = {}
    for splits in (1, 2):
        step = compiled_step(model, "decode_one", decode_splits=splits)
        got, _ = step(params, eng.caches, toks_in, pos)
        logits[splits] = got
        with _plain_attention():
            want, _ = step(params, eng.caches, toks_in, pos)
        err = float((got - want).abs().max())
        _log(f"[engine] decode logits, kernels vs plain (splits={splits}): "
             f"max_abs_err {err:.3g} (tol {LOGIT_TOL}); |logits| max "
             f"{float(want.abs().max()):.3g}")
        if not (torch.isfinite(got).all() and err <= LOGIT_TOL
                and got.shape == (4, cfg.vocab_size)):
            raise AssertionError("decode logits disagree")
    # S / 2 = 4096 is whole chunks, so split-K is the single pass
    same = torch.equal(logits[1], logits[2])
    _log(f"[engine] decode logits, splits=2 equal splits=1 bitwise: {same}")
    if not same:
        raise AssertionError("split-K decode logits differ from the single "
                             "pass")
    # one whole decode tick (24 layers + unembedding + argmax) at these
    # positions, single pass against split-K 2, alternated over rounds;
    # then each under the profiler
    _time_ticks({s: functools.partial(
        compiled_step(model, "serve", decode_splits=s), params, eng.caches,
        toks_in, pos) for s in (1, 2)},
        f"dense decode tick at pos {pos.tolist()}")
    del eng

    # wave mode: the lockstep baseline runs the single-pass kernel
    wave = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=256,
                                                  mode="wave"))
    for i in range(6):
        wave.submit(Request(100 + i, rng.integers(
            0, cfg.vocab_size, size=5 + i).astype(np.int32),
            max_new_tokens=6))
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    wdone = wave.run()
    torch.cuda.synchronize()
    wwall = time.perf_counter() - t0
    wl = {k.__name__: k.launches for k in kernels}
    wtoks = sum(len(r.output) for r in wdone)
    _log(f"[engine] wave: {len(wdone)}/6 requests, {wtoks} tokens in "
         f"{wwall:.3f}s; launches {wl}")
    if len(wdone) != 6 or wl["decode_attention_cuda"] <= 0:
        raise AssertionError("wave run failed or launched no kernel")
    return {"decode_attention": launches["decode_attention_cuda"],
            "decode_attention_splitk":
                launches["decode_attention_splitk_cuda"]}


def _paged_trace(model, params, label, kv_dtype=""):
    """Serve prompt A (4200 tokens) and three short prompts, then
    B = A[:4096] + 50 fresh tokens once A's pages are registered, through
    ``cache="paged"`` (16-token pages, prefix cache on, ``kv_dtype``).
    Every request must finish with tokens in the vocabulary, B must hit
    the prefix cache, the three paged kernels and no dense one must launch,
    and B served alone with the prefix cache off must give B's tokens.
    Returns (the engine, B's prompt, the paged kernels' launches, the
    pool's bytes per page)."""
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine

    kernels = _all_kernels()
    cfg = model.cfg
    rng = np.random.default_rng(1)
    config = ServeConfig(batch_slots=4, max_len=S, prefill_chunk=CHUNK,
                         cache="paged", page_size=PAGE, kv_dtype=kv_dtype)
    eng = ServeEngine(model, params, config)
    prompt_a = rng.integers(0, cfg.vocab_size, size=4200).astype(np.int32)
    # the 1-token request finishes at its prefill, so B finds a free slot
    reqs = [Request(0, prompt_a, max_new_tokens=16)] + [
        Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                max_new_tokens=m)
        for i, (n, m) in ((1, (17, 24)), (2, (64, 1)), (3, (200, 24)))]
    prompt_b = np.concatenate([prompt_a[:4096], rng.integers(
        0, cfg.vocab_size, size=50).astype(np.int32)])
    req_b = Request(4, prompt_b, max_new_tokens=16)
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    handles = [eng.submit(r) for r in reqs]
    eng.step()  # prefills A (and registers its pages) and the short ones
    handles.append(eng.submit(req_b))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    stats = eng.kv.stats()
    toks = sum(len(r.output) for r in done)
    ttft = sorted(h.metrics()["ttft_s"] for h in handles)
    ttft_b = handles[-1].metrics()["ttft_s"]
    page_bytes = eng.kv_reserved_bytes() / eng.kv.pool.num_pages
    _log(f"[engine] {label} continuous: {len(done)}/5 requests, {toks} "
         f"tokens in {wall:.3f}s = {toks / wall:.2f} tok/s; ttft p50 "
         f"{statistics.median(ttft) * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} "
         f"ms; B (prefix hit) ttft {ttft_b * 1e3:.1f} ms; kv {stats}; pool "
         f"{eng.kv_reserved_bytes()} bytes, {page_bytes:.0f} per page, "
         f"{2 ** 30 / page_bytes:.1f} pages per GiB; launches {launches}")
    finished = [h.req for h in handles]
    if not all(r.done and len(r.output) == r.max_new_tokens
               for r in finished):
        raise AssertionError(f"{label} run did not finish every request")
    if any(not 0 <= t < cfg.vocab_size for r in finished for t in r.output):
        raise AssertionError("token outside the vocabulary")
    if stats["prefix_hits"] < 1:
        raise AssertionError(f"B did not hit the prefix cache: {stats}")
    paged = {n: c for n, c in launches.items() if n.startswith("paged")}
    if min(paged.values()) <= 0 or any(
            c for n, c in launches.items() if not n.startswith("paged")):
        raise AssertionError(f"{label} run: a paged kernel was not "
                             f"launched, or a dense one was: {launches}")

    # B alone, prefix cache off: the prefix-hit prefill read the same K/V
    # from A's pages that B's own prefill writes
    solo = ServeEngine(model, params, ServeConfig(
        batch_slots=4, max_len=S, prefill_chunk=CHUNK, cache="paged",
        page_size=PAGE, prefix_cache=False, kv_dtype=kv_dtype))
    h_solo = solo.submit(Request(5, prompt_b.copy(), max_new_tokens=16))
    solo.run()
    ttft_solo = h_solo.metrics()["ttft_s"]
    _log(f"[engine] {label}: B alone, prefix cache off: ttft "
         f"{ttft_solo * 1e3:.1f} ms (with the hit {ttft_b * 1e3:.1f} ms); "
         f"tokens equal: {h_solo.req.output == req_b.output}")
    if h_solo.req.output != req_b.output:
        raise AssertionError("B's tokens differ with the prefix cache off")
    del solo
    return eng, prompt_b, paged, page_bytes


def _paged_logits_and_tick(eng, params, prompt_b, label):
    """One paged decode step (single pass and split-K 2) and one prefill
    chunk at 3840, kernels against the plain path, on the engine's pools
    through a permuted table of all pages; then a decode tick timed and
    profiled, single pass against split-K 2."""
    from repro_torch.runtime.steps import compiled_step

    model, cfg = eng.model, eng.model.cfg
    g = torch.Generator(device="cuda").manual_seed(2)
    table = (torch.randperm(N_PAGES - 1, generator=g, device="cuda") + 1)[
        :B * MAX_PAGES].reshape(B, MAX_PAGES).to(torch.int32).contiguous()
    toks_in = torch.tensor([[5], [6], [7], [8]], device="cuda")
    pos = np.array([4300, 300, -1, 4200], np.int32)
    chunk = torch.as_tensor(prompt_b[None, :CHUNK].astype(np.int64),
                            device="cuda")
    split2 = type(model)(model.cfg, model.knobs.with_(decode_splits=2),
                         model.device)
    checks = [(f"decode (splits={m.knobs.decode_splits or 1})",
               functools.partial(m.decode_step_paged, params, eng.caches,
                                 toks_in, pos, table, page_size=PAGE))
              for m in (model, split2)]
    checks.append((f"prefill chunk at {S // 2 - CHUNK}", functools.partial(
        model.prefill_chunk_step_paged, params, eng.caches, chunk, 1,
        S // 2 - CHUNK, table, page_size=PAGE)))
    for what, run in checks:
        got = run()[0]
        with _plain_attention():
            want = run()[0]
        err = float((got - want).abs().max())
        _log(f"[engine] {label} {what} logits, kernels vs plain: "
             f"max_abs_err {err:.3g} (tol {LOGIT_TOL}); |logits| max "
             f"{float(want.abs().max()):.3g}")
        if not (torch.isfinite(got).all() and err <= LOGIT_TOL
                and got.shape[-1] == cfg.vocab_size):
            raise AssertionError(f"{label} {what} logits disagree")
    _time_ticks({s: functools.partial(
        compiled_step(model, "paged_serve", page_size=PAGE,
                      decode_splits=s), params, eng.caches, toks_in, pos,
        table) for s in (1, 2)},
        f"{label} decode tick at pos {pos.tolist()}")


def phase_paged_engine(model, params):
    """The same model through ``cache="paged"`` (f32 pools): phase 4b's
    trace, then its logits checks and tick.  Returns the paged kernels'
    launches and the pool's bytes per page."""
    eng, prompt_b, paged, page_bytes = _paged_trace(model, params, "paged")
    _paged_logits_and_tick(eng, params, prompt_b, "paged")
    del eng
    return {n.removesuffix("_cuda"): c for n, c in paged.items()}, page_bytes


def phase_quant_engine(model, params, f32_page_bytes):
    """Phase 4b's trace on int8 and then fp8 pools (``kv_dtype``): the same
    checks, pools of the quantized dtype with f32 scale leaves, logits
    through the kernels against the plain versions on the same quantized
    pools, and the pool's pages per GiB against the f32 pool's.  Returns
    the paged kernels' launches per dtype, keyed as phase 3q's rows."""
    from repro_torch.models.attention import KV_QUANT_DTYPES

    launches = {}
    for name in QUANT:
        eng, prompt_b, paged, page_bytes = _paged_trace(
            model, params, f"paged {name}", kv_dtype=name)
        pools = eng.caches["stack"]
        dtypes = {k: v.dtype for k, v in pools.items()}
        _log(f"[engine] paged {name}: pool leaves {dtypes}; pages per GiB "
             f"{2 ** 30 / page_bytes:.1f} against the f32 pool's "
             f"{2 ** 30 / f32_page_bytes:.1f} "
             f"({f32_page_bytes / page_bytes:.3f}x)")
        want = {"k": KV_QUANT_DTYPES[name], "v": KV_QUANT_DTYPES[name],
                "k_scale": torch.float32, "v_scale": torch.float32}
        if dtypes != want:
            raise AssertionError(f"{name} pools hold {dtypes}, not {want}")
        _paged_logits_and_tick(eng, params, prompt_b, f"paged {name}")
        del eng, pools
        launches.update({f"{n.removesuffix('_cuda')}_{name}": c
                         for n, c in paged.items()})
    return launches


# -------------------------------------------------- whole-sequence kernels
FS, FB = 4096, 2  # flash attention: internlm2 prefill of 2 x 4096
SSD = dict(B=2, NC=16, NH=64, G=1, Q=256, HP=64, DS=128)  # mamba2, S=4096
# SSD chunk against its plain version, f32: the kernel multiplies on the
# tensor cores, each f32 product as three TF32 products (3xTF32: the
# dropped small.small term is <= 2^-22 of the product), summed 32 deep by
# the mma's truncating f32 accumulation and then in f32; the plain version
# sums f32 products in another order.  Emulated on the CPU for mamba2's
# chunk (tests/test_torch_ssd_tf32.py) the 3xTF32 route stays within
# 3.7e-7 of max |want| and one TF32 product misses by 3e-4 to 6e-4, so the
# check bites on the split.
SSD_RTOL = 1e-5
# bf16 x, B, C: the kernel rounds att to bf16 before att @ x, as the TPU
# kernel does, where the plain version keeps att in f32, so y moves by up
# to 2^-9 sum_j |att_ij| |x_j| (bounded with |C| |B| for |C.B^T|, doubled);
# and both sides round y to bf16, where a value next to a boundary may
# round either way (one bf16 ulp, 2^-7 |y|).  The state is f32 from the
# same bf16 values on both sides: SSD_RTOL.
SSD_BF16_ATT = 2.0 ** -8


def _flash_inputs(b, s, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, KV, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def _flash_bound_ms(q, k, causal, window):
    """QK + PV flops (4 D per attended (row, key) pair) at the many-row
    kernel's tensor-core rate, against q, K, V and the output read or
    written once."""
    b, s = q.shape[0], q.shape[1]
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    seen = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if causal:
        seen &= kpos <= qpos
    if window:
        seen &= qpos - kpos < window
    pairs = b * H * int(seen.sum())
    rate = _tc_rate(q, k)
    t_ops = 4 * D * pairs / rate * 1e3
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * k.numel() * k.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return _bound(t_ops, t_bytes, rate)


def _ssd_inputs(B_, NC, NH, G, Q, HP_, DS, seed=0, dtype=torch.float32):
    """Inputs as ``ssm_forward`` makes them, through the same transposed
    views: x and B/C (B, NC, Q, .) activations in ``dtype``, dt in [1e-3,
    1e-1] (the init's softplus range), a in [-16, -1], cum the inclusive
    cumsum of dt * a within each chunk."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (0.5 * torch.randn((B_, NC, Q, NH, HP_), generator=g,
                           device="cuda")).to(dtype)
    bc = (0.5 * torch.randn((B_, NC, Q, G, 2 * DS), generator=g,
                            device="cuda")).to(dtype)
    u = torch.rand((B_, NC, Q, NH), generator=g, device="cuda")
    dt = torch.exp(np.log(1e-3) + (np.log(1e-1) - np.log(1e-3)) * u)
    a = -(1.0 + 15.0 * torch.rand((NH,), generator=g, device="cuda"))
    cum = torch.cumsum(dt * a, dim=2)
    return (x.transpose(2, 3), bc[..., :DS].transpose(2, 3),
            bc[..., DS:].transpose(2, 3), dt.transpose(2, 3),
            cum.transpose(2, 3))


def _ssd_bound_ms(x, b, cuda_cores=False):
    """Products over the lower triangle (the pairs i >= j a chunk needs):
    C.B^T 2 ds flops per pair per (chunk, group), att @ x 2 hp per pair
    per (chunk, head), the state 2 Q ds hp per (chunk, head); against x,
    B, C, dt, cum read once and y, the state written once.  Each product
    at its route's rate: f32 inputs at the 3xTF32 rate; bf16 inputs C.B^T
    and att @ x (bf16 x bf16) at the bf16 rate and the state (f32 B * w
    against bf16 x) at the 2xTF32 rate.  ``cuda_cores``: all at the f32
    CUDA-core rate (the PR 13 design's bound)."""
    bb, nc, nh, q, hp = x.shape
    g, ds = b.shape[2], b.shape[4]
    pairs = q * (q + 1) // 2
    cb = bb * nc * g * 2 * ds * pairs
    att_x = bb * nc * nh * 2 * hp * pairs
    state = bb * nc * nh * 2 * q * ds * hp
    if cuda_cores:
        rate = F32_FLOPS
        t_ops = (cb + att_x + state) / F32_FLOPS * 1e3
    elif x.dtype == torch.float32:
        rate = TF32X3_FLOPS
        t_ops = (cb + att_x + state) / TF32X3_FLOPS * 1e3
    else:
        rate = (f"{RATE_NAMES[BF16_TC_FLOPS]} (C.B^T, att @ x) and "
                f"{RATE_NAMES[TF32X2_FLOPS]} (state)")
        t_ops = ((cb + att_x) / BF16_TC_FLOPS + state / TF32X2_FLOPS) * 1e3
    es = x.element_size()
    nbytes = (2 * x.numel() * es + 2 * b.numel() * es
              + 2 * bb * nc * nh * q * 4 + bb * nc * nh * ds * hp * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return _bound(t_ops, t_bytes, rate)


def _check_ssd(label, got, want, y_extra=None):
    """Max abs error of y and the state, each against SSD_RTOL times its
    plain version's largest magnitude; ``y_extra`` (bf16 inputs) is added
    to y's limit element by element."""
    worst = 0.0
    for name, a, w in (("y", got[0], want[0]), ("state", got[1], want[1])):
        err = (a.float() - w.float()).abs()
        tol = SSD_RTOL * float(w.abs().max())
        limit, extra = tol, ""
        if name == "y" and y_extra is not None:
            limit = tol + y_extra
            extra = " + 2^-7 |want| + 2^-8 y(|x|, |B|, |C|)"
        _log(f"[kernels] {label} {name}: max_abs_err {float(err.max()):.3g} "
             f"(tol {tol:.3g} = {SSD_RTOL} x max |want| "
             f"{float(w.abs().max()):.3g}{extra})")
        if not (bool((err <= limit).all()) and torch.isfinite(a).all()):
            raise AssertionError(f"{label} {name} disagrees with its plain "
                                 f"version")
        worst = max(worst, float(err.max()))
    return worst


def _check_ssd_batch_invariance(args):
    """Batch row 0 alone, and chunk (0, 5) alone, give the bits they give
    in the whole call: each chunk's work is its own CTAs'."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda

    full = ssd_chunk_cuda(*args)
    for label, idx in (("batch row 0", (slice(0, 1),)),
                       ("chunk (0, 5)", (slice(0, 1), slice(5, 6)))):
        alone = ssd_chunk_cuda(*(a[idx] for a in args))
        same = all(torch.equal(p, f[idx]) for p, f in zip(alone, full))
        _log(f"[kernels] ssd_chunk {label} alone vs in the batch: "
             f"{'bitwise equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"ssd_chunk {label} alone differs from it "
                                 f"in the batch")


def phase_forward_kernels():
    """Flash attention and the SSD chunk against their plain versions at
    the forward path's shapes, then timed."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ops import flash_attention_plain, ssd_chunk_plain
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda

    flash_err = 0.0
    # the last two: S = 1000 is no multiple of the 32-position query tile
    # or the 32-key tile
    for s, causal, window, dt in ((FS, True, 0, torch.float32),
                                  (FS, True, 1024, torch.float32),
                                  (1024, False, 0, torch.float32),
                                  (FS, True, 0, torch.bfloat16),
                                  (1000, True, 0, torch.float32),
                                  (1000, False, 300, torch.float32)):
        q, k, v = _flash_inputs(FB, s, dt)
        p_round = None
        if dt == torch.bfloat16:  # rows near the start see few keys
            p_round = 2.0 ** -8 * flash_attention_plain(
                q, k, v.abs(), causal=causal, window=window)
        err = _check(f"flash_attention S={s} causal={causal} "
                     f"window={window} {dt}",
                     flash_attention_cuda(q, k, v, causal=causal,
                                          window=window),
                     flash_attention_plain(q, k, v, causal=causal,
                                           window=window), dt, p_round)
        if dt == torch.float32:
            flash_err = max(flash_err, err)
        del q, k, v, p_round
    ssd_err = 0.0
    # mamba2's phase 3c shape, the prefill's (B=4, NC=8), G > 1, and a
    # chunk of 160 positions with ds = 96 (a partial row block of 32 rows
    # and a partial state slice of 32 rows)
    for shape in (SSD, dict(SSD, B=4, NC=8),
                  dict(SSD, B=1, NC=4, NH=16, G=2, DS=64),
                  dict(SSD, B=1, NC=4, NH=16, G=2, Q=160, DS=96)):
        args = _ssd_inputs(*shape.values())
        ssd_err = max(ssd_err, _check_ssd(
            f"ssd_chunk {shape}", ssd_chunk_cuda(*args),
            ssd_chunk_plain(*args)))
    _check_ssd_batch_invariance(_ssd_inputs(*SSD.values()))
    bf16 = _ssd_inputs(*SSD.values(), dtype=torch.bfloat16)
    x, b, c, dt, cum = bf16
    y_abs = ssd_chunk_plain(x.abs().float(), b.abs().float(),
                            c.abs().float(), dt, cum)[0]
    want = ssd_chunk_plain(*bf16)
    _check_ssd(f"ssd_chunk {SSD} bf16", ssd_chunk_cuda(*bf16), want,
               BF16_ULP * want[0].float().abs() + SSD_BF16_ATT * y_abs)
    _check_ssd_batch_invariance(bf16)
    del y_abs, want, x, b, c, dt, cum
    torch.cuda.synchronize()

    rows = []
    q, k, v = _flash_inputs(FB, FS, torch.float32)
    bound = _flash_bound_ms(q, k, True, 0)
    kx = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vx = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    qt = q.transpose(1, 2)
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kx, vx, is_causal=True))
    rows.append(_timed_row(
        "flash_attention", lambda: flash_attention_cuda(q, k, v),
        lambda: flash_attention_plain(q, k, v), lib_ms, bound,
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:83", flash_err))
    del q, k, v, kx, vx, qt
    args = _ssd_inputs(*SSD.values())
    bound = _ssd_bound_ms(args[0], args[1])
    _log(f"[kernels] ssd_chunk f32 bound on the CUDA cores (the PR 13 "
         f"design's): {_ssd_bound_ms(args[0], args[1], True)[0]:.4f} ms")
    rows.append(_timed_row(
        "ssd_chunk", lambda: ssd_chunk_cuda(*args),
        lambda: ssd_chunk_plain(*args), None, bound,
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:54", ssd_err))
    # the bf16 instance, timed for the record (not on the served path)
    bound, bound_by, rate = _ssd_bound_ms(bf16[0], bf16[1])
    _log(f"[kernels] ssd_chunk bf16: "
         f"{_time_ms(lambda: ssd_chunk_cuda(*bf16)):.4f} ms (plain "
         f"{_time_ms(lambda: ssd_chunk_plain(*bf16)):.4f} ms, bound "
         f"{bound:.4f} ms by {bound_by}; flops at {rate})")
    return rows


def _timed_prefill(run, label, n=2):
    """Host clock around ``run`` ending in a synchronize, ``n`` times."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    _log(f"[forward] {label}: {', '.join(f'{t:.1f}' for t in times)} ms")
    return times


def _check_logits(label, got, want, tol=LOGIT_TOL):
    err = float((got - want).abs().max())
    _log(f"[forward] {label}: max_abs_err {err:.3g} (tol {tol}); |logits| "
         f"max {float(want.abs().max()):.3g}")
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{label}: logits disagree")
    return err


def phase_forward_attention(model, params):
    """internlm2-1.8b's batched whole-prompt prefill (2 x 4096) through
    flash attention."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.runtime.steps import make_prefill_step

    cfg = model.cfg
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(FB, FS)),
                           device="cuda")
    batch = {"tokens": toks}
    step = make_prefill_step(model)
    flash_attention_cuda.launches = 0
    first, caches = step(params, batch)
    torch.cuda.synchronize()
    launches = flash_attention_cuda.launches
    _log(f"[forward] internlm2 prefill step {FB} x {FS}: flash_attention "
         f"launches {launches}; first tokens {first.ravel().tolist()}; "
         f"cache k {tuple(caches['stack']['k'].shape)}")
    if launches != cfg.num_layers:
        raise AssertionError(f"flash attention launched {launches} times, "
                             f"not once per layer ({cfg.num_layers})")
    if first.shape != (FB, 1) or not bool(((first >= 0) & (
            first < cfg.vocab_size)).all()):
        raise AssertionError("prefill tokens outside the vocabulary")
    del caches
    logits, _ = model.prefill(params, batch)
    with _plain_attention():
        want, _ = model.prefill(params, batch)
    _check_logits("internlm2 prefill logits, kernel vs plain", logits, want)
    # the dense engine's route: one slot's chunked prefill of prompt 0
    from repro_torch.runtime.steps import compiled_step

    chunk_step = compiled_step(model, "prefill_chunk")
    dense = model.init_cache(1, FS)
    for off in range(0, FS, CHUNK):
        _, dense = chunk_step(params, dense, toks[:1, off:off + CHUNK], 0,
                              off)
    last, _ = model.prefill_chunk_step(params, dense,
                                       toks[:1, FS - CHUNK:], 0, FS - CHUNK)
    _check_logits("internlm2 prefill vs the engine's chunked prefill "
                  "(prompt 0, last row)", logits[:1], last[-1:])
    del dense, want
    times = _timed_prefill(functools.partial(step, params, batch),
                           f"internlm2 prefill step {FB} x {FS}")
    _profile_tick(functools.partial(step, params, batch),
                  f"internlm2 prefill step {FB} x {FS}", ticks=1, top=10)
    return launches, times


def make_ssm_model():
    from repro_torch.configs import get_config
    from repro_torch.models import LM, RuntimeKnobs

    cfg = get_config("mamba2-1.3b")
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    _log(f"[ssm] {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model} "
         f"ssm {cfg.ssm} vocab {cfg.vocab_size}; init "
         f"{time.perf_counter() - t0:.1f}s")
    return model, params


def phase_ssm(model, params):
    """mamba2-1.3b: batched prefill through the SSD kernel, decode from its
    states, the token-fed route, and the engine."""
    from repro_torch.kernels.ops import ssd_chunk_plain
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step

    cfg = model.cfg
    rng = np.random.default_rng(4)
    sb, ss = 4, 2048
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(sb, ss)),
                           device="cuda")
    batch = {"tokens": toks}
    step = make_prefill_step(model)
    ssd_chunk_cuda.launches = 0
    nxt, caches = step(params, batch)
    torch.cuda.synchronize()
    launches = ssd_chunk_cuda.launches
    _log(f"[ssm] prefill step {sb} x {ss}: ssd_chunk launches {launches}; "
         f"conv {tuple(caches['stack']['conv'].shape)} state "
         f"{tuple(caches['stack']['state'].shape)}; |state| max "
         f"{float(caches['stack']['state'].abs().max()):.3g}")
    if launches != cfg.num_layers:
        raise AssertionError(f"SSD kernel launched {launches} times, not "
                             f"once per layer ({cfg.num_layers})")
    with _first_call_args("ssd_chunk") as seen:
        logits, _ = model.prefill(params, batch)
    # the first layer's own SSD inputs (strided views of its in_proj
    # output) through the kernel and the plain version
    _check_ssd("ssd_chunk, mamba2 prefill layer 0",
               ssd_chunk_cuda(*seen[0]), ssd_chunk_plain(*seen[0]))
    del seen
    with _plain_attention():
        want, _ = model.prefill(params, batch)
    _check_logits("mamba2 prefill logits, kernel vs plain", logits, want)
    del want
    # 32 greedy decode steps from the prefill's states
    serve = make_serve_step(model)
    out = [nxt]
    for i in range(32):
        nxt, caches = serve(params, caches, nxt, ss + i)
        out.append(nxt)
    stream = torch.cat(out, 1)
    if not bool(((stream >= 0) & (stream < cfg.vocab_size)).all()):
        raise AssertionError("decode tokens outside the vocabulary")
    _log(f"[ssm] 32 decode steps after the prefill: slot 0 tokens "
         f"{stream[0, :12].tolist()}...")
    tick_ms = [_time_ms(functools.partial(serve, params, caches, nxt, ss),
                        iters=10, warmup=2, queued=False) for _ in range(3)]
    _log(f"[ssm] decode tick, batch {sb}: "
         f"{', '.join(f'{t:.3f}' for t in tick_ms)} ms (median of 10 each)")
    _profile_tick(functools.partial(serve, params, caches, nxt, ss),
                  f"mamba2 decode tick batch {sb}")
    del caches

    # one ~128-token prompt: prefill then decode against the token feed
    # the engine runs (decode steps from a zeroed slot)
    prompt = toks[:1, :128]
    n_new = 8
    lp, pc = model.prefill(params, {"tokens": prompt})
    fed = model.init_cache(1, 256)
    for t in range(128):
        lf, fed = model.decode_step(params, fed, prompt[:, t:t + 1], t)
    errs = [_check_logits("mamba2 128-token prompt: prefill vs token feed",
                          lp, lf, SSM_FEED_TOL)]
    pref = [int(lp.argmax())]
    for i in range(n_new - 1):
        tok = torch.tensor([[pref[-1]]], device="cuda")
        lp, pc = model.decode_step(params, pc, tok, 128 + i)
        lf, fed = model.decode_step(params, fed, tok, 128 + i)
        errs.append(float((lp - lf).abs().max()))
        pref.append(int(lp.argmax()))
    _log(f"[ssm] prefill-then-decode vs token-fed logits over {n_new} "
         f"steps: max_abs_err {max(errs):.3g} (tol {SSM_FEED_TOL})")
    if max(errs) > SSM_FEED_TOL:
        raise AssertionError("prefill-then-decode and token-fed logits "
                             "disagree")
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=256))
    h = eng.submit(Request(0, prompt[0].cpu().numpy().astype(np.int32),
                           max_new_tokens=n_new))
    eng.run()
    _log(f"[ssm] engine (token-fed) tokens {h.req.output}; prefill-then-"
         f"decode {pref}")
    if h.req.output != pref:
        raise AssertionError("the engine's tokens differ from "
                             "prefill-then-decode")

    # the engine: more requests than slots, then wave mode
    reqs = [(i, rng.integers(0, cfg.vocab_size, size=int(n)).astype(
        np.int32)) for i, n in enumerate((20, 7, 31, 12, 25, 9))]
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=128))
    handles = [eng.submit(Request(i, p, max_new_tokens=8)) for i, p in reqs]
    done = eng.run()
    # a correctness run: too few and too short requests to time serving
    _log(f"[ssm] engine continuous: {len(done)}/6 requests, "
         f"{sum(len(r.output) for r in done)} tokens")
    if len(done) != 6 or any(len(r.output) != 8 for r in done):
        raise AssertionError("mamba2 continuous run did not finish")
    # the last request was admitted into a reused slot: alone, in a fresh
    # engine, it must give the same tokens
    solo = ServeEngine(model, params, ServeConfig(batch_slots=4,
                                                  max_len=128))
    hs = solo.submit(Request(5, reqs[5][1], max_new_tokens=8))
    solo.run()
    _log(f"[ssm] reused slot vs fresh engine: {handles[5].req.output} vs "
         f"{hs.req.output}")
    if hs.req.output != handles[5].req.output:
        raise AssertionError("a reused slot's tokens differ from a fresh "
                             "engine's")
    wave = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=128,
                                                  mode="wave"))
    for i, p in reqs:
        wave.submit(Request(i, p, max_new_tokens=8))
    wdone = wave.run()
    _log(f"[ssm] engine wave: {len(wdone)}/6 requests; streams equal to "
         f"continuous: "
         f"{sorted((r.req_id, r.output) for r in wdone) == sorted((r.req_id, r.output) for r in done)}")
    if len(wdone) != 6:
        raise AssertionError("mamba2 wave run did not finish")

    times = _timed_prefill(functools.partial(step, params, batch),
                           f"mamba2 prefill step {sb} x {ss}")
    _profile_tick(functools.partial(step, params, batch),
                  f"mamba2 prefill step {sb} x {ss}", ticks=1, top=10)
    return launches, times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    name, smi = phase_device()
    phase_build()
    rows = (phase_kernels() + phase_paged_kernels() + phase_quant_kernels()
            + phase_forward_kernels())
    model, params = make_model()
    launches = phase_engine(model, params)
    paged, f32_page_bytes = phase_paged_engine(model, params)
    launches.update(paged)
    launches.update(phase_quant_engine(model, params, f32_page_bytes))
    launches["flash_attention"], _ = phase_forward_attention(model, params)
    del model, params
    torch.cuda.empty_cache()
    model, params = make_ssm_model()
    launches["ssd_chunk"], _ = phase_ssm(model, params)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
