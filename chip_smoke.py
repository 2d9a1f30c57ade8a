"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, each raising on failure:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at the
   serving path's shapes (internlm2-1.8b attention: H=16, KV=8, D=128; 4
   slots; an 8192-row cache; ragged positions including -1 and 8191), then
   times of the kernel, the plain version and one library call;
4. engine: internlm2-1.8b at full width (24 layers, seeded random f32
   weights, f32 cache) served by ``ServeEngine`` in continuous mode --
   short requests plus one ~4200-token prompt, so the split-K autotuner
   engages -- then a short wave-mode trace; every kernel must have been
   launched by the serving run, and one decode step's logits through the
   kernels must match the plain path; one decode tick is timed, single
   pass against split-K, over alternating rounds, and its device time is
   broken down by kernel with ``torch.profiler``.

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
H, KV, D, B, S = 16, 8, 128, 4, 8192
POS = [-1, 1000, 4200, S - 1]
# Kernel against plain version.  With these inputs (randn q, k, v) the
# scores have unit spread, so an output is a softmax average over n = 1k-8k
# keys: |out| ~ sqrt(e / n) ~ 0.02-0.05, at most ~0.2; a parked slot's are
# 0.  Leaving out one 32-key tile moves an output by ~9.3 / n rms (1e-3 at
# n = 8192, 9e-3 at n = 1000), so each tolerance stays below that.
# - f32 cache: both sides accumulate in f32 in other orders (tiled online
#   softmax against one full softmax); measured <= 2.7e-7.
# - bf16 cache: the kernel rounds p to bf16 before the PV product, as the
#   TPU kernel does, where the plain version keeps p in f32; measured
#   2.9e-4 to 3.3e-4 on an H100.  Rounding p on the plain side would not
#   match the kernel, which rounds exp(s - running max) tile by tile.
# - bf16 q (and so a bf16 output): both sides round an f32 result to bf16,
#   and a value next to a rounding boundary may round either way, so one
#   bf16 ulp of the output (<= 2^-7 |out|) is added.
TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-3}
BF16_ULP = 2.0 ** -7
# Logits after 24 layers: each layer's attention differs by ~1e-6, which
# the residual stream carries through to the unembedding.
LOGIT_TOL = 1e-3


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


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    _log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
         f"(nvcc: {_build.build_seconds})")


def _time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _inputs(t, q_dtype, kv_dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, t, H, D), generator=g, device="cuda").to(q_dtype)
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(kv_dtype)
    v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(kv_dtype)
    return q, k, v, torch.tensor(POS, dtype=torch.int32, device="cuda")


def _check(label, got, want, kv_dtype):
    """Max abs error of ``got`` against ``want``; raises past the tolerance
    of the cache dtype (plus one bf16 ulp of ``want`` for a bf16 output)."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = TOL[kv_dtype]
    limit = tol + (BF16_ULP * want.abs() if got.dtype == torch.bfloat16
                   else 0.0)
    worst = float(err.max())
    extra = " + 2^-7 |want|" if got.dtype == torch.bfloat16 else ""
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


def _bound_ms(q, k, pos):
    """Least time for the work these inputs need: the live K/V prefix of
    the active slots read once, q read and the output written once, against
    the card's memory rate; and QK + PV flops against its f32 rate."""
    live = sum(p + 1 for p in pos.tolist() if p >= 0)
    kv_bytes = 2 * live * KV * D * k.element_size()
    io_bytes = 2 * q.numel() * q.element_size() + 4 * len(pos)
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * live * H * D * q.shape[1] / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_kernels():
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.ops import decode_attention_plain

    errs = {"decode_attention": 0.0, "decode_attention_splitk": 0.0}
    cases = [(t, w, qd, kd) for t in (1, 4) for w in (0, 1024)
             for qd, kd in ((torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16))]
    cases.append((1, 0, torch.bfloat16, torch.bfloat16))
    for t, window, qd, kd in cases:
        q, k, v, pos = _inputs(t, qd, kd)
        err = _check(f"decode_attention T={t} window={window} q={qd} "
                     f"cache={kd}",
                     decode_attention_cuda(q, k, v, pos, window=window),
                     decode_attention_plain(q, k, v, pos, window=window), kd)
        if kd == torch.float32:
            errs["decode_attention"] = max(errs["decode_attention"], err)
    for ns in (2, 4, 8):
        for window, kd in ((0, torch.float32), (1024, torch.float32),
                           (0, torch.bfloat16)):
            q, k, v, pos = _inputs(1, torch.float32, kd)
            err = _check(
                f"decode_attention_splitk ns={ns} window={window} "
                f"cache={kd}",
                decode_attention_splitk_cuda(q, k, v, pos, window=window,
                                             num_splits=ns),
                decode_attention_plain(q, k, v, pos, window=window,
                                       num_splits=ns), kd)
            if kd == torch.float32:
                errs["decode_attention_splitk"] = max(
                    errs["decode_attention_splitk"], err)
    torch.cuda.synchronize()

    # times at the engine's decode shapes: T = 1, f32 cache, no window; the
    # autotuner gives split-K 2 splits at these positions
    q, k, v, pos = _inputs(1, torch.float32, torch.float32)
    bound, bound_by = _bound_ms(q, k, pos)
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
        ms = _time_ms(run)
        plain_ms = _time_ms(plain)
        _log(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
             f"library {lib_ms:.4f} ms, bound {bound:.4f} ms by {bound_by})")
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "decode_attention.cu",
                     "replaces": replaces, "launches": None,
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib_ms})
    return rows


@contextlib.contextmanager
def _plain_attention():
    """Route the model's decode attention through the plain version for
    CUDA tensors (for the logits comparison only)."""
    from repro_torch.kernels import ops

    kernel_path = ops.decode_attention
    ops.decode_attention = ops.decode_attention_plain
    try:
        yield
    finally:
        ops.decode_attention = kernel_path


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


def phase_engine():
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.models import LM, RuntimeKnobs
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine
    from repro_torch.runtime.steps import compiled_step

    kernels = (decode_attention_cuda, decode_attention_splitk_cuda)
    cfg = get_config("internlm2-1.8b")
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    _log(f"[engine] {cfg.name}: {cfg.num_layers} layers d_model "
         f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} vocab "
         f"{cfg.vocab_size}; init {time.perf_counter() - t0:.1f}s")

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
    _log(f"[engine] continuous: {len(done)}/{len(reqs)} requests, {toks} "
         f"tokens in {wall:.3f}s = {toks / wall:.2f} tok/s; ttft p50 "
         f"{statistics.median(ttft) * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} "
         f"ms; launches {launches}")
    if len(done) != len(reqs) or not all(
            len(r.output) == r.max_new_tokens for r in done):
        raise AssertionError("continuous run did not finish every request")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
        raise AssertionError("token outside the vocabulary")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")

    # one decode step, kernels against the plain path, on the run's cache
    toks_in = torch.tensor([[5], [6], [7], [8]], device="cuda")
    pos = np.array([4300, 300, -1, 4200], np.int32)
    for splits in (1, 2):
        step = compiled_step(model, "decode_one", decode_splits=splits)
        got, _ = step(params, eng.caches, toks_in, pos)
        with _plain_attention():
            want, _ = step(params, eng.caches, toks_in, pos)
        err = float((got - want).abs().max())
        _log(f"[engine] decode logits, kernels vs plain (splits={splits}): "
             f"max_abs_err {err:.3g} (tol {LOGIT_TOL}); |logits| max "
             f"{float(want.abs().max()):.3g}")
        if not (torch.isfinite(got).all() and err <= LOGIT_TOL
                and got.shape == (4, cfg.vocab_size)):
            raise AssertionError("decode logits disagree")
    # one whole decode tick (24 layers + unembedding + argmax) at these
    # positions, single pass against split-K 2, alternated over rounds;
    # then each under the profiler
    ticks = {s: functools.partial(
        compiled_step(model, "serve", decode_splits=s), params, eng.caches,
        toks_in, pos) for s in (1, 2)}
    readings = {1: [], 2: []}
    for splits in (1, 2, 2, 1, 1, 2):
        readings[splits].append(_time_ms(ticks[splits], iters=10, warmup=2))
    for splits, ms in readings.items():
        _log(f"[engine] decode tick at pos {pos.tolist()}, splits={splits}: "
             f"{', '.join(f'{x:.3f}' for x in ms)} ms (median of 10 each)")
    for splits, run in ticks.items():
        _profile_tick(run, f"decode tick splits={splits}")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    name, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    launches = phase_engine()
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
