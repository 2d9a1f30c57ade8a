"""Serving launcher: seeded random weights for an arch, then the batched
decode engine over a synthetic request stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --requests 8 --device cuda

Runs on the card by default; ``--device cpu`` runs the same path with the
kernels' plain versions.  ``--smoke`` takes the arch's reduced config.
``--mode continuous`` (default) admits per slot with chunked prefill;
``--mode wave`` runs the lockstep baseline.  ``--cache paged`` swaps the
dense per-slot stripes for the paged pool (``--page-size``,
``--num-pages``, ``--page-policy pack|spread``, ``--no-prefix-cache``);
admission then reserves only the pages a request can touch and a shared
prompt prefix is read from the pages that hold it.  ``--policy`` picks the
admission policy and ``--tenants N`` spreads the requests round-robin
over N tenants.  ``--arch gemma3-27b`` serves the grouped plan (local
layers under their window, global ones without), ``--arch mixtral-8x7b``
and ``--arch qwen3-moe-235b-a22b`` the MoE FFN; every cache layout and
``--speculate`` apply to them as to the uniform archs, and to granite-20b
(48 query heads on one KV head) and qwen2.5-32b (5 per KV head) on the
CPU.  On the card the launcher serves neither of these two: at full
depth their f32 weights (80 and 131 GB) do not fit one card, and their
``--smoke`` configs have head dim 16, which no kernel is built for.
``chip_smoke.py`` serves both at full width and a cut depth through
``ServeEngine`` (its phases 11 and 12).
``--arch mamba2-1.3b`` serves the SSM plan and ``--arch zamba2-2.7b``
the hybrid plan (mamba2 layers and a shared attention block): their
prompts are fed token by token and a slot's state (and zamba2's K/V
stripes) is zeroed on admission; they take no ``--cache paged`` and no
``--speculate``.
``--kv-dtype int8|fp8`` (with ``--cache paged``) stores the pools
quantized.  Weights come from the port's own
init (``torch.Generator`` seeded with ``--seed``), f32 params and f32
cache as in the reference launcher.

``--temperature/--top-k/--top-p/--sample-seed`` set the per-request
sampling params (temperature 0 = greedy; ``--sample-seed`` is the
reference launcher's ``--seed``, which here names the weight seed).
``--speculate`` turns on speculative decode (``--draft-k N`` tokens per
slot per tick, ``--drafter`` from ``runtime.draft.DRAFTERS``) and prints
the draft acceptance rate.  ``--preempt`` lets the scheduler revoke slots
(``--victim-policy``), and ``--tenant-weights "tenant-0=3,tenant-1=1"``
maps SLO tiers onto weighted-DRF shares.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import LM, RuntimeKnobs
from repro_torch.runtime.draft import DRAFTERS
from repro_torch.runtime.scheduler import ADMISSION_POLICIES, VICTIM_POLICIES
from repro_torch.runtime.serve import (Request, SamplingParams, ServeConfig,
                                       ServeEngine)


def parse_tenant_weights(spec: str) -> dict:
    """``"gold=3,free=1"`` -> ``{"gold": 3.0, "free": 1.0}``; a malformed
    entry or a weight <= 0 raises ``ValueError`` (an argparse usage
    error)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, w = part.partition("=")
        name = name.strip()
        if not eq or not name:
            raise ValueError(f"expected TENANT=WEIGHT, got {part!r}")
        weight = float(w)
        if weight <= 0:
            raise ValueError(f"weight for {name!r} must be > 0, "
                             f"got {weight}")
        out[name] = weight
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--mode", choices=("continuous", "wave"),
                    default="continuous")
    ap.add_argument("--cache", choices=("dense", "paged"), default="dense")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool size (default: dense-equivalent capacity)")
    ap.add_argument("--page-policy", choices=("pack", "spread"),
                    default="pack")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--kv-dtype", choices=("", "int8", "fp8"), default="",
                    help="quantized paged pools (with --cache paged)")
    ap.add_argument("--policy", choices=sorted(ADMISSION_POLICIES),
                    default="fcfs", help="admission policy")
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread requests over N tenants (round-robin)")
    ap.add_argument("--tenant-weights", type=parse_tenant_weights,
                    default=None,
                    help="weighted-DRF SLO tiers, e.g. 'tenant-0=3,"
                         "tenant-1=1' (unlisted tenants weigh 1)")
    ap.add_argument("--preempt", action="store_true",
                    help="enable slot preemption (checkpoint/restore)")
    ap.add_argument("--victim-policy", choices=sorted(VICTIM_POLICIES),
                    default="youngest-first")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=None,
                    help="per-request sampling seed (default: request id)")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative multi-token decode (see --draft-k)")
    ap.add_argument("--draft-k", type=int, default=3,
                    help="draft tokens per slot per tick (with --speculate)")
    ap.add_argument("--drafter", choices=sorted(DRAFTERS), default="ngram")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="weight init seed")
    args = ap.parse_args(argv)
    if args.speculate and args.draft_k <= 0:
        ap.error(f"--speculate needs --draft-k >= 1 (got {args.draft_k})")
    if args.kv_dtype and args.cache != "paged":
        ap.error(f"--kv-dtype {args.kv_dtype} needs --cache paged")

    cfg = get_config(args.arch, smoke=args.smoke)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32),
               device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    engine = ServeEngine(model, params, ServeConfig(
        batch_slots=args.slots, max_len=args.max_len, mode=args.mode,
        prefill_chunk=args.prefill_chunk, cache=args.cache,
        page_size=args.page_size, num_pages=args.num_pages,
        page_policy=args.page_policy, kv_dtype=args.kv_dtype,
        prefix_cache=not args.no_prefix_cache, policy=args.policy,
        tenant_weights=args.tenant_weights, preempt=args.preempt,
        victim_policy=args.victim_policy,
        draft_k=args.draft_k if args.speculate else 0,
        drafter=args.drafter))
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.sample_seed)
    rng = np.random.default_rng(0)
    handles = []
    for i in range(args.requests):
        plen = int(rng.integers(1, 6))
        handles.append(engine.submit(Request(
            i, rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new, sampling=sampling,
            tenant=f"tenant-{i % max(args.tenants, 1)}", priority=i % 3)))
    t0 = time.perf_counter()
    done = engine.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    ttft = [t for t in (h.metrics().get("ttft_s") for h in handles)
            if t is not None]
    print(f"arch={args.arch} mode={args.mode} cache={args.cache} "
          f"device={model.device} "
          f"policy={args.policy} served {len(done)} requests, {toks} "
          f"tokens in {dt:.1f}s ({toks / max(dt, 1e-9):.1f} tok/s)")
    if args.preempt:
        print(f"preemptions: {engine.scheduler.preempted_total} "
              f"(requests preempted >=1x: "
              f"{sum(1 for r in done if r.preempt_count)})")
    if args.speculate:
        st = engine.spec_stats()
        print(f"speculative: draft_k={st['draft_k']} "
              f"acceptance {st['acceptance_rate']:.2f} "
              f"({st['accepted']}/{st['proposed']}), "
              f"{st['tokens_per_tick']:.2f} tok/tick")
    if ttft:
        print(f"ttft p50 {np.percentile(ttft, 50) * 1e3:.0f}ms / "
              f"p99 {np.percentile(ttft, 99) * 1e3:.0f}ms "
              f"(finish reasons: "
              f"{sorted({r.finish_reason for r in done})})")
    if engine.kv is not None:
        print(f"kv stats: {engine.kv.stats()}")
    return done


if __name__ == "__main__":
    main()
