"""Serving launcher: seeded random weights for an arch, then the batched
decode engine over a synthetic request stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --requests 8 --device cuda

Runs on the card by default; ``--device cpu`` runs the same path with the
kernels' plain versions.  ``--smoke`` takes the arch's reduced config.
``--mode continuous`` (default) admits per slot with chunked prefill;
``--mode wave`` runs the lockstep baseline.  ``--policy`` picks the
admission policy and ``--tenants N`` spreads the requests round-robin
over N tenants.  Weights come from the port's own init
(``torch.Generator`` seeded with ``--seed``), f32 params and f32 cache as
in the reference launcher.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import LM, RuntimeKnobs
from repro_torch.runtime.scheduler import ADMISSION_POLICIES
from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine


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
    ap.add_argument("--policy", choices=sorted(ADMISSION_POLICIES),
                    default="fcfs", help="admission policy")
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread requests over N tenants (round-robin)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="weight init seed")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32),
               device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    engine = ServeEngine(model, params, ServeConfig(
        batch_slots=args.slots, max_len=args.max_len, mode=args.mode,
        prefill_chunk=args.prefill_chunk, policy=args.policy))
    rng = np.random.default_rng(0)
    handles = []
    for i in range(args.requests):
        plen = int(rng.integers(1, 6))
        handles.append(engine.submit(Request(
            i, rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new,
            tenant=f"tenant-{i % max(args.tenants, 1)}", priority=i % 3)))
    t0 = time.perf_counter()
    done = engine.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    ttft = [t for t in (h.metrics().get("ttft_s") for h in handles)
            if t is not None]
    print(f"arch={args.arch} mode={args.mode} device={model.device} "
          f"policy={args.policy} served {len(done)} requests, {toks} "
          f"tokens in {dt:.1f}s ({toks / max(dt, 1e-9):.1f} tok/s)")
    if ttft:
        print(f"ttft p50 {np.percentile(ttft, 50) * 1e3:.0f}ms / "
              f"p99 {np.percentile(ttft, 99) * 1e3:.0f}ms "
              f"(finish reasons: "
              f"{sorted({r.finish_reason for r in done})})")
    return done


if __name__ == "__main__":
    main()
