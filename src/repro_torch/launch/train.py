"""Training launcher: the per-job main process Scylla's Task-0 analogue
runs.

The PyTorch counterpart of ``repro/launch/train.py``, on one device (a job
mesh across devices is not ported):

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --steps 50 [--device cpu]

Without ``--device cpu`` it trains on the card, and fails if there is none.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data import MarkovSynthetic
from repro_torch.models import LM, RuntimeKnobs
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dt = torch.bfloat16 if args.bf16 else torch.float32
    knobs = RuntimeKnobs(param_dtype=dt, compute_dtype=dt,
                         cache_dtype=torch.float32,
                         q_chunk=min(128, args.seq),
                         ce_chunk=min(256, args.seq))
    model = LM(cfg, knobs, device=args.device)
    print(f"arch={args.arch} smoke={args.smoke} "
          f"params={cfg.param_count() / 1e6:.1f}M devices=1")
    data = MarkovSynthetic(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=0, noise=0.1)
    tcfg = TrainConfig(
        steps=args.steps, grad_accum=args.grad_accum,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir or None, log_every=10,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps))
    out = Trainer(model, data, tcfg).run()
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"grad_norm {h['grad_norm']:.2f}")
    return out


if __name__ == "__main__":
    main()
