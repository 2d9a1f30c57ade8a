"""Training launcher: the per-job main process Scylla's Task-0 analogue
runs.

The PyTorch counterpart of ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --steps 50 [--device cpu]

Without ``--device cpu`` it trains on the card, and fails if there is none.
Every host of a gang runs the same script: under ``torchrun`` (or with
``--dist-init`` and ``RANK``/``WORLD_SIZE`` in the environment) a world of
more than one rank trains over ``make_job_mesh(world)``, each rank on a
card of its own (NCCL) or, with ``--device cpu``, over gloo::

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch internlm2-1.8b --smoke --device cpu

Rank 0 prints the arch line and the history; the other ranks print
nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data import MarkovSynthetic
from repro_torch.launch.mesh import leave_world
from repro_torch.models import LM, RuntimeKnobs
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train import TrainConfig, Trainer
from repro_torch.sharding import make_shard_fn


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
    ap.add_argument("--dist-init", default="env://",
                    help="process group rendezvous of the gang's ranks")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return _train(args, args.device, None)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_job_mesh
    from repro_torch.launch.serve import _init_mesh_world

    device = _init_mesh_world(args, world)
    try:
        mesh = make_job_mesh(world)
        if dist.get_rank() == 0:
            return _train(args, device, mesh)
        with contextlib.redirect_stdout(io.StringIO()):
            return _train(args, device, mesh)
    except BaseException:  # on success the world stays: leave_world
        dist.destroy_process_group()
        raise


def _train(args, device, mesh):
    """Build the model (over ``mesh``'s seams when there is one), train
    and print the history."""
    cfg = get_config(args.arch, smoke=args.smoke)
    dt = torch.bfloat16 if args.bf16 else torch.float32
    knobs = RuntimeKnobs(param_dtype=dt, compute_dtype=dt,
                         cache_dtype=torch.float32,
                         q_chunk=min(128, args.seq),
                         ce_chunk=min(256, args.seq))
    if mesh is not None:
        knobs = knobs.with_(shard_fn=make_shard_fn(mesh, cfg))
    model = LM(cfg, knobs, device=device)
    n_dev = 1 if mesh is None else mesh.size()
    print(f"arch={args.arch} smoke={args.smoke} "
          f"params={cfg.param_count() / 1e6:.1f}M devices={n_dev}")
    data = MarkovSynthetic(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=0, noise=0.1)
    tcfg = TrainConfig(
        steps=args.steps, grad_accum=args.grad_accum,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir or None, log_every=10,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps))
    out = Trainer(model, data, tcfg, mesh=mesh).run()
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"grad_norm {h['grad_norm']:.2f}")
    return out


if __name__ == "__main__":
    main()
    leave_world()
