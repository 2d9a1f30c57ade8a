"""AdamW with f32 master weights, global-norm clipping, the warmup-cosine
schedule.

The PyTorch counterpart of ``repro/optim/adamw.py``: plain functions over
the params dict, not ``torch.optim.AdamW`` (which decays before the moment
step and keeps no master copy).  The state has the reference's structure,
``{"master", "mu", "nu", "step"}``, with ``step`` an int32 scalar tensor.
``adamw_update`` writes the new master, mu and nu into the state's tensors
in place (the reference donates the state instead) and returns the state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The tensors of a nested dict in sorted-key order (the order of
    ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def warmup_cosine(cfg: AdamWConfig) -> Callable:
    """step -> learning rate, an f32 scalar tensor on the step's device:
    linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine down
    to ``min_lr_frac * lr`` at ``total_steps``."""
    def schedule(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return cfg.lr * warm * cos

    return schedule


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, summed leaf by
    leaf in sorted-key order."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total))


def adamw_init(params, moments_dtype=torch.float32):
    """State: an f32 master copy (never the params' own storage, even for
    f32 params), zero first and second moments in ``moments_dtype``
    (bf16 halves their memory; the update math runs in f32 either way), and
    the step counter."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    return {"master": master,
            "mu": tree_map(lambda p: torch.zeros_like(
                p, dtype=moments_dtype), params),
            "nu": tree_map(lambda p: torch.zeros_like(
                p, dtype=moments_dtype), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(grads, opt_state, cfg: AdamWConfig,
                 schedule: Callable | None = None,
                 norm: torch.Tensor | None = None):
    """One AdamW step from ``grads`` (a tree like the master's): returns
    (new master, new state, {"grad_norm", "lr"}).  The gradient is clipped
    to global norm ``clip_norm`` (scale ``min(1, clip_norm / max(norm,
    1e-12))``), the bias corrections take the new step as f32, and the
    learning rate is ``schedule`` (default ``warmup_cosine``) at the new
    step.  The master, mu and nu tensors are updated in place, leaf by
    leaf, so no second copy of the state is held.  ``norm`` is the global
    norm when ``grads`` holds only blocks of the gradient (a ZeRO shard,
    whose norm the caller sums over the ranks); default
    ``global_norm(grads)``."""
    schedule = schedule or warmup_cosine(cfg)
    step = opt_state["step"] + 1
    lr = schedule(step)
    gnorm = global_norm(grads) if norm is None else norm
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                         max=1.0) if cfg.clip_norm
             else torch.ones((), device=gnorm.device))
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(g, m, mu, nu):
        g = g.float() * scale
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
        mhat = mu32 / b1c
        nhat = nu32 / b2c
        m.copy_(m - lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                          + cfg.weight_decay * m))
        mu.copy_(mu32)
        nu.copy_(nu32)

    tree_map(upd, grads, opt_state["master"], opt_state["mu"],
             opt_state["nu"])
    opt_state["step"] = step
    return opt_state["master"], opt_state, {"grad_norm": gnorm, "lr": lr}
