"""Training loop: grad-accum microbatching, periodic checkpointing, metrics.

The PyTorch counterpart of ``repro/runtime/train.py``.  ``Trainer`` is the
per-job loop that Scylla's Task-0 analogue launches after placement: it
builds (or restores) the job's state, on one device or over the job's
mesh (each rank a process of the gang, holding its blocks of the state),
and runs lockstep steps.  Fault tolerance lives in ``runtime/fault.py``
(restart around this loop).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import (latest_step, prune_checkpoints, restore,
                                    save_checkpoint)
from repro_torch.models import LM
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import init_train_state, make_train_step
from repro_torch.sharding import make_shard_fn
from repro_torch.sharding.zero import (gather_state, is_sharded,
                                       state_shardings_of)


@dataclass
class TrainConfig:
    steps: int = 100
    grad_accum: int = 1
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    opt: AdamWConfig = field(default_factory=AdamWConfig)


class Trainer:
    """Drives ``make_train_step`` over ``dataset.batch(step)`` on the
    model's device.  ``state`` may be set before ``run`` (a converted
    state, say); ``run`` builds one only when it is None, from the latest
    checkpoint in ``checkpoint_dir`` if there is one, else from
    ``init_train_state`` with a generator seeded by ``tcfg.seed``.

    Over a ``mesh`` (every rank of it runs the same Trainer), the model
    takes the mesh's seams (``sharding.make_shard_fn(mesh, cfg)`` unless
    its knobs carry them), the state holds the rank's blocks under
    ``state_shardings`` (default the mesh's ``train_state_shardings``)
    and each step cuts the global batch by ``batch_shardings`` (default
    ``sharding.batch_shardings``).  A restore keeps the rank's blocks of
    the latest checkpoint, whatever mesh saved it; a save gathers every
    leaf whole, rank 0 writes it, and every rank waits for the write."""

    def __init__(self, model: LM, dataset, tcfg: TrainConfig, *,
                 mesh=None, state_shardings=None, batch_shardings=None):
        if mesh is None and (state_shardings is not None
                             or batch_shardings is not None):
            raise ValueError("Trainer(state_shardings=/batch_shardings=) "
                             "needs the mesh they cut over (mesh=...)")
        if mesh is not None and not is_sharded(model):
            model = LM(model.cfg, model.knobs.with_(
                shard_fn=make_shard_fn(mesh, model.cfg)), model.device)
        if mesh is not None and model.knobs.shard_fn.mesh is not mesh:
            raise ValueError("the model's seams run over another mesh")
        self.model = model
        self.dataset = dataset
        self.tcfg = tcfg
        self.mesh = mesh
        self.state_shardings = (None if mesh is None else
                                state_shardings_of(model, state_shardings))
        self.step_fn = make_train_step(
            model, tcfg.opt, tcfg.grad_accum,
            state_shardings=self.state_shardings,
            batch_shardings=batch_shardings)
        self.state = None
        self.step = 0
        self.history: list[dict] = []

    # ------------------------------------------------------------- state
    def init_state(self):
        gen = torch.Generator(device=self.model.device).manual_seed(
            self.tcfg.seed)
        self.state = init_train_state(self.model, gen,
                                      shardings=self.state_shardings)
        self.step = 0
        return self.state

    def maybe_restore(self) -> bool:
        d = self.tcfg.checkpoint_dir
        if not d or latest_step(d) is None:
            return False
        # the whole state's structure, shapes and dtypes, allocating
        # nothing
        shapes = LM(self.model.cfg, self.model.knobs.with_(
            shard_fn=lambda name, x: x), device="meta")
        target = init_train_state(shapes, torch.Generator())
        self.state, meta = restore(d, target, self.state_shardings,
                                   device=self.model.device, mesh=self.mesh)
        self.step = meta["step"]
        return True

    def save(self):
        if not self.tcfg.checkpoint_dir:
            return
        state, writer = self.state, True
        if self.mesh is not None:
            state = gather_state(state, self.state_shardings, self.mesh,
                                 first_only=True)
            writer = dist.get_rank() == 0
        if writer:
            save_checkpoint(self.tcfg.checkpoint_dir, self.step, state,
                            extra={"arch": self.model.cfg.name})
            prune_checkpoints(self.tcfg.checkpoint_dir,
                              self.tcfg.keep_checkpoints)
        if self.mesh is not None:
            dist.barrier()

    # -------------------------------------------------------------- run
    def run(self, *, until: Optional[int] = None,
            on_step: Optional[Callable] = None) -> dict:
        if self.state is None and not self.maybe_restore():
            self.init_state()
        until = min(until or self.tcfg.steps, self.tcfg.steps)
        while self.step < until:
            batch = {k: torch.as_tensor(v).to(self.model.device)
                     for k, v in self.dataset.batch(self.step).items()}
            self.state, metrics = self.step_fn(self.state, batch)
            self.step += 1
            if on_step is not None:
                on_step(self.step, metrics)
            if self.step % self.tcfg.log_every == 0 or self.step == until:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step
                self.history.append(m)
            if (self.tcfg.checkpoint_every
                    and self.step % self.tcfg.checkpoint_every == 0):
                self.save()
        return {"step": self.step, "history": self.history}
