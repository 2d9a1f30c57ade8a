"""Training loop: grad-accum microbatching, periodic checkpointing, metrics.

The PyTorch counterpart of ``repro/runtime/train.py``.  ``Trainer`` is the
per-job loop that Scylla's Task-0 analogue launches after placement: it
builds (or restores) the job's state on one device and runs its steps.
Fault tolerance lives in ``runtime/fault.py`` (restart around this loop).
A job mesh (``mesh``, ``state_shardings``, ``batch_shardings``) is not
ported: passing one raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import (latest_step, prune_checkpoints, restore,
                                    save_checkpoint)
from repro_torch.models import LM
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import init_train_state, make_train_step


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
    ``init_train_state`` with a generator seeded by ``tcfg.seed``."""

    def __init__(self, model: LM, dataset, tcfg: TrainConfig, *,
                 mesh=None, state_shardings=None, batch_shardings=None):
        for name, value in (("mesh", mesh),
                            ("state_shardings", state_shardings),
                            ("batch_shardings", batch_shardings)):
            if value is not None:
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported: the port trains "
                    f"on one device")
        self.model = model
        self.dataset = dataset
        self.tcfg = tcfg
        self.step_fn = make_train_step(model, tcfg.opt, tcfg.grad_accum)
        self.state = None
        self.step = 0
        self.history: list[dict] = []

    # ------------------------------------------------------------- state
    def init_state(self):
        gen = torch.Generator(device=self.model.device).manual_seed(
            self.tcfg.seed)
        self.state = init_train_state(self.model, gen)
        self.step = 0
        return self.state

    def maybe_restore(self) -> bool:
        d = self.tcfg.checkpoint_dir
        if not d or latest_step(d) is None:
            return False
        # the state's structure, shapes and dtypes, allocating nothing
        shapes = LM(self.model.cfg, self.model.knobs, device="meta")
        target = init_train_state(shapes, torch.Generator())
        self.state, meta = restore(d, target, device=self.model.device)
        self.step = meta["step"]
        return True

    def save(self):
        if not self.tcfg.checkpoint_dir:
            return
        save_checkpoint(self.tcfg.checkpoint_dir, self.step, self.state,
                        extra={"arch": self.model.cfg.name})
        prune_checkpoints(self.tcfg.checkpoint_dir,
                          self.tcfg.keep_checkpoints)

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
