"""Job model: an MPI job in the paper = a gang-scheduled SPMD JAX program.

A job names an (arch, shape) cell from the assigned pool, a chip demand, and
a placement policy.  Its roofline profile (FLOPs / HBM bytes / collective
bytes per step) either comes from the dry-run artifact
(``launch/roofline.py`` output) or from the closed-form estimate in
``costmodel.analytic_profile``.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional


class JobPhase(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


@dataclass(frozen=True)
class RooflineProfile:
    """Per-step, whole-job quantities (not per-chip)."""

    flops: float
    hbm_bytes: float
    ici_bytes: float  # collective bytes that stay on ICI
    dcn_bytes: float = 0.0  # collective bytes crossing pods (placement-dep.)

    def scaled(self, f: float) -> "RooflineProfile":
        return RooflineProfile(self.flops * f, self.hbm_bytes * f,
                               self.ici_bytes * f, self.dcn_bytes * f)


@dataclass(frozen=True)
class JobSpec:
    job_id: str
    arch: str
    shape: str
    chips: int  # gang size
    policy: str = "spread"  # spread | minhost | auto
    steps: int = 1000
    framework: str = "default"  # DRF principal
    priority: int = 0
    # profile override; None -> costmodel.analytic_profile(arch, shape)
    profile: Optional[RooflineProfile] = None
    checkpoint_every: int = 100  # steps between checkpoints (fault tolerance)


@dataclass
class JobState:
    spec: JobSpec
    phase: JobPhase = JobPhase.PENDING
    assignment: dict = field(default_factory=dict)  # agent_id -> chips
    layout: str = "tp"  # parallelism layout chosen at placement (§Perf H3)
    submit_time: float = 0.0
    start_time: float = -1.0
    finish_time: float = -1.0
    steps_done: int = 0
    last_checkpoint_step: int = 0
    restarts: int = 0

    @property
    def n_hosts(self) -> int:
        return len(self.assignment)

    def pods_used(self, cluster) -> set:
        return {cluster.hosts[a].agent.pod_id for a in self.assignment}
