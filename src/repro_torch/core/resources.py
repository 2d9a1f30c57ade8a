"""Mesos-style resource primitives adapted to TPU pods.

A Mesos agent advertises (cpu, mem); our agent is a TPU *host* advertising
(chips, hbm_bytes).  Offers carry the host's free resources plus its
topology coordinates so placement policies can reason about ICI vs DCN
locality — the TPU-native generalization of Docker Swarm's flat overlay
network (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from . import hw


@dataclass(frozen=True, order=True)
class ResourceSpec:
    """A resource vector (the DRF demand/allocation unit)."""

    chips: int = 0
    hbm_bytes: float = 0.0

    def __add__(self, o: "ResourceSpec") -> "ResourceSpec":
        return ResourceSpec(self.chips + o.chips, self.hbm_bytes + o.hbm_bytes)

    def __sub__(self, o: "ResourceSpec") -> "ResourceSpec":
        return ResourceSpec(self.chips - o.chips, self.hbm_bytes - o.hbm_bytes)

    def fits_in(self, o: "ResourceSpec") -> bool:
        return self.chips <= o.chips and self.hbm_bytes <= o.hbm_bytes + 1e-6

    def nonneg(self) -> bool:
        return self.chips >= 0 and self.hbm_bytes >= -1e-6

    def dominant_share(self, total: "ResourceSpec") -> float:
        shares = []
        if total.chips:
            shares.append(self.chips / total.chips)
        if total.hbm_bytes:
            shares.append(self.hbm_bytes / total.hbm_bytes)
        return max(shares) if shares else 0.0

    @staticmethod
    def per_host() -> "ResourceSpec":
        return ResourceSpec(hw.CHIPS_PER_HOST,
                            hw.CHIPS_PER_HOST * hw.HBM_PER_CHIP)


@dataclass(frozen=True)
class AgentInfo:
    """One TPU host (= Mesos agent)."""

    agent_id: str
    pod_id: int
    host_index: int  # index within the pod

    @property
    def capacity(self) -> ResourceSpec:
        return ResourceSpec.per_host()


@dataclass(frozen=True)
class Offer:
    """A resource offer: free resources on one agent."""

    offer_id: str
    agent: AgentInfo
    available: ResourceSpec
