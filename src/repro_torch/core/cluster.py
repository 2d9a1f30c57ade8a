"""Cluster state: agents (TPU hosts), allocations, failures, stragglers.

Mirrors the Mesos master's view of the world.  The cluster is organized as
``n_pods`` pods of ``hosts_per_pod`` hosts of ``CHIPS_PER_HOST`` chips;
allocation granularity is whole chips (TPUs are space-shared, not
time-sliced — DESIGN.md §2 note 4).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from . import hw
from .resources import AgentInfo, Offer, ResourceSpec


@dataclass(frozen=True)
class ClusterSpec:
    n_pods: int = 2
    hosts_per_pod: int = hw.HOSTS_PER_POD
    chips_per_host: int = hw.CHIPS_PER_HOST

    @property
    def n_hosts(self) -> int:
        return self.n_pods * self.hosts_per_pod

    @property
    def n_chips(self) -> int:
        return self.n_hosts * self.chips_per_host


@dataclass
class HostState:
    agent: AgentInfo
    alive: bool = True
    slowdown: float = 1.0  # >1.0 -> straggler
    used_chips: int = 0
    jobs: dict = field(default_factory=dict)  # job_id -> chips on this host

    @property
    def free_chips(self) -> int:
        return (hw.CHIPS_PER_HOST - self.used_chips) if self.alive else 0

    @property
    def free(self) -> ResourceSpec:
        return ResourceSpec(self.free_chips, self.free_chips * hw.HBM_PER_CHIP)


class Cluster:
    def __init__(self, spec: ClusterSpec):
        self.spec = spec
        self.hosts: dict[str, HostState] = {}
        for p in range(spec.n_pods):
            for h in range(spec.hosts_per_pod):
                aid = f"pod{p}/host{h:03d}"
                self.hosts[aid] = HostState(AgentInfo(aid, p, h))
        self._offer_seq = 0

    # ------------------------------------------------------------- offers
    def advertise(self) -> list[Offer]:
        """All agents advertise their free resources (Mesos step 1)."""
        offers = []
        for hs in self.hosts.values():
            if hs.alive and hs.free_chips > 0:
                self._offer_seq += 1
                offers.append(Offer(f"offer-{self._offer_seq}", hs.agent,
                                    hs.free))
        return offers

    # --------------------------------------------------------- allocation
    def allocate(self, job_id: str, assignment: dict[str, int]) -> None:
        """assignment: agent_id -> chips.  All-or-nothing (gang)."""
        for aid, chips in assignment.items():
            hs = self.hosts[aid]
            if not hs.alive or hs.free_chips < chips:
                raise ValueError(f"over-allocation on {aid} for {job_id}")
        for aid, chips in assignment.items():
            hs = self.hosts[aid]
            hs.used_chips += chips
            hs.jobs[job_id] = hs.jobs.get(job_id, 0) + chips

    def release(self, job_id: str) -> None:
        for hs in self.hosts.values():
            if job_id in hs.jobs:
                hs.used_chips -= hs.jobs.pop(job_id)

    def job_hosts(self, job_id: str) -> dict[str, int]:
        return {aid: hs.jobs[job_id] for aid, hs in self.hosts.items()
                if job_id in hs.jobs}

    # ------------------------------------------------------ fault events
    def fail_host(self, agent_id: str) -> list[str]:
        """Kill a host; returns the job_ids that were running on it."""
        hs = self.hosts[agent_id]
        hs.alive = False
        victims = list(hs.jobs)
        hs.used_chips = 0
        hs.jobs.clear()
        return victims

    def heal_host(self, agent_id: str) -> None:
        self.hosts[agent_id].alive = True
        self.hosts[agent_id].slowdown = 1.0

    def set_straggler(self, agent_id: str, slowdown: float) -> list[str]:
        self.hosts[agent_id].slowdown = slowdown
        return list(self.hosts[agent_id].jobs)

    # ----------------------------------------------------------- metrics
    def total(self) -> ResourceSpec:
        alive = [h for h in self.hosts.values() if h.alive]
        chips = sum(hw.CHIPS_PER_HOST for _ in alive)
        return ResourceSpec(chips, chips * hw.HBM_PER_CHIP)

    def used(self) -> ResourceSpec:
        chips = sum(h.used_chips for h in self.hosts.values())
        return ResourceSpec(chips, chips * hw.HBM_PER_CHIP)

    def utilization(self) -> float:
        tot = self.total()
        return (self.used().chips / tot.chips) if tot.chips else 0.0
