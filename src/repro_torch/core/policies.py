"""Placement policies — the paper's core contribution (Section V.C).

* ``SpreadPolicy``  — distribute a job's chips across as many (and as empty)
  hosts as possible: minimizes host-level contention (input pipeline, DCN
  NIC), at the cost of crossing pods -> DP collectives on DCN.
* ``MinHostPolicy`` — pack into the fewest hosts, preferring a single pod:
  keeps collectives on ICI, at the cost of sharing hosts with other jobs.
* ``AutoPolicy``    — beyond-paper: generates both candidates (plus a
  spread-within-one-pod hybrid) and picks the one whose *predicted* step
  time under the roofline cost model is lowest.  This generalizes the
  paper's static per-application policy choice into a cost-driven decision.

A placement is an assignment {agent_id -> chips}; gang semantics — either
the full demand is satisfiable from the offers or the job stays pending.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from . import costmodel
from .jobs import JobSpec
from .resources import Offer


@dataclass(frozen=True)
class Placement:
    assignment: dict  # agent_id -> chips
    policy: str

    @property
    def n_hosts(self) -> int:
        return len(self.assignment)

    def n_pods(self, offers_by_id) -> int:
        return len({offers_by_id[a].agent.pod_id for a in self.assignment})


def _by_pod(offers):
    pods = {}
    for o in offers:
        pods.setdefault(o.agent.pod_id, []).append(o)
    return pods


class PlacementPolicy:
    name = "base"

    def place(self, job: JobSpec, offers: list[Offer],
              cluster=None) -> Optional[Placement]:
        raise NotImplementedError


class SpreadPolicy(PlacementPolicy):
    name = "spread"

    def place(self, job, offers, cluster=None):
        total_free = sum(o.available.chips for o in offers)
        if total_free < job.chips:
            return None
        # emptiest hosts first (avoid co-location), round-robin across pods
        pods = _by_pod(offers)
        for p in pods:
            pods[p] = sorted(pods[p], key=lambda o: -o.available.chips)
        order = []
        idx = {p: 0 for p in pods}
        pod_ids = sorted(pods)
        while any(idx[p] < len(pods[p]) for p in pod_ids):
            for p in pod_ids:
                if idx[p] < len(pods[p]):
                    order.append(pods[p][idx[p]])
                    idx[p] += 1
        # one chip per host per round until demand met
        remaining = job.chips
        free = {o.agent.agent_id: o.available.chips for o in order}
        assignment = {o.agent.agent_id: 0 for o in order}
        while remaining > 0:
            progressed = False
            for o in order:
                aid = o.agent.agent_id
                if remaining > 0 and assignment[aid] < free[aid]:
                    assignment[aid] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                return None
        return Placement({a: c for a, c in assignment.items() if c}, self.name)


class MinHostPolicy(PlacementPolicy):
    name = "minhost"

    def place(self, job, offers, cluster=None):
        total_free = sum(o.available.chips for o in offers)
        if total_free < job.chips:
            return None
        # prefer the single pod with the most free capacity; within a pod,
        # fullest-fitting hosts first (fewest hosts overall)
        pods = _by_pod(offers)
        pod_order = sorted(pods, key=lambda p: -sum(o.available.chips
                                                    for o in pods[p]))
        assignment: dict = {}
        remaining = job.chips
        for p in pod_order:
            for o in sorted(pods[p], key=lambda o: -o.available.chips):
                if remaining <= 0:
                    break
                take = min(o.available.chips, remaining)
                assignment[o.agent.agent_id] = take
                remaining -= take
            if remaining <= 0:
                break
        if remaining > 0:
            return None
        return Placement(assignment, self.name)


class AutoPolicy(PlacementPolicy):
    """Cost-model-driven policy (beyond paper, see DESIGN.md §5)."""

    name = "auto"

    def __init__(self, dryrun_profiles: dict | None = None,
                 overlap: float = 0.0):
        self.dryrun_profiles = dryrun_profiles or {}
        self.overlap = overlap

    def place(self, job, offers, cluster=None):
        candidates = []
        for pol in (SpreadPolicy(), MinHostPolicy(), _SpreadOnePod()):
            pl = pol.place(job, offers, cluster)
            if pl is not None:
                candidates.append(pl)
        if not candidates:
            return None
        profile, infeed = costmodel.job_profile(job, self.dryrun_profiles)
        agents = {o.agent.agent_id: o.agent for o in offers}

        def predict(pl: Placement) -> float:
            sharing = 1.0
            if cluster is not None:
                shares = [len(cluster.hosts[a].jobs) + 1 for a in pl.assignment]
                sharing = sum(shares) / len(shares)
            view = costmodel.PlacementView(
                chips=job.chips, n_hosts=pl.n_hosts,
                n_pods=len({agents[a].pod_id for a in pl.assignment}),
                host_sharing=sharing)
            return costmodel.step_time(profile, infeed, view,
                                       overlap=self.overlap)["step_s"]

        best = min(candidates, key=predict)
        return dataclasses.replace(best, policy=f"auto->{best.policy}")


class _SpreadOnePod(PlacementPolicy):
    """Spread across hosts but constrained to the fewest pods possible."""

    name = "spread1pod"

    def place(self, job, offers, cluster=None):
        pods = _by_pod(offers)
        # try single pods with enough capacity, emptiest-host spread inside
        for p in sorted(pods, key=lambda p: -sum(o.available.chips
                                                 for o in pods[p])):
            if sum(o.available.chips for o in pods[p]) >= job.chips:
                return SpreadPolicy().place(job, pods[p], cluster)
        return None


POLICIES = {
    "spread": SpreadPolicy,
    "minhost": MinHostPolicy,
    "auto": AutoPolicy,
    "spread1pod": _SpreadOnePod,
}


def get_policy(name: str, **kw) -> PlacementPolicy:
    cls = POLICIES[name]
    try:
        return cls(**kw)
    except TypeError:
        return cls()
