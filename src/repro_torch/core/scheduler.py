"""Scylla scheduler: offer negotiation + DRF + gang placement + lifecycle.

The control flow mirrors the paper's Figure 3 event flow:

1. agents advertise free resources (``cluster.advertise``),
2. the broker offers them to frameworks in DRF order,
3. the framework's placement policy packs the job onto accepted offers
   (gang semantics: all-or-nothing),
4. launch = XLA compile (the container-creation overhead analogue) + run.

Fault tolerance: host failure kills every gang with chips on that host; the
scheduler rolls each victim back to its last checkpoint and re-queues it —
re-placement may land on a *different* submesh shape (elastic restart,
mirrored by checkpoint/reshard in the real runtime).  Straggler mitigation:
a slowed host inflates its gangs' step time (gang = lockstep SPMD); jobs can
be migrated off when the slowdown exceeds a threshold.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import costmodel
from .cluster import Cluster
from .drf import DRFAllocator
from .jobs import JobPhase, JobSpec, JobState
from .policies import get_policy
from .resources import ResourceSpec

CHECKPOINT_WRITE_S = 2.0
RESTORE_BW_PER_HOST = 10e9  # bytes/s checkpoint restore


class ScyllaScheduler:
    def __init__(self, cluster: Cluster, *, co_schedule: bool = True,
                 default_policy: str = "spread",
                 dryrun_profiles: Optional[dict] = None,
                 overlap: float = 0.0,
                 straggler_threshold: float = 2.0,
                 compile_cache: bool = False):
        self.cluster = cluster
        self.co_schedule = co_schedule
        self.default_policy = default_policy
        self.dryrun_profiles = dryrun_profiles or {}
        self.overlap = overlap
        self.straggler_threshold = straggler_threshold
        self.compile_cache = compile_cache
        self._compiled: set = set()
        self.drf = DRFAllocator(cluster.total())
        self.pending: list[JobState] = []
        self.running: dict[str, JobState] = {}
        self.done: dict[str, JobState] = {}

    # ------------------------------------------------------------- submit
    def submit(self, spec: JobSpec, now: float) -> JobState:
        js = JobState(spec=spec, submit_time=now)
        self.pending.append(js)
        self.drf.register(spec.framework)
        return js

    # ---------------------------------------------------------- negotiate
    def try_schedule(self, now: float) -> list[JobState]:
        """One negotiation round; returns jobs started this round."""
        started = []
        candidates = {js.spec.framework for js in self.pending}
        while True:
            if not self.co_schedule and self.running:
                break  # exclusive (traditional HPC) mode: one gang at a time
            offers = self.cluster.advertise()
            # straggler mitigation: never place new gangs on flagged hosts
            offers = [o for o in offers
                      if self.cluster.hosts[o.agent.agent_id].slowdown
                      < self.straggler_threshold]
            if not offers or not candidates:
                break
            fw = self.drf.next_framework(sorted(candidates))
            if fw is None:
                break
            job = next((j for j in self.pending if j.spec.framework == fw),
                       None)
            if job is None:
                candidates.discard(fw)
                continue
            pol_name = job.spec.policy or self.default_policy
            policy = get_policy(pol_name, dryrun_profiles=self.dryrun_profiles,
                                overlap=self.overlap) \
                if pol_name == "auto" else get_policy(pol_name)
            placement = policy.place(job.spec, offers, self.cluster)
            if placement is None:
                candidates.discard(fw)  # framework declines this round
                continue
            self.cluster.allocate(job.spec.job_id, placement.assignment)
            res = ResourceSpec(job.spec.chips,
                               job.spec.chips * 16e9)
            self.drf.charge(fw, res)
            self.pending.remove(job)
            job.phase = JobPhase.RUNNING
            job.assignment = dict(placement.assignment)
            job.layout = costmodel.recommended_layout(job.spec.arch)
            job.start_time = now + self.launch_overhead_s(job.spec)
            self.running[job.spec.job_id] = job
            started.append(job)
        return started

    def launch_overhead_s(self, spec: JobSpec) -> float:
        key = (spec.arch, spec.shape, spec.chips)
        if self.compile_cache and key in self._compiled:
            return 1.0  # warm cache: dispatch/layout only
        self._compiled.add(key)
        return costmodel.compile_overhead_s(spec.arch)

    # ------------------------------------------------------------ timing
    def placement_view(self, job: JobState) -> costmodel.PlacementView:
        hosts = [self.cluster.hosts[a] for a in job.assignment]
        sharing = (sum(len(h.jobs) for h in hosts) / len(hosts)) if hosts else 1.0
        return costmodel.PlacementView(
            chips=job.spec.chips,
            n_hosts=len(hosts),
            n_pods=len({h.agent.pod_id for h in hosts}),
            max_host_slowdown=max((h.slowdown for h in hosts), default=1.0),
            host_sharing=max(sharing, 1.0),
        )

    def step_time_s(self, job: JobState) -> float:
        profile, infeed = costmodel.job_profile(job.spec, self.dryrun_profiles)
        terms = costmodel.step_time(profile, infeed, self.placement_view(job),
                                    overlap=self.overlap)
        return terms["step_s"]

    # ----------------------------------------------------------- endings
    def finish(self, job_id: str, now: float) -> JobState:
        job = self.running.pop(job_id)
        job.phase = JobPhase.DONE
        job.finish_time = now
        job.steps_done = job.spec.steps
        self.cluster.release(job_id)
        self.drf.credit(job.spec.framework,
                        ResourceSpec(job.spec.chips, job.spec.chips * 16e9))
        self.done[job_id] = job
        return job

    def evict(self, job_id: str, now: float, *, to_checkpoint: bool) -> JobState:
        """Kill a running gang; roll back and requeue (fault tolerance)."""
        job = self.running.pop(job_id)
        self.cluster.release(job_id)
        self.drf.credit(job.spec.framework,
                        ResourceSpec(job.spec.chips, job.spec.chips * 16e9))
        if to_checkpoint:
            job.steps_done = job.last_checkpoint_step
        job.assignment = {}
        job.phase = JobPhase.PENDING
        job.restarts += 1
        self.pending.insert(0, job)
        return job

    def on_host_failure(self, agent_id: str, now: float) -> list[JobState]:
        victims = self.cluster.fail_host(agent_id)
        out = []
        for jid in victims:
            # chips on the dead host are already gone; release the rest
            out.append(self.evict(jid, now, to_checkpoint=True))
        return out

    def stragglers_to_migrate(self) -> list[str]:
        out = []
        for jid, job in self.running.items():
            v = self.placement_view(job)
            if v.max_host_slowdown >= self.straggler_threshold:
                out.append(jid)
        return out

    def restore_overhead_s(self, spec: JobSpec, n_hosts: int) -> float:
        from repro_torch.configs import get_config

        nbytes = get_config(spec.arch).param_count() * 12.0
        return CHECKPOINT_WRITE_S + nbytes / (max(n_hosts, 1)
                                              * RESTORE_BW_PER_HOST)
