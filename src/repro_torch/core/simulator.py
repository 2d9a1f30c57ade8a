"""Discrete-event simulator driving the Scylla scheduler.

Deterministic (no wall clock, no unseeded randomness).  Because step time
depends on *current* contention/stragglers, running jobs are re-modeled on
every cluster change: progress is integrated up to the event time, then the
finish event is re-issued (stale events are dropped via versioning).

Produces the data behind the paper's figures: utilization traces (Figs
8-11), makespan/throughput comparisons (co-scheduled vs exclusive), policy
comparisons (Figs 12-13), and overhead amortization (Fig 5).
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional

from .cluster import Cluster, ClusterSpec
from .jobs import JobPhase, JobSpec, JobState
from .scheduler import ScyllaScheduler


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    payload: dict = field(compare=False, default_factory=dict)


class Simulator:
    def __init__(self, cluster_spec: ClusterSpec, *, co_schedule=True,
                 default_policy="spread", dryrun_profiles=None, overlap=0.0,
                 compile_cache=False, migrate_stragglers=False):
        self.cluster = Cluster(cluster_spec)
        self.sched = ScyllaScheduler(
            self.cluster, co_schedule=co_schedule,
            default_policy=default_policy, dryrun_profiles=dryrun_profiles,
            overlap=overlap, compile_cache=compile_cache)
        self.migrate_stragglers = migrate_stragglers
        self._heap: list[_Event] = []
        self._seq = 0
        self._job_version: dict[str, int] = {}
        self._progress_at: dict[str, tuple[float, float]] = {}  # jid -> (t, steps)
        self.now = 0.0
        self.util_trace: list[tuple[float, float]] = []
        self.events_log: list[tuple[float, str, str]] = []
        self.events_processed = 0

    # ------------------------------------------------------------ seeding
    def _push(self, time: float, kind: str, **payload):
        self._seq += 1
        heapq.heappush(self._heap, _Event(time, self._seq, kind, payload))

    def submit_at(self, t: float, spec: JobSpec):
        self._push(t, "submit", spec=spec)

    def fail_host_at(self, t: float, agent_id: str):
        self._push(t, "fail_host", agent_id=agent_id)

    def heal_host_at(self, t: float, agent_id: str):
        self._push(t, "heal_host", agent_id=agent_id)

    def straggle_at(self, t: float, agent_id: str, slowdown: float):
        self._push(t, "straggler", agent_id=agent_id, slowdown=slowdown)

    # ------------------------------------------------------- progress math
    def _integrate_progress(self, job: JobState):
        """Advance steps_done up to self.now under the old step time."""
        jid = job.spec.job_id
        t0, steps0 = self._progress_at.get(jid, (job.start_time, 0.0))
        if self.now <= t0:
            return steps0
        st = self.sched.step_time_s(job)
        steps = steps0 + max(0.0, (self.now - t0)) / max(st, 1e-12)
        steps = min(steps, float(job.spec.steps))
        job.steps_done = int(steps)
        cpe = job.spec.checkpoint_every
        job.last_checkpoint_step = (job.steps_done // cpe) * cpe
        self._progress_at[jid] = (self.now, steps)
        return steps

    def _reissue_finish(self, job: JobState):
        jid = job.spec.job_id
        steps = self._progress_at.get(jid, (job.start_time, 0.0))[1]
        st = self.sched.step_time_s(job)
        t_fin = max(self.now, job.start_time) + (job.spec.steps - steps) * st
        self._job_version[jid] = self._job_version.get(jid, 0) + 1
        self._push(t_fin, "finish", job_id=jid,
                   version=self._job_version[jid])

    def _remodel_running(self):
        for job in list(self.sched.running.values()):
            self._integrate_progress(job)
            self._reissue_finish(job)

    def _record_util(self):
        """One sample per processed event, taken after all of the event's
        state changes (run() is the only caller).  Recording inside the
        handlers too used to emit duplicate/mid-update samples at the same
        timestamp, skewing the time-weighted average in results()."""
        self.util_trace.append((self.now, self.cluster.utilization()))

    # ----------------------------------------------------------- main loop
    def _schedule_round(self):
        started = self.sched.try_schedule(self.now)
        for job in started:
            jid = job.spec.job_id
            self._progress_at[jid] = (job.start_time, 0.0)
            self._reissue_finish(job)
            self.events_log.append((self.now, "start", jid))
        if started:
            self._remodel_running()

    def run(self, until: float = float("inf")) -> dict:
        while self._heap and self._heap[0].time <= until:
            ev = heapq.heappop(self._heap)
            self.now = ev.time
            if ev.kind == "submit":
                self.sched.submit(ev.payload["spec"], self.now)
                self.events_log.append((self.now, "submit",
                                        ev.payload["spec"].job_id))
                self._remodel_running()
                self._schedule_round()
            elif ev.kind == "finish":
                jid = ev.payload["job_id"]
                if ev.payload["version"] != self._job_version.get(jid):
                    continue  # stale
                if jid not in self.sched.running:
                    continue
                self.sched.finish(jid, self.now)
                self._progress_at.pop(jid, None)
                self.events_log.append((self.now, "finish", jid))
                self._remodel_running()
                self._schedule_round()
            elif ev.kind == "fail_host":
                self._remodel_running()
                victims = self.sched.on_host_failure(ev.payload["agent_id"],
                                                     self.now)
                for job in victims:
                    self._job_version[job.spec.job_id] = \
                        self._job_version.get(job.spec.job_id, 0) + 1
                    self._progress_at.pop(job.spec.job_id, None)
                    self.events_log.append((self.now, "evict",
                                            job.spec.job_id))
                self._remodel_running()
                self._schedule_round()
            elif ev.kind == "heal_host":
                self.cluster.heal_host(ev.payload["agent_id"])
                self._schedule_round()
            elif ev.kind == "straggler":
                self._remodel_running()
                self.cluster.set_straggler(ev.payload["agent_id"],
                                           ev.payload["slowdown"])
                self._remodel_running()
                if self.migrate_stragglers:
                    for jid in self.sched.stragglers_to_migrate():
                        job = self.sched.running[jid]
                        self._integrate_progress(job)
                        self.sched.evict(jid, self.now, to_checkpoint=True)
                        self._job_version[jid] = \
                            self._job_version.get(jid, 0) + 1
                        self._progress_at.pop(jid, None)
                        self.events_log.append((self.now, "migrate", jid))
                    self._schedule_round()
            self.events_processed += 1
            self._record_util()
        return self.results()

    # ------------------------------------------------------------ results
    def results(self) -> dict:
        jobs = dict(self.sched.done)
        makespan = max((j.finish_time for j in jobs.values()), default=0.0)
        trace = sorted(self.util_trace)
        # time-weighted average utilization over [0, makespan]
        avg_util = 0.0
        if makespan > 0 and len(trace) > 1:
            area, prev_t, prev_u = 0.0, 0.0, 0.0
            for t, u in trace:
                t = min(t, makespan)
                area += (t - prev_t) * prev_u
                prev_t, prev_u = t, u
            area += (makespan - prev_t) * prev_u
            avg_util = area / makespan
        waits = [max(0.0, j.start_time - j.submit_time)
                 for j in jobs.values()]
        return {
            "jobs": jobs,
            "makespan": makespan,
            "avg_utilization": avg_util,
            "util_trace": trace,
            "mean_wait_s": sum(waits) / len(waits) if waits else 0.0,
            "restarts": sum(j.restarts for j in jobs.values()),
            "pending": len(self.sched.pending),
            "running": len(self.sched.running),
        }


# ===================================================================== churn
# Serving-side churn simulation: drives the REAL runtime Autoscaler over a
# fake disaggregated replica pool at thousands-of-requests scale.  No jax,
# no engines — requests are (prefill_ticks, decode_ticks) work items — so
# scaling scenarios the real cluster validates at small scale
# (tests/test_disagg.py) can run 1000x larger here, deterministically.

@dataclass
class SimRequest:
    """One synthetic request: remaining ticks of prefill/decode work."""

    rid: int
    prefill_left: int
    decode_left: int
    tenant: str = "free"


@dataclass
class SimReplica:
    """One fake replica: role, slot capacity, lifecycle state, and the
    requests currently occupying its slots."""

    rid: int
    role: str
    slots: int
    state: str = "up"  # up | draining | down
    active: list = field(default_factory=list)

    def free(self) -> int:
        return self.slots - len(self.active)


class ServeChurnSim:
    """Churn harness implementing the ``Autoscaler`` adapter protocol.

    The tick loop mirrors ``DisaggRouter.step``: arrivals queue for
    prefill, finished prefills move to a handoff queue, decode replicas
    adopt them, completions drain out.  The autoscaler under test is the
    same object the real router runs; the sim only fakes the replicas.

    ``trace`` is the per-tick arrival count (the default is a
    burst / idle / burst shape that forces scale-ups AND scale-downs);
    ``prefill_ticks`` / ``decode_ticks`` are (lo, hi) work ranges drawn
    per request from the seeded rng.
    """

    ROLE_SPECS = ("prefill", "decode")

    def __init__(self, *, slots: int = 4, init_replicas: int = 1,
                 max_replicas: int = 4, min_replicas: int = 1,
                 policy: str = "queue-depth", cooldown: int = 10,
                 sustain: int = 3, trace=None, seed: int = 0,
                 prefill_ticks=(1, 3), decode_ticks=(4, 12),
                 tenant_weights=None):
        import numpy as _np

        from repro_torch.runtime.autoscale import Autoscaler

        self.rng = _np.random.default_rng(seed)
        self.slots = slots
        self.prefill_ticks = prefill_ticks
        self.decode_ticks = decode_ticks
        self.tenant_weights = dict(tenant_weights
                                   or {"gold": 3.0, "free": 1.0})
        if trace is None:
            trace = [3] * 60 + [0] * 80 + [2] * 60
        self.trace = list(trace)
        self.replicas: list[SimReplica] = []
        for role in self.ROLE_SPECS:
            for i in range(max_replicas):
                self.replicas.append(SimReplica(
                    rid=len(self.replicas), role=role, slots=slots,
                    state="up" if i < init_replicas else "down"))
        self.prefill_queue: list[SimRequest] = []
        self.handoff_queue: list[SimRequest] = []
        self.completed = 0
        self.arrived = 0
        self.tick_now = 0
        self.bounds_ok = True
        self.replica_trace: list[dict] = []
        self.autoscaler = Autoscaler(
            self, policy, min_replicas=min_replicas,
            max_replicas=max_replicas, cooldown=cooldown, sustain=sustain)

    # ----------------------------------------------- autoscaler adapter
    def scale_roles(self):
        return list(self.ROLE_SPECS)

    def _of_role(self, role, *states):
        return [r for r in self.replicas
                if r.role == role and r.state in states]

    def replica_state(self, rid: int) -> str:
        return self.replicas[rid].state

    def observe(self, role: str):
        from repro_torch.runtime.autoscale import RoleObservation
        live = self._of_role(role, "up")
        backlog = (self.prefill_queue if role == "prefill"
                   else self.handoff_queue)
        return RoleObservation(
            role=role, live=len(live), backlog=len(backlog),
            weighted_backlog=sum(
                self.tenant_weights.get(r.tenant, 1.0) for r in backlog),
            free_slots=sum(r.free() for r in live),
            slots_per_replica=self.slots)

    def scale_up(self, role: str):
        down = self._of_role(role, "down")
        if not down:
            return None
        down[0].state = "up"
        return down[0].rid

    def begin_scale_down(self, role: str):
        up = self._of_role(role, "up")
        if not up:
            return None
        victim = min(up, key=lambda r: (len(r.active), -r.rid))
        victim.state = "draining"
        # drain-migrate, as the real router does through release():
        # prefill work requeues (its progress is a few ticks), decode
        # work re-enters the handoff queue checkpoint-style
        if victim.role == "prefill":
            self.prefill_queue = victim.active + self.prefill_queue
        else:
            self.handoff_queue = victim.active + self.handoff_queue
        victim.active = []
        return victim.rid

    # ------------------------------------------------------------ ticking
    def _arrive(self, n: int) -> None:
        for _ in range(n):
            self.arrived += 1
            self.prefill_queue.append(SimRequest(
                rid=self.arrived,
                prefill_left=int(self.rng.integers(*self.prefill_ticks,
                                                   endpoint=True)),
                decode_left=int(self.rng.integers(*self.decode_ticks,
                                                  endpoint=True)),
                tenant=("gold" if self.rng.random() < 0.3 else "free")))

    def _place(self, queue: list, role: str) -> None:
        for rep in self._of_role(role, "up"):
            while queue and rep.free() > 0:
                rep.active.append(queue.pop(0))

    def step(self) -> None:
        t = self.tick_now
        self._arrive(self.trace[t] if t < len(self.trace) else 0)
        self.autoscaler.tick(t)
        # advance + harvest both stages (draining replicas keep working)
        for rep in self._of_role("prefill", "up", "draining"):
            done = []
            for req in rep.active:
                req.prefill_left -= 1
                if req.prefill_left <= 0:
                    done.append(req)
            for req in done:
                rep.active.remove(req)
                self.handoff_queue.append(req)
        for rep in self._of_role("decode", "up", "draining"):
            done = []
            for req in rep.active:
                req.decode_left -= 1
                if req.decode_left <= 0:
                    done.append(req)
            for req in done:
                rep.active.remove(req)
                self.completed += 1
        self._place(self.prefill_queue, "prefill")
        self._place(self.handoff_queue, "decode")
        for rep in self.replicas:
            if rep.state == "draining" and not rep.active:
                rep.state = "down"
        counts = {}
        for role in self.ROLE_SPECS:
            n = len(self._of_role(role, "up", "draining"))
            counts[role] = n
            lo, hi = self.autoscaler.bounds(
                role, len(self._of_role(role, "up", "draining", "down")))
            if not lo <= n <= hi:
                self.bounds_ok = False
        self.replica_trace.append(counts)
        self.tick_now += 1

    def pending(self) -> int:
        return (len(self.prefill_queue) + len(self.handoff_queue)
                + sum(len(r.active) for r in self.replicas))

    def run(self, max_ticks: int = 10_000) -> dict:
        while (self.tick_now < len(self.trace) or self.pending()):
            if self.tick_now >= max_ticks:
                break
            self.step()
        return self.results()

    def results(self) -> dict:
        peak = {role: max(tr[role] for tr in self.replica_trace)
                for role in self.ROLE_SPECS} if self.replica_trace else {}
        return {
            "arrived": self.arrived,
            "completed": self.completed,
            "lost": self.arrived - self.completed - self.pending(),
            "pending": self.pending(),
            "ticks": self.tick_now,
            "bounds_respected": self.bounds_ok,
            "peak_replicas": peak,
            "scale_ups": self.autoscaler.scale_ups,
            "scale_downs": self.autoscaler.scale_downs,
            "events": [dataclasses.asdict(e)
                       for e in self.autoscaler.events],
        }
