"""Fault-tolerant multi-replica serving: an offer-based cluster router.

The serving mirror of the seed's Mesos half (``core/cluster.py`` +
``core/scheduler.py``): each ``ServeEngine`` replica is a Scylla
framework task, and the ``ClusterRouter`` is the framework scheduler in
front of the pool.  Every router tick:

1. **Offers** — each placeable replica advertises ``ReplicaOffer(free
   slots, free KV pages, queue depth)`` (``ServeEngine.offer()``, the
   ``Cluster.advertise`` analogue).
2. **Health** — replicas heartbeat; ``miss_threshold`` consecutive
   misses mark a replica ``LOST`` (``ScyllaScheduler.on_host_failure``'s
   serving twin).  A LOST replica is *fenced* — its engine is discarded
   so a zombie (e.g. a partitioned replica that kept stepping) can never
   emit into a stream the router has already re-placed.
3. **Recovery** — every in-flight request on a lost replica re-enters
   the router queue at the FRONT and resumes on a surviving replica by
   **deterministic replay**: the prompt is extended with the tokens the
   client already received and re-prefilled, and the position-folded
   sampling makes the continuation bitwise-identical to the uninterrupted
   stream (greedy and seeded-sampled alike — gated in
   ``tests/test_cluster_serve.py``).  Each recovery consumes one unit of
   the request's ``retry_budget`` and backs off exponentially
   (``backoff_ticks * 2**(retries-1)``) before re-placement.
4. **Placement** — queued requests are placed through a registered
   ``RouterPolicy`` (``pack``/``spread``, mirroring
   ``core/policies.get_policy``): ``pack`` fills the busiest fitting
   replica (consolidate; keeps spare replicas drainable), ``spread``
   targets the emptiest (load-balance; the throughput default).
5. **Stepping** — each live replica runs one engine tick under a
   ``runtime.fault.StepWatchdog``; a flagged straggler is routed around
   (no new placements) until ``slow_cooldown`` ticks pass without a new
   flag.

Brown-out degradation: while any replica is LOST or flagged slow, the
pool is degraded and the router switches placement to strict weighted
order — requests from higher-``tenant_weights`` tiers (gold) place
first, and a lower tier only places once every higher-tier request has
(head-of-line).  Free-tier load is thereby shed exactly while capacity
is reduced, protecting the gold SLO; nothing is dropped — shed requests
simply wait for capacity to recover or the gold backlog to drain.

Chaos is injected through ``runtime.fault.ReplicaFaultInjector`` — a
seeded, reproducible schedule of kill / rejoin / stall / heartbeat-drop
/ page-pressure / drain events — so every chaos run can be compared
bitwise against its fault-free twin (``benchmarks/cluster_serve.py``).
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.runtime.fault import ReplicaFaultInjector, StepWatchdog
from repro_torch.runtime.serve import Request, RequestState, ServeStalled
from repro_torch.runtime.telemetry import ROUTER_PID, Telemetry

__all__ = ["ClusterRouter", "ReplicaHandle", "ReplicaOffer", "ReplicaState",
           "RouterHandle", "RouterPolicy", "ROUTER_POLICIES",
           "get_router_policy", "reset_for_replay"]


class ReplicaState(enum.Enum):
    UP = "up"            # serving; offers flow
    DRAINING = "draining"  # no new placements; in-flight finishes
    LOST = "lost"        # failed the heartbeat threshold; fenced
    DOWN = "down"        # drained out (or never joined); awaiting rejoin


@dataclass(frozen=True)
class ReplicaOffer:
    """One replica's advertised free resources for this router tick."""

    replica: int
    free_slots: int
    free_pages: Optional[int]  # None: dense cache (slots only)
    page_size: Optional[int]
    queue_depth: int
    # sharded paged replicas (ServeConfig.mesh_shape with > 1 data host)
    # advertise the per-host sub-pool split behind ``free_pages``; None
    # for dense or unsharded replicas.  Routing policies key on the
    # aggregate, so sharded and unsharded replicas mix in one pool.
    free_pages_by_host: Optional[list] = None


# ---------------------------------------------------------------- policies
class RouterPolicy:
    """Chooses which offering replica a queued request is placed on
    (registered in ``ROUTER_POLICIES``, mirroring
    ``core/policies.POLICIES``)."""

    name = "base"

    def select(self, offers: list) -> ReplicaOffer:
        """Pick from ``offers`` (every entry already fits the request)."""
        raise NotImplementedError


class PackRouterPolicy(RouterPolicy):
    """Fewest free slots first: consolidate load onto already-busy
    replicas so spare ones stay empty (cheap to drain, instant headroom
    for recovery bursts) — the serving analogue of ``minhost``."""

    name = "pack"

    def select(self, offers):
        return min(offers, key=lambda o: (o.free_slots, o.queue_depth,
                                          o.replica))


class SpreadRouterPolicy(RouterPolicy):
    """Most free slots first (shallowest backlog on ties): classic load
    balancing — keeps per-replica batch pressure even, the throughput
    default."""

    name = "spread"

    def select(self, offers):
        return min(offers, key=lambda o: (-o.free_slots, o.queue_depth,
                                          o.replica))


ROUTER_POLICIES = {
    "pack": PackRouterPolicy,
    "spread": SpreadRouterPolicy,
}


def get_router_policy(name) -> RouterPolicy:
    if isinstance(name, RouterPolicy):
        return name
    return ROUTER_POLICIES[name]()


# ----------------------------------------------------------------- replay
def reset_for_replay(req: Request) -> Request:
    """Rewind a request recovered from a dead replica into a submittable
    replay: the prompt absorbs every token the client already received
    (``output`` keeps them, so ``max_new_tokens`` accounting and stop
    sequences spanning the recovery boundary stay exact), and every
    engine-private field is cleared — in particular ``_preempted`` /
    ``_ckpt_pages``, which would otherwise point a fresh engine at the
    dead engine's page pool.

    Re-prefilling ``prompt + emitted`` continues the stream bitwise: the
    prefill samples at absolute position ``len(prompt') - 1`` with the
    request's own key — exactly the fold the lost replica's next decode
    step would have used.
    """
    emitted = np.asarray(req.output, np.int32)
    if emitted.size:
        req.prompt = np.concatenate(
            [np.asarray(req.prompt, np.int32), emitted])
    req.done = False
    req.state = RequestState.QUEUED
    req.finish_reason = None
    req._feed = None
    req._ckpt = None
    req._ckpt_pages = None
    req._preempted = False
    req._drf_charged = None
    req._handoff_kv = 0
    return req


# ---------------------------------------------------------------- replicas
class ReplicaHandle:
    """Router-side view of one engine replica: lifecycle state, health
    counters, the straggler watchdog, and the live fault-injection
    toggles the ``ReplicaFaultInjector`` flips."""

    def __init__(self, rid: int, make_engine: Callable[[int], object],
                 telemetry: Optional[Telemetry] = None,
                 start_down: bool = False):
        self.rid = rid
        self._make_engine = make_engine
        self.tm = telemetry
        if start_down:
            # a cold spare: no engine until an autoscaler (or operator)
            # rejoins it — costs a handle, not a model instance
            self.engine = None
            self.state = ReplicaState.DOWN
        else:
            self.engine = make_engine(rid)
            self._bind_engine()
            self.state = ReplicaState.UP
        self.misses = 0
        self.slow = False
        self.slow_until = -1
        self.watchdog = StepWatchdog()
        # fault-injection state
        self.killed = False
        self.stall_s = 0.0
        self.stall_until = -1
        self.hbdrop_until = -1
        self._pressure: list = []  # (release_tick, held_pages)
        # telemetry
        self.placements = 0
        self.steps = 0

    def _bind_engine(self) -> None:
        """Rebind the (possibly fresh) engine onto the router's shared
        telemetry sink: its series carry ``replica=rid`` labels, its
        trace spans land on pid ``rid``.  Rejoin reuses the same labels
        — the registry children are overwritten in place."""
        if self.tm is not None and hasattr(self.engine, "bind_telemetry"):
            self.engine.bind_telemetry(self.tm, replica=self.rid)

    # ------------------------------------------------------------ health
    def heartbeat(self, tick: int) -> bool:
        """Did this replica's beat arrive this tick?"""
        return not self.killed and tick > self.hbdrop_until

    def fence(self) -> None:
        """Discard the engine: a fenced replica can never write another
        token into a stream the router re-owns (zombie isolation)."""
        self.engine = None
        self.killed = True

    def rejoin(self, tick: int) -> None:
        """Fresh engine, clean health state (prefix cache and KV start
        cold — recovery correctness never depends on rejoined state)."""
        self.engine = self._make_engine(self.rid)
        self._bind_engine()
        self.state = ReplicaState.UP
        self.killed = False
        self.misses = 0
        self.slow = False
        self.slow_until = -1
        self.stall_s = 0.0
        self.stall_until = -1
        self.hbdrop_until = -1
        self._pressure = []
        self.watchdog = StepWatchdog()

    # ------------------------------------------------------------ offers
    def placeable(self, tick: int) -> bool:
        return (self.state is ReplicaState.UP and not self.killed
                and not self.slow and self.engine is not None)

    def offer(self) -> Optional[ReplicaOffer]:
        if self.engine is None:
            return None
        raw = self.engine.offer()
        return ReplicaOffer(replica=self.rid, **raw)

    def can_accept(self, req: Request) -> bool:
        return self.engine is not None and self.engine.can_accept(req)

    # ---------------------------------------------------------- stepping
    def step(self, tick: int) -> int:
        """One engine tick under the watchdog; returns tokens emitted.
        A scheduled stall sleeps first — the watchdog sees the inflated
        wall time exactly as it would a genuinely straggling host."""
        if self.engine is None:
            return 0
        if tick <= self.stall_until and self.stall_s > 0:
            time.sleep(self.stall_s)
        flagged_before = len(self.watchdog.flagged)
        self.watchdog.start()
        emitted = self.engine.step()
        self.watchdog(tick, None)
        self.steps += 1
        if len(self.watchdog.flagged) > flagged_before:
            self.slow = True
        return emitted

    # ----------------------------------------------------- page pressure
    def apply_pressure(self, tick: int, fraction: float, ticks: int):
        eng = self.engine
        if eng is None or eng.kv is None:
            return
        n = int(eng.kv.pool.available * min(max(fraction, 0.0), 1.0))
        if n:
            self._pressure.append((tick + ticks, eng.kv.pool.alloc(n)))

    def release_pressure(self, tick: int):
        keep = []
        for release_tick, pages in self._pressure:
            if tick >= release_tick and self.engine is not None:
                for pg in pages:
                    self.engine.kv.pool.decref(pg)
            else:
                keep.append((release_tick, pages))
        self._pressure = keep


# ------------------------------------------------------------------ router
@dataclass
class _RouterRequest:
    """Router-side bookkeeping for one submitted request."""

    req: Request
    seq: int                      # arrival order (FIFO key)
    t_submit: float               # router wall-clock submit stamp
    retries: int = 0              # recoveries consumed so far
    not_before: int = 0           # backoff: earliest placement tick
    replica: Optional[int] = None  # where it currently runs
    history: list = field(default_factory=list)  # replica ids tried


class RouterHandle:
    """Caller-facing view of a router-submitted request (the cluster
    twin of ``runtime.serve.RequestHandle``): ``tokens()`` streams the
    output, driving router ticks while the next token is pending."""

    def __init__(self, rr: _RouterRequest, router: "ClusterRouter"):
        self._rr = rr
        self.req = rr.req
        self._router = router

    @property
    def done(self) -> bool:
        return self.req.done

    @property
    def finish_reason(self) -> Optional[str]:
        return self.req.finish_reason

    @property
    def output(self) -> list:
        return list(self.req.output)

    @property
    def retries(self) -> int:
        return self._rr.retries

    def tokens(self, max_ticks: int = 100_000) -> Iterator[int]:
        i = stalled = 0
        while True:
            while i < len(self.req.output):
                stalled = 0
                yield self.req.output[i]
                i += 1
            if self.req.done:
                return
            self._router.step()
            stalled += 1
            if stalled > max_ticks:
                raise ServeStalled(
                    f"request {self.req.req_id} produced no token in "
                    f"{max_ticks} router ticks "
                    f"(state={self.req.state.value})")

    def result(self, max_ticks: int = 100_000) -> Request:
        for _ in self.tokens(max_ticks=max_ticks):
            pass
        return self.req

    def metrics(self) -> dict:
        """TTFT against the ROUTER submit stamp (engine restamps
        ``t_submit`` on replay; the router's is the client's)."""
        out = {"retries": self._rr.retries}
        if self.req.t_first is not None:
            out["ttft_s"] = self.req.t_first - self._rr.t_submit
        return out


class ClusterRouter:
    """Offer-based router over ``n_replicas`` engine replicas.

    ``make_engine(rid)`` builds one replica's ``ServeEngine`` (replicas
    over the same model share compiled steps through the
    ``runtime.steps`` module LRU, so N replicas cost one compile).  See
    the module docstring for the tick protocol; knobs:

    * ``policy``          — ``ROUTER_POLICIES`` name (or instance).
    * ``miss_threshold``  — consecutive heartbeat misses before LOST.
    * ``retry_budget``    — recoveries per request before it is failed
      (``finish_reason="failed"``; never silently dropped).
    * ``backoff_ticks``   — base of the per-request exponential backoff
      between recovery and re-placement.
    * ``tenant_weights``  — SLO tiers for brown-out shedding (and passed
      by callers to each engine's weighted-DRF scheduler).
    * ``injector``        — optional ``ReplicaFaultInjector`` schedule.
    * ``slow_cooldown``   — flag-free ticks before a slow replica
      re-enters the placement set.
    """

    def __init__(self, make_engine: Callable[[int], object],
                 n_replicas: int, *, policy="spread",
                 miss_threshold: int = 3, retry_budget: int = 3,
                 backoff_ticks: int = 2, tenant_weights: Optional[dict] = None,
                 injector: Optional[ReplicaFaultInjector] = None,
                 slow_cooldown: int = 20,
                 telemetry: Optional[Telemetry] = None,
                 start_down=()):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1: {n_replicas}")
        if miss_threshold < 1:
            raise ValueError(f"miss_threshold must be >= 1: "
                             f"{miss_threshold}")
        self.policy = get_router_policy(policy)
        self.miss_threshold = miss_threshold
        self.retry_budget = retry_budget
        self.backoff_ticks = backoff_ticks
        self.tenant_weights = dict(tenant_weights or {})
        self.injector = injector
        self.slow_cooldown = slow_cooldown
        self.tm = telemetry if telemetry is not None else Telemetry()
        # ``start_down`` rids begin as cold spares (DOWN, no engine) an
        # autoscaler can rejoin later without paying for them up front
        self.replicas = [ReplicaHandle(i, make_engine, telemetry=self.tm,
                                       start_down=(i in set(start_down)))
                         for i in range(n_replicas)]
        self.tick_count = 0
        self.queue: list[_RouterRequest] = []
        self.placed: dict[int, list[_RouterRequest]] = {
            r.rid: [] for r in self.replicas}
        self.finished: list[_RouterRequest] = []
        self._seq = 0
        self._handles: list[RouterHandle] = []
        # counters stay plain attributes (hot, and tests poke them);
        # the registry reads them live through function-backed gauges
        # and stats() reads BACK through the registry
        self.recoveries = 0        # requests recovered off lost replicas
        self.replicas_lost = 0
        self.failed = 0            # retry budget exhausted
        self.brownout_ticks = 0
        self._brownout_prev = False
        reg = self.tm.registry
        for name, help, fn in (
                ("cluster_ticks", "router ticks stepped",
                 lambda: self.tick_count),
                ("cluster_recoveries", "requests recovered off lost "
                 "replicas by deterministic replay",
                 lambda: self.recoveries),
                ("cluster_replicas_lost", "replicas fenced as LOST",
                 lambda: self.replicas_lost),
                ("cluster_failed", "requests failed on retry-budget "
                 "exhaustion", lambda: self.failed),
                ("cluster_brownout_ticks", "ticks spent degraded "
                 "(brown-out shedding active)",
                 lambda: self.brownout_ticks),
                ("cluster_queue_depth", "router queue backlog",
                 lambda: len(self.queue))):
            reg.gauge(name, help).labels().set_function(fn)
        g_pl = reg.gauge("cluster_replica_placements",
                         "requests placed on this replica", ("replica",))
        g_st = reg.gauge("cluster_replica_steps",
                         "engine ticks this replica stepped", ("replica",))
        for rh in self.replicas:
            g_pl.labels(replica=str(rh.rid)).set_function(
                lambda h=rh: h.placements)
            g_st.labels(replica=str(rh.rid)).set_function(
                lambda h=rh: h.steps)
        if self.tm.trace.enabled:
            self.tm.trace.set_process_name(ROUTER_PID, "router")

    # ------------------------------------------------------------- submit
    def submit(self, req: Request) -> RouterHandle:
        rr = _RouterRequest(req=req, seq=self._seq,
                            t_submit=time.perf_counter())
        self._seq += 1
        self.queue.append(rr)
        h = RouterHandle(rr, self)
        self._handles.append(h)
        return h

    # ------------------------------------------------------------- health
    def _weight(self, tenant: str) -> float:
        return float(self.tenant_weights.get(tenant, 1.0))

    def degraded(self) -> bool:
        """Capacity below nominal: any replica LOST, undetected-dead, or
        flagged slow.  (Operator drains are intended capacity changes
        and do not trigger brown-out shedding.)"""
        return any(r.state is ReplicaState.LOST or r.killed or r.slow
                   for r in self.replicas
                   if r.state is not ReplicaState.DOWN)

    def _recover_rr(self, rr: _RouterRequest, lost_rid: int) -> bool:
        """Recover one request stranded by a lost replica: consume a
        retry, fail it on budget exhaustion, otherwise rewind it for
        deterministic replay and requeue at the FRONT with exponential
        backoff.  Returns True if the request was requeued."""
        tr = self.tm.trace
        rr.retries += 1
        rr.replica = None
        if rr.retries > self.retry_budget:
            rr.req.done = True
            rr.req.state = RequestState.FINISHED
            rr.req.finish_reason = "failed"
            rr.req.t_finish = time.perf_counter()
            self.failed += 1
            self.finished.append(rr)
            if tr.enabled:
                tr.instant(ROUTER_PID, "request_failed",
                           tid=rr.req.req_id, retries=rr.retries)
            return False
        reset_for_replay(rr.req)
        rr.not_before = (self.tick_count
                         + self.backoff_ticks * 2 ** (rr.retries - 1))
        self.queue.insert(0, rr)
        self.recoveries += 1
        if tr.enabled:
            # the REPLAY span covers backoff-to-re-placement; it
            # closes in _place when the request lands again
            tr.begin(ROUTER_PID, rr.req.req_id, "REPLAY",
                     lost_replica=lost_rid, retry=rr.retries,
                     not_before=rr.not_before)
        return True

    def _flight_extra(self) -> dict:
        """Extra context merged into every fence's flight dump
        (subclasses add in-transit state — e.g. the handoff queue)."""
        return {}

    def _sweep_lost(self, rh: ReplicaHandle) -> list:
        """Collect router-held requests (outside ``placed``) stranded by
        the loss of ``rh`` — DisaggRouter returns in-transit handoffs
        whose source died.  Each return is recovered like a placed
        victim."""
        return []

    def _mark_lost(self, rh: ReplicaHandle) -> None:
        rh.state = ReplicaState.LOST
        rh.fence()
        self.replicas_lost += 1
        tr = self.tm.trace
        # the fenced replica can never emit again: close every span it
        # had open (in-flight requests mid-PREFILL/DECODE) so chaos
        # leaves no orphans, then record the fence itself
        tr.end_all(rh.rid, fenced=True)
        if tr.enabled:
            tr.instant(ROUTER_PID, "replica_lost", replica=rh.rid,
                       tick=self.tick_count,
                       in_flight=len(self.placed[rh.rid]))
        failed_before = self.failed
        recovered_before = self.recoveries
        # snapshot in-transit state BEFORE the sweep removes dead-source
        # entries: the post-mortem must show what was mid-flight at the
        # instant of the fence
        extra = self._flight_extra()
        # recover every in-flight request: FRONT of the queue, newest
        # last, so recovered work resumes before fresh arrivals place
        victims = self.placed[rh.rid]
        self.placed[rh.rid] = []
        stranded = self._sweep_lost(rh)
        for rr in reversed(victims + stranded):
            if rr.req.done:
                self.finished.append(rr)
                continue
            self._recover_rr(rr, rh.rid)
        # every fence ships its own post-mortem (covers retry
        # exhaustion too — failures happen only here)
        self.tm.dump_flight(
            f"fence-replica{rh.rid}",
            extra={"tick": self.tick_count,
                   "recovered": self.recoveries - recovered_before,
                   "failed": self.failed - failed_before, **extra})

    def _heartbeats(self) -> None:
        for rh in self.replicas:
            if rh.state not in (ReplicaState.UP, ReplicaState.DRAINING):
                continue
            if rh.heartbeat(self.tick_count):
                rh.misses = 0
            else:
                rh.misses += 1
                if self.tm.trace.enabled:
                    self.tm.trace.instant(ROUTER_PID, "hb_miss",
                                          replica=rh.rid,
                                          misses=rh.misses)
                if rh.misses >= self.miss_threshold:
                    self._mark_lost(rh)

    # ---------------------------------------------------------- lifecycle
    def drain(self, rid: int) -> None:
        """Stop placing on ``rid``; it leaves the pool once in-flight
        work finishes (``DOWN``)."""
        rh = self.replicas[rid]
        if rh.state is ReplicaState.UP:
            rh.state = ReplicaState.DRAINING

    def rejoin(self, rid: int) -> None:
        rh = self.replicas[rid]
        if rh.state in (ReplicaState.LOST, ReplicaState.DOWN):
            rh.rejoin(self.tick_count)
        elif rh.state is ReplicaState.DRAINING:
            rh.state = ReplicaState.UP

    # ------------------------------------------------------------- faults
    def _apply_event(self, ev) -> None:
        rh = self.replicas[ev.replica]
        if ev.action == "kill":
            rh.killed = True  # beats stop; detection via miss threshold
        elif ev.action == "rejoin":
            self.rejoin(ev.replica)
        elif ev.action == "stall":
            rh.stall_s = ev.arg
            rh.stall_until = self.tick_count + ev.ticks
        elif ev.action == "hbdrop":
            rh.hbdrop_until = self.tick_count + ev.ticks - 1
        elif ev.action == "pressure":
            rh.apply_pressure(self.tick_count, ev.arg, ev.ticks)
        elif ev.action == "drain":
            self.drain(ev.replica)

    # ---------------------------------------------------------- placement
    def _placement_order(self) -> list:
        """Brown-out: strict weighted order (gold first) with FIFO
        within a tier; full capacity: plain FIFO."""
        if self.degraded():
            return sorted(self.queue,
                          key=lambda rr: (-self._weight(rr.req.tenant),
                                          rr.seq))
        return list(self.queue)

    def _accepts_new(self, rh: ReplicaHandle) -> bool:
        """May fresh (router-queued) requests place on ``rh``?
        DisaggRouter narrows this to prefill-capable roles — decode
        replicas only receive handoffs."""
        return True

    def _place(self) -> None:
        candidates = [rh for rh in self.replicas
                      if rh.placeable(self.tick_count)
                      and self._accepts_new(rh)]
        # a slow replica still serves its in-flight work, but only
        # receives new load when no healthy replica can take it
        fallback = [rh for rh in self.replicas
                    if rh.state is ReplicaState.UP and rh.slow
                    and not rh.killed and rh.engine is not None
                    and self._accepts_new(rh)]
        for rr in self._placement_order():
            if rr.not_before > self.tick_count:
                continue  # backing off; doesn't block the line
            rh = self._select_replica(rr.req, candidates) \
                or self._select_replica(rr.req, fallback)
            if rh is None:
                # head-of-line: preserves FIFO fairness, and under
                # brown-out it is exactly the shed — a free-tier request
                # never jumps a gold one that is still waiting
                break
            rh.engine.submit(rr.req)
            rh.placements += 1
            rr.replica = rh.rid
            rr.history.append(rh.rid)
            self.queue.remove(rr)
            self.placed[rh.rid].append(rr)
            tr = self.tm.trace
            if tr.enabled:
                # a re-placement after loss closes its REPLAY span here
                tr.end_if_open(ROUTER_PID, rr.req.req_id,
                               placed_on=rh.rid)
                tr.instant(ROUTER_PID, "place", tid=rr.req.req_id,
                           replica=rh.rid, retry=rr.retries)

    def _select_replica(self, req: Request,
                        pool: list) -> Optional[ReplicaHandle]:
        fitting = [rh.offer() for rh in pool if rh.can_accept(req)]
        if not fitting:
            return None
        return self.replicas[self.policy.select(fitting).replica]

    # ------------------------------------------------------------ harvest
    def _can_retire(self, rh: ReplicaHandle) -> bool:
        """May a drained-empty replica leave the pool?  DisaggRouter
        holds retirement while an in-transit handoff still points at
        ``rh``'s page pool."""
        return True

    def _harvest(self) -> None:
        for rh in self.replicas:
            still = []
            for rr in self.placed[rh.rid]:
                if rr.req.done:
                    self.finished.append(rr)
                else:
                    still.append(rr)
            self.placed[rh.rid] = still
            if (rh.state is ReplicaState.DRAINING and not still
                    and self._can_retire(rh)):
                rh.state = ReplicaState.DOWN
                rh.engine = None

    # ------------------------------------------------------------- ticking
    def step(self) -> int:
        """One router tick; returns tokens emitted across the pool."""
        self.tick_count += 1
        if self.injector is not None:
            for ev in self.injector.pop(self.tick_count):
                self._apply_event(ev)
        for rh in self.replicas:
            rh.release_pressure(self.tick_count)
        self._heartbeats()
        degraded = self.degraded()
        if degraded:
            self.brownout_ticks += 1
        tr = self.tm.trace
        if tr.enabled and degraded != self._brownout_prev:
            tr.instant(ROUTER_PID,
                       "brownout_enter" if degraded else "brownout_exit",
                       tick=self.tick_count)
        self._brownout_prev = degraded
        self._place()
        emitted = 0
        for rh in self.replicas:
            if rh.state not in (ReplicaState.UP, ReplicaState.DRAINING):
                continue
            if rh.killed or rh.engine is None:
                continue
            if self.placed[rh.rid] or rh.engine.queue:
                emitted += rh.step(self.tick_count)
            if rh.slow and self.tick_count >= rh.slow_until:
                # cooldown runs from the most recent flag
                if rh.watchdog.flagged:
                    last_flag = rh.watchdog.flagged[-1][0]
                    rh.slow_until = last_flag + self.slow_cooldown
                    if self.tick_count >= rh.slow_until:
                        rh.slow = False
                else:
                    rh.slow = False
        if tr.enabled:
            for rh in self.replicas:
                if rh.slow != getattr(rh, "_slow_seen", False):
                    tr.instant(ROUTER_PID,
                               "straggler_flagged" if rh.slow
                               else "straggler_cleared", replica=rh.rid,
                               tick=self.tick_count)
                    rh._slow_seen = rh.slow
            tr.counter(ROUTER_PID, "router",
                       {"queued": len(self.queue),
                        "recoveries": self.recoveries,
                        "replicas_lost": self.replicas_lost,
                        "failed": self.failed})
        self._harvest()
        return emitted

    def _pending_counts(self) -> tuple[int, int]:
        """(queued, in-flight) requests still owed an outcome — the
        ``run()`` loop condition.  DisaggRouter counts in-transit
        handoffs as in-flight so the loop never exits mid-transfer."""
        return (len(self.queue),
                sum(len(v) for v in self.placed.values()))

    def run(self, max_ticks: int = 10_000,
            on_stall: str = "raise") -> list[Request]:
        """Drive ticks until every submitted request is done (finished
        or failed).  Stalls are reported, never silently truncated —
        same contract as ``ServeEngine.run``."""
        import warnings

        if on_stall not in ("raise", "warn"):
            raise ValueError(f"on_stall must be 'raise' or 'warn': "
                             f"{on_stall!r}")
        ticks = 0
        while sum(self._pending_counts()):
            if ticks >= max_ticks:
                queued, live = self._pending_counts()
                msg = (f"{type(self).__name__}.run() exhausted "
                       f"{max_ticks} ticks "
                       f"with {queued + live} requests undrained "
                       f"({queued} queued, {live} in flight)")
                if on_stall == "raise":
                    raise ServeStalled(msg)
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
                break
            self.step()
            ticks += 1
        out = [rr.req for rr in
               sorted(self.finished, key=lambda rr: rr.seq)]
        self.finished = []
        return out

    # ---------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """Legacy router stats dict, read back through the metrics
        registry (the ``cluster_*`` function-backed gauges) — key set is
        schema-stable (tests/test_telemetry.py)."""
        v = self.tm.registry.value
        return {
            "replicas": {
                rh.rid: {"state": rh.state.value, "slow": rh.slow,
                         "placements": int(v("cluster_replica_placements",
                                             replica=str(rh.rid))),
                         "steps": int(v("cluster_replica_steps",
                                        replica=str(rh.rid))),
                         "flags": len(rh.watchdog.flagged)}
                for rh in self.replicas},
            "ticks": int(v("cluster_ticks")),
            "recoveries": int(v("cluster_recoveries")),
            "replicas_lost": int(v("cluster_replicas_lost")),
            "failed": int(v("cluster_failed")),
            "brownout_ticks": int(v("cluster_brownout_ticks")),
            "queued": int(v("cluster_queue_depth")),
        }

    def request_metrics(self) -> list[dict]:
        """Per-request router-level metrics (TTFT vs the router submit
        stamp survives replays; the engine's restamp does not)."""
        return [dict(req_id=h.req.req_id, tenant=h.req.tenant,
                     finish_reason=h.req.finish_reason, **h.metrics())
                for h in self._handles]
