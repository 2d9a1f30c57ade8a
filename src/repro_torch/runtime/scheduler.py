"""Admission + preemption scheduling: the host-side half of every tick.

The serving mirror of ``core/policies.py``: admission policies are small
host-side objects registered in ``ADMISSION_POLICIES`` and resolved by
``get_admission_policy(name)``, exactly like placement policies.  A policy
only ever sees host bookkeeping — the queue, per-tenant accounting, a KV
reservation view — never device state; the engine's executor applies the
decisions (``ServeEngine._execute_admission`` / ``_execute_preemption``)
and runs the compiled steps.

* ``fcfs``     — first come, first served (the original behavior).
* ``priority`` — highest ``Request.priority`` first, FIFO within a level.
* ``sjf``      — shortest job first by predicted work
  (``prompt_len + max_new_tokens``): minimizes mean wait on mixed traces,
  at the cost of starving long requests under sustained short load.
* ``drf-fair`` — Dominant Resource Fairness across *tenants*, charging
  each admission's slot and KV reservation through
  ``core/drf.py``'s ``DRFAllocator`` — the direct serving analogue of
  Scylla's Mesos-level DRF across frameworks: every freed slot goes to
  the tenant with the lowest (weighted) dominant share, so a flooding
  tenant cannot starve a light one out of the pool.

The DRF resource vector is ``ServeResource(slots, kv)``: ``slots`` counts
decode slots held, ``kv`` counts the KV reservation (pages for the paged
cache, token positions for dense).  Whichever dimension a tenant uses the
most of *relative to the pool* is its dominant share.

Preemption (``Scheduler(preempt=True)``)
----------------------------------------
Admission alone cannot undo a grab: a tenant that filled every slot while
alone keeps them, which is exactly the starvation DRF exists to prevent.
``decide()`` is therefore two-phase.  Phase 1 assigns queued requests to
free slots as before.  Phase 2 — only when the queue is still non-empty —
reclaims running slots Mesos-style: the policy's next queued choice is
admitted by preempting a victim whenever the swap *strictly* improves
weighted-DRF fairness, i.e. the admitting tenant's weighted share after
the admission stays below the victim tenant's weighted share before it
(strictness makes the loop terminate and forbids same-tenant churn).
Victims are chosen by a pluggable ``VictimPolicy`` registered in
``VICTIM_POLICIES`` (mirroring the admission registry):

* ``youngest-first``             — the most recently admitted eligible
  request, whatever its tenant: minimizes lost decode progress.
* ``lowest-weight-share-first``  — an eligible request of the tenant
  with the highest *weighted* share (lowest weight per unit of share,
  i.e. the most over its SLO entitlement); youngest within that tenant.

Per-tenant weights (``Scheduler(weights=...)``, from
``ServeConfig.tenant_weights``) map SLO tiers onto DRF shares: weight 3
vs 1 converges to a 3:1 slot split under contention.  The scheduler owns
the single ``DRFAllocator`` — admission charges, finishes credit,
preemption credits the slot (and, dense-only, the KV: a paged victim's
detached page chain still occupies the pool, so its KV charge stays).
The engine's executor performs the device half of a ``Preemption``
(checkpoint the slot) before any admission touches that slot.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.drf import DRFAllocator

_EPS = 1e-9


@dataclass(frozen=True)
class ServeResource:
    """DRF demand/allocation vector for serving: decode slots + KV."""

    slots: float = 0.0
    kv: float = 0.0

    def __add__(self, o: "ServeResource") -> "ServeResource":
        return ServeResource(self.slots + o.slots, self.kv + o.kv)

    def __sub__(self, o: "ServeResource") -> "ServeResource":
        return ServeResource(self.slots - o.slots, self.kv - o.kv)

    def nonneg(self) -> bool:
        return self.slots >= -_EPS and self.kv >= -_EPS

    def dominant_share(self, total: "ServeResource") -> float:
        shares = []
        if total.slots:
            shares.append(self.slots / total.slots)
        if total.kv:
            shares.append(self.kv / total.kv)
        return max(shares) if shares else 0.0


# ---------------------------------------------------------------- policies
class AdmissionPolicy:
    """Chooses which queued request the next freed slot admits."""

    name = "base"

    def bind(self, total: ServeResource, allocator=None) -> None:
        """Called once by the scheduler with the pool totals and its
        shared DRF allocator (the single source of tenant accounting)."""

    def select(self, queue) -> int:
        """Index into ``queue`` of the request to admit next."""
        raise NotImplementedError

    def on_admit(self, req, demand: ServeResource) -> None:
        """Admission bookkeeping hook (host-side only)."""

    def on_finish(self, req) -> None:
        """Completion bookkeeping hook (host-side only)."""


class FCFSPolicy(AdmissionPolicy):
    """First come, first served — arrival order, the legacy behavior."""

    name = "fcfs"

    def select(self, queue) -> int:
        return 0


class PriorityPolicy(AdmissionPolicy):
    """Highest ``Request.priority`` first; FIFO within a priority level."""

    name = "priority"

    def select(self, queue) -> int:
        return max(range(len(queue)),
                   key=lambda i: (queue[i].priority, -i))


class SJFPolicy(AdmissionPolicy):
    """Shortest predicted job (prompt + budget) first; FIFO on ties."""

    name = "sjf"

    def select(self, queue) -> int:
        return min(range(len(queue)),
                   key=lambda i: (len(queue[i].prompt)
                                  + queue[i].max_new_tokens, i))


class DRFFairPolicy(AdmissionPolicy):
    """Per-tenant (weighted) DRF: admit from the tenant with the lowest
    weighted dominant share of (slots, KV); FIFO within the chosen
    tenant.  Shares are charged on admission and credited on finish by
    the owning ``Scheduler``, so a tenant's share is exactly what it
    holds *right now* — a flood from one tenant queues behind its own
    share instead of starving everyone else."""

    name = "drf-fair"

    def __init__(self, weights=None):
        # ``weights`` only matters for standalone use; a Scheduler-owned
        # policy is bound to the scheduler's (already weighted) allocator
        self._weights = weights
        self.allocator: Optional[DRFAllocator] = None

    def bind(self, total: ServeResource, allocator=None) -> None:
        self.allocator = allocator if allocator is not None else \
            DRFAllocator(total, zero=ServeResource(), weights=self._weights)

    def shares(self) -> dict:
        return {} if self.allocator is None else self.allocator.shares()

    def select(self, queue) -> int:
        assert self.allocator is not None, "policy not bound to a scheduler"
        tenants = sorted({r.tenant for r in queue})
        for t in tenants:
            self.allocator.register(t)
        t = self.allocator.next_framework(tenants)
        return next(i for i, r in enumerate(queue) if r.tenant == t)


ADMISSION_POLICIES = {
    "fcfs": FCFSPolicy,
    "priority": PriorityPolicy,
    "sjf": SJFPolicy,
    "drf-fair": DRFFairPolicy,
}


def get_admission_policy(name: str, **kw) -> AdmissionPolicy:
    if isinstance(name, AdmissionPolicy):
        return name
    return ADMISSION_POLICIES[name](**kw)


# --------------------------------------------------------- victim policies
@dataclass(frozen=True)
class VictimCandidate:
    """One preemptible slot: who holds it and its tenant's weighted
    share (the fairness headroom the preemption would reclaim)."""

    slot: int
    req: object
    weighted_share: float

    def _age_key(self):
        return getattr(self.req, "_admit_seq", -1)


class VictimPolicy:
    """Chooses which eligible running request a preemption evicts."""

    name = "base"

    def select(self, candidates: list) -> VictimCandidate:
        raise NotImplementedError


class YoungestFirstVictimPolicy(VictimPolicy):
    """Evict the most recently admitted eligible request, whatever its
    tenant: the victim has the least decode progress to lose (its
    checkpoint is cheapest to have wasted)."""

    name = "youngest-first"

    def select(self, candidates):
        return max(candidates, key=lambda c: c._age_key())


class LowestWeightShareFirstVictimPolicy(VictimPolicy):
    """Evict from the tenant with the highest weighted share — the one
    holding the most per unit of SLO weight, i.e. furthest over its
    entitlement; youngest request within that tenant."""

    name = "lowest-weight-share-first"

    def select(self, candidates):
        return max(candidates,
                   key=lambda c: (c.weighted_share, c._age_key()))


VICTIM_POLICIES = {
    "youngest-first": YoungestFirstVictimPolicy,
    "lowest-weight-share-first": LowestWeightShareFirstVictimPolicy,
}


def get_victim_policy(name: str, **kw) -> VictimPolicy:
    if isinstance(name, VictimPolicy):
        return name
    return VICTIM_POLICIES[name](**kw)


# --------------------------------------------------------------- scheduler
@dataclass
class Admission:
    """One decision: slot ``slot`` admits ``req`` (``kv`` carries the page
    reservation for the paged cache — prefill start, CoW copies;
    ``resume=True`` restores a preempted request at its checkpoint
    instead of prefilling)."""

    slot: int
    req: object
    kv: object = None
    resume: bool = False


@dataclass
class Preemption:
    """One decision: checkpoint slot ``slot`` and requeue its request.
    The executor captures the device state (position, last token, dense
    KV stripe); the scheduler has already done the host half (page-chain
    detach, DRF credit, requeue)."""

    slot: int
    req: object


@dataclass
class Plan:
    """A tick's host decisions.  The executor MUST apply ``preemptions``
    (checkpointing device state) before ``admissions`` — an admission may
    reuse a slot vacated in the same plan."""

    admissions: list = field(default_factory=list)
    preemptions: list = field(default_factory=list)

    def __bool__(self) -> bool:
        return bool(self.admissions or self.preemptions)


class Scheduler:
    """Owns the host-side admission state: queue, policy, DRF accounting.

    ``decide()`` is the pure host phase of the engine tick — it assigns
    queued requests to free slots (reserving KV pages for the paged
    cache, which is host bookkeeping), optionally reclaims running slots
    by preemption, and returns the ``Plan`` for the engine's executor to
    apply.  Policies never see device arrays.
    """

    def __init__(self, policy, *, slots: int, max_len: int, kv=None,
                 weights=None, preempt: bool = False,
                 victim="youngest-first"):
        self.policy = get_admission_policy(policy)
        self.slots = slots
        self.max_len = max_len
        self.kv = kv
        self.preempt = preempt
        self.victim = get_victim_policy(victim)
        self.queue: deque = deque()
        self.preempted_total = 0  # telemetry: preemptions ever decided
        self._admit_seq = 0
        kv_total = (kv.pool.capacity if kv is not None
                    else slots * max_len)
        total = ServeResource(slots=slots, kv=kv_total)
        # the single per-tenant account book: admission policies read it,
        # preemption compares weighted shares through it
        self.allocator = DRFAllocator(total, zero=ServeResource(),
                                      weights=weights)
        self.policy.bind(total, self.allocator)
        # metrics: a private registry by default; the owning engine
        # rebinds onto the shared one (ServeEngine.bind_telemetry)
        self.bind_metrics(None, 0)

    def bind_metrics(self, registry, replica: int) -> None:
        """Register this scheduler's series on ``registry`` (a private
        ``MetricsRegistry`` when None).  ``preempted_total`` stays the
        plain attribute — it is gauge-shaped (``_unpreempt_slot``
        decrements it on a rolled-back swap) — exposed function-backed;
        admissions/backpressure are prebound counter children."""
        from repro_torch.runtime.telemetry import MetricsRegistry
        if registry is None:
            registry = MetricsRegistry()
        lbl = {"replica": str(replica)}
        self._m_admissions = registry.counter(
            "serve_admissions_total", "requests admitted into a slot",
            ("replica",)).labels(**lbl)
        self._m_backpressure = registry.counter(
            "serve_backpressure_total",
            "admissions deferred on page-pool exhaustion",
            ("replica",)).labels(**lbl)
        registry.gauge(
            "serve_preempted", "preemptions decided minus rollbacks",
            ("replica",)).labels(**lbl).set_function(
            lambda: self.preempted_total)

    def submit(self, req) -> None:
        self.queue.append(req)

    def demand(self, req) -> ServeResource:
        """The DRF charge an admission of ``req`` carries.  Resuming a
        paged checkpoint re-takes only the slot — its page chain never
        left the pool (and never stopped being charged).

        The KV charge covers in-flight speculative drafts too: the
        engine caps a draft at the request's remaining token budget
        (``ServeEngine._draft_cap``), so the deepest draft write stays
        inside the ``prompt + max_new`` span this reservation already
        accounts for — speculation changes *when* KV is written, never
        how much is reserved."""
        if getattr(req, "_preempted", False) and self.kv is not None:
            # an in-engine resume re-takes only the slot (the chain never
            # left this pool, its charge rode along on ``_drf_charged``);
            # a *handed-off* arrival adopted its chain into THIS pool
            # during the cross-engine transfer, so the charge lands here
            return ServeResource(
                slots=1, kv=float(getattr(req, "_handoff_kv", 0) or 0))
        if self.kv is not None:
            kv = self.kv.blocks_needed(len(req.prompt), req.max_new_tokens)
        else:
            kv = min(len(req.prompt) + req.max_new_tokens, self.max_len)
        return ServeResource(slots=1, kv=kv)

    # ------------------------------------------------------------- decide
    def decide(self, active) -> Plan:
        """Assign queued requests to free slots, then (``preempt=True``)
        reclaim running slots while a swap strictly improves weighted-DRF
        fairness.  An empty plan = nothing to do.

        Paged backpressure: if the policy's chosen request cannot reserve
        its pages the round stops — the choice stays queued (it is next
        in line by policy order) and retries when slots drain.
        """
        plan = Plan()
        view = list(active)  # host model of slot occupancy for this round
        for s in range(self.slots):
            if view[s] is not None or not self.queue:
                continue
            if not self._admit_into(s, plan, view):
                # pool exhausted for the policy's choice.  Before giving
                # up, resume a queued PREEMPTED request if any: a resume
                # allocates zero pages, and its detained page chain only
                # ever returns to the pool by running to completion — a
                # non-FIFO policy could otherwise park it behind an
                # unadmittable fresh request forever (livelock).
                held = next((r for r in self.queue
                             if getattr(r, "_preempted", False)), None)
                if held is None or not self._admit_into(s, plan, view,
                                                        req=held):
                    if (self.kv is not None
                            and getattr(self.kv, "num_hosts", 1) > 1):
                        # sharded pool: slot s's HOST sub-pool is full,
                        # not the whole pool — a later free slot mapping
                        # to another host may still admit the choice
                        continue
                    return plan  # retry after slots drain
        if self.preempt:
            self._decide_preemptions(plan, view)
        return plan

    def _admit_into(self, s: int, plan: Plan, view: list,
                    req=None) -> bool:
        """Admit ``req`` (or the policy's next choice) into free slot
        ``s`` (host bookkeeping: dequeue, KV reservation/attach, DRF
        charge).  False = paged backpressure, nothing consumed.  Phase 2
        pins ``req`` to the request its fairness test justified — a
        fresh ``select`` could pick the just-credited victim instead."""
        if req is None:
            i = self.policy.select(self.queue)
            req = self.queue[i]
        else:
            i = next(j for j, r in enumerate(self.queue) if r is req)
        resume = getattr(req, "_preempted", False)
        res = None
        if self.kv is not None:
            if resume:  # page chain still held: remap it to the new slot
                self.kv.attach_slot(s, req._ckpt_pages)
            else:
                res = self.kv.admit(s, req.prompt, req.max_new_tokens)
                if res is None:
                    self._m_backpressure.inc()
                    return False
        del self.queue[i]
        demand = self.demand(req)
        self.allocator.charge(req.tenant, demand)
        req._drf_charged = (getattr(req, "_drf_charged", None)
                            or ServeResource()) + demand
        req._admit_seq = self._admit_seq
        self._admit_seq += 1
        self.policy.on_admit(req, demand)
        view[s] = req
        self._m_admissions.inc()
        plan.admissions.append(Admission(slot=s, req=req, kv=res,
                                         resume=resume))
        return True

    def _decide_preemptions(self, plan: Plan, view: list) -> None:
        """Phase 2: while the queue holds a request whose admission keeps
        its tenant's weighted share strictly below some running tenant's,
        evict a victim (per the victim policy) and admit into its slot."""
        preempted_slots: set[int] = set()
        for _ in range(self.slots):  # each swap consumes one fresh victim
            if not self.queue:
                return
            i = self.policy.select(self.queue)
            req = self.queue[i]
            if (self.kv is not None
                    and not getattr(req, "_preempted", False)
                    and not self.kv.fits_now(req.prompt,
                                             req.max_new_tokens)):
                return  # evicting a victim frees no pages: backpressure
            ws_after = self.allocator.weighted_share_if(req.tenant,
                                                        self.demand(req))
            cands = [
                VictimCandidate(s, r,
                                self.allocator.weighted_share(r.tenant))
                for s, r in enumerate(view)
                if r is not None and s not in preempted_slots
                and r.tenant != req.tenant
                and self._preemptible(r)
                and self.allocator.weighted_share(r.tenant)
                > ws_after + _EPS]
            if not cands:
                return
            v = self.victim.select(cands)
            self._preempt_slot(v, plan, view)
            preempted_slots.add(v.slot)
            if not self._admit_into(v.slot, plan, view, req=req):
                # the swap's admission failed after all (fits_now is a
                # conservative host estimate): undo the preemption so
                # the victim keeps running — nothing device-side has
                # happened yet, the whole round is host bookkeeping
                self._unpreempt_slot(v, plan, view)
                preempted_slots.discard(v.slot)
                return

    @staticmethod
    def _preemptible(req) -> bool:
        """Only steadily decoding requests checkpoint cleanly: mid-prompt
        token-feed (SSM fallback) and mid-prefill states are skipped."""
        state = getattr(req, "state", None)
        return (getattr(state, "value", None) == "decode"
                and not getattr(req, "_feed", None)
                and bool(req.output))

    def _preempt_slot(self, v: VictimCandidate, plan: Plan,
                      view: list) -> None:
        """Host half of a preemption: detach the page chain (paged),
        credit the DRF account for what the tenant stops holding (the
        slot; plus the KV for dense — its stripe is about to leave the
        device), and requeue at the FRONT so the victim resumes at its
        tenant's next turn instead of behind fresh arrivals."""
        req = v.req
        if self.kv is not None:
            req._ckpt_pages = self.kv.detach_slot(v.slot)
            credit = ServeResource(slots=1, kv=0)
        else:
            credit = req._drf_charged
        self.allocator.credit(req.tenant, credit)
        req._drf_charged = req._drf_charged - credit
        req._drf_restore = credit  # _unpreempt_slot's exact inverse
        req._preempted = True
        self.preempted_total += 1
        view[v.slot] = None
        self.queue.appendleft(req)
        plan.preemptions.append(Preemption(slot=v.slot, req=req))

    def _unpreempt_slot(self, v: VictimCandidate, plan: Plan,
                        view: list) -> None:
        """Exact inverse of ``_preempt_slot`` — rolls a decided-but-not-
        executed preemption back when its paired admission fails."""
        req = v.req
        assert self.queue[0] is req, "victim no longer at queue front"
        self.queue.popleft()
        plan.preemptions.remove(next(p for p in plan.preemptions
                                     if p.req is req))
        if self.kv is not None:
            self.kv.attach_slot(v.slot, req._ckpt_pages)
            req._ckpt_pages = None
        charge = req._drf_restore
        self.allocator.charge(req.tenant, charge)
        req._drf_charged = req._drf_charged + charge
        req._preempted = False
        self.preempted_total -= 1
        view[v.slot] = req

    # ------------------------------------------------------------- finish
    def on_finish(self, req) -> None:
        charged = getattr(req, "_drf_charged", None)
        if charged is not None:
            self.allocator.credit(req.tenant, charged)
            req._drf_charged = None
        self.policy.on_finish(req)

    # ---------------------------------------------------------- telemetry
    def shares(self) -> dict:
        """Raw dominant shares per tenant (see also
        ``allocator.weighted_shares()``)."""
        return self.allocator.shares()
