"""Disaggregated prefill/decode serving: role-aware routing + KV handoff.

Splits the replica pool by *role* the way Scylla splits a cluster by
framework: **prefill** replicas run chunked prefill only (admission
completes the whole prompt atomically and emits the first token — the
engine never runs a decode phase), **decode** replicas only accept
handed-off requests, and **unified** replicas behave exactly like a plain
pool member.  The ``DisaggRouter`` extends ``ClusterRouter`` with a
handoff pipeline between the two halves:

1. **Extract** — after the replicas step, every prefill replica's
   finished-prefill requests (state DECODE, first token emitted) are
   checkpointed out of their slots via ``ServeEngine.release``: paged
   engines detach the slot's page chain zero-copy (the preemption
   primitive), dense engines snapshot the cache stripe to host.  The
   request moves into the router's **handoff queue**.
2. **Transfer** — each queued handoff targets a decode/unified replica
   chosen by the router's placement policy among those with a free slot
   and (paged) room to **adopt** the chain: ``KVCacheManager.adopt_chain``
   allocates fresh pages in the destination pool, one compiled
   gather/scatter (``copy_cache_pages_across``) moves the K/V bytes
   between the two engines' page pools, and ``release_chain`` drops the
   source pool's hold — both pools stay refcount-balanced
   (tests/test_disagg.py).  Dense checkpoints are engine-independent
   host snapshots, so their transfer is free.
3. **Resume** — the destination engine admits the checkpointed request
   through the ordinary resume path (``attach_slot``; no prefill re-run)
   and decodes from ``pos = prompt_len``.  Sampling keys fold (request
   key, absolute position) — never slot or replica — so the disagg
   output stream is **bitwise-identical** to the unified engine's,
   greedy and seeded-sampled alike.

**Invariant — refcount balance across pools**: at every tick boundary,
each replica's page pool satisfies ``used = sum(refcounts of mapped
pages)`` *independently*, and a chain in transit is owned by exactly
one side — the source pool until ``adopt_chain`` returns, the
destination pool after.  No step of the handoff (extract, transfer,
resume, chaos sweep, retire-drain) may leave a page referenced by both
pools or by neither; ``tests/test_disagg.py`` asserts both pools drain
to zero held pages after every run, chaos included.

**Backpressure**: a handoff with no fitting destination stays queued
(``handoff_backpressure`` counts the deferrals); ``run()`` counts
in-transit handoffs as in-flight work so the loop never exits
mid-transfer.

**Chaos**: a prefill replica lost mid-handoff strands its queued
handoffs — their page chains died with the fenced pool — so the sweep
(``_sweep_lost``) feeds them through the same deterministic-replay
recovery as placed requests: re-prefill ``prompt + emitted`` on a
surviving prefill-capable replica, hand off again, continuation bitwise
intact.  Every fence's flight dump carries the in-transit handoff queue
snapshot (request id, source replica, pages in flight) taken *before*
the sweep, so a red chaos run shows what was mid-flight at the instant
of death.

**Elasticity**: the router implements the adapter protocol
``runtime/autoscale.py``'s ``Autoscaler`` drives — per-role
observations, ``scale_up`` (rejoin a cold spare), ``begin_scale_down``
(retire the idlest replica).  ``retire`` drains via the checkpoint
path: running decodes hand off to a sibling, never-admitted queued
requests return to the router queue, and the replica only reaches DOWN
once no in-transit handoff still points at its page pool
(``_can_retire``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.runtime.cluster import (ClusterRouter, ReplicaHandle,
                                         ReplicaState, _RouterRequest)
from repro_torch.runtime.telemetry import ROUTER_PID, Telemetry

__all__ = ["DisaggRouter", "Handoff", "ROLES", "transfer_chain"]

ROLES = ("prefill", "decode", "unified")

# roles fresh router-queued requests may place on / handoffs may target
_PREFILL_CAPABLE = ("prefill", "unified")
_DECODE_CAPABLE = ("decode", "unified")


@dataclass
class Handoff:
    """One finished prefill awaiting a decode slot.  The request holds
    its own checkpoint (``req._ckpt``); ``src`` names the replica whose
    page pool still backs a paged chain until the transfer completes."""

    rr: _RouterRequest
    src: int
    n_pages: int  # 0 for dense (host-snapshot) checkpoints
    tick: int
    retries: int = 0  # placement attempts deferred by backpressure


def _releasable(req) -> bool:
    """May this request's slot be checkpointed out cleanly?  Same
    predicate as ``Scheduler._preemptible``: steadily decoding, not
    mid-token-feed, first token emitted (chunked prefill done)."""
    state = getattr(req, "state", None)
    return (getattr(state, "value", None) == "decode"
            and not getattr(req, "_feed", None)
            and bool(req.output))


def transfer_chain(src_engine, dst_engine, req) -> bool:
    """Move ``req``'s checkpointed KV from ``src_engine`` to
    ``dst_engine``; True on success, False on destination backpressure.

    Dense checkpoints (``ckpt.pages is None``) are host snapshots —
    engine-independent, nothing to do.  Paged: adopt fresh pages in the
    destination pool, gather the chain's pages from every layer's source
    pool and write them into the destination's in place
    (``copy_cache_pages_across`` on int64 index tensors on the pools'
    device, one chain length at a time: nothing is compiled, so nothing
    is padded), then release the source pool's hold."""
    ck = req._ckpt
    if ck.pages is None:
        return True
    n = len(ck.pages)
    dst_kv = dst_engine.kv
    new_pages = dst_kv.adopt_chain(n)
    if new_pages is None:
        return False
    model = dst_engine.model
    src_idx = torch.as_tensor(ck.pages, dtype=torch.int64,
                              device=model.device)
    dst_idx = torch.as_tensor(new_pages, dtype=torch.int64,
                              device=model.device)
    dst_engine.caches = model.copy_cache_pages_across(
        src_engine.caches, dst_engine.caches, src_idx, dst_idx)
    src_engine.kv.release_chain(ck.pages)
    ck.pages = new_pages
    req._ckpt_pages = new_pages
    req._handoff_kv = n  # the resume's DRF charge lands in the dst pool
    return True


class DisaggRouter(ClusterRouter):
    """``ClusterRouter`` with per-replica roles and a handoff queue.

    ``roles[rid]`` assigns each replica ``prefill`` / ``decode`` /
    ``unified``; ``make_engine(rid)`` must build the engine with the
    matching ``ServeConfig.role``.  ``start_down`` rids begin as cold
    spares for an ``Autoscaler`` (attach one via ``autoscaler=``, or
    set ``router.autoscaler`` later) to rejoin under load.
    """

    def __init__(self, make_engine: Callable[[int], object],
                 n_replicas: int, *, roles, start_down=(), **kw):
        roles = list(roles)
        if len(roles) != n_replicas:
            raise ValueError(f"roles has {len(roles)} entries for "
                             f"{n_replicas} replicas")
        bad = sorted(set(roles) - set(ROLES))
        if bad:
            raise ValueError(f"unknown roles {bad} (expected {ROLES})")
        up = [r for i, r in enumerate(roles) if i not in set(start_down)]
        if not any(r in _PREFILL_CAPABLE for r in up):
            raise ValueError("no initially-up prefill-capable replica "
                             "(role prefill or unified)")
        if not any(r in _DECODE_CAPABLE for r in up):
            raise ValueError("no initially-up decode-capable replica "
                             "(role decode or unified)")
        self.roles = roles
        self.handoffs: list[Handoff] = []
        self.handoffs_done = 0
        self.handoff_backpressure = 0
        self.autoscaler = None
        super().__init__(make_engine, n_replicas, start_down=start_down,
                         **kw)
        reg = self.tm.registry
        for name, help, fn in (
                ("disagg_handoffs_done", "prefill->decode handoffs "
                 "completed", lambda: self.handoffs_done),
                ("disagg_handoffs_in_transit", "handoffs awaiting a "
                 "decode slot", lambda: len(self.handoffs)),
                ("disagg_handoff_backpressure", "handoff placements "
                 "deferred (no slot / no pages)",
                 lambda: self.handoff_backpressure)):
            reg.gauge(name, help).labels().set_function(fn)

    # ------------------------------------------------------------ roles
    def role_of(self, rid: int) -> str:
        return self.roles[rid]

    def _accepts_new(self, rh: ReplicaHandle) -> bool:
        return self.roles[rh.rid] in _PREFILL_CAPABLE

    # ---------------------------------------------------------- handoff
    def _extract_handoffs(self) -> None:
        """Checkpoint every finished prefill off its prefill replica and
        queue it for transfer (DRAINING prefill replicas drain faster
        this way too — their slots empty the same tick)."""
        tr = self.tm.trace
        for rh in self.replicas:
            if self.roles[rh.rid] != "prefill":
                continue
            if rh.state not in (ReplicaState.UP, ReplicaState.DRAINING):
                continue
            if rh.killed or rh.engine is None:
                continue
            for rr in [r for r in self.placed[rh.rid]
                       if _releasable(r.req)]:
                ck = rh.engine.release(rr.req)
                self.placed[rh.rid].remove(rr)
                rr.replica = None
                n = 0 if ck.pages is None else len(ck.pages)
                self.handoffs.append(Handoff(rr=rr, src=rh.rid, n_pages=n,
                                             tick=self.tick_count))
                if tr.enabled:
                    tr.begin(ROUTER_PID, rr.req.req_id, "HANDOFF",
                             src=rh.rid, pages=n, pos=ck.pos)

    def _handoff_target(self, h: Handoff) -> Optional[ReplicaHandle]:
        """Pick a decode-capable replica that can adopt the chain right
        now, via the router's placement policy over their offers."""
        fitting = []
        for rh in self.replicas:
            if self.roles[rh.rid] not in _DECODE_CAPABLE:
                continue
            if (rh.state is not ReplicaState.UP or rh.killed
                    or rh.slow or rh.engine is None):
                continue
            eng = rh.engine
            if eng.free_slots() < 1:
                continue
            if h.n_pages and not eng.kv.can_adopt(h.n_pages):
                continue
            fitting.append(rh.offer())
        if not fitting:
            return None
        return self.replicas[self.policy.select(fitting).replica]

    def _drain_handoffs(self) -> None:
        """FIFO-place queued handoffs onto decode slots; a handoff with
        no fitting destination stays queued (backpressure, counted)."""
        tr = self.tm.trace
        for h in list(self.handoffs):
            rh = self._handoff_target(h)
            if rh is None or not transfer_chain(
                    self._src_engine(h), rh.engine, h.rr.req):
                h.retries += 1
                self.handoff_backpressure += 1
                continue
            self.handoffs.remove(h)
            rh.engine.submit(h.rr.req)
            rh.placements += 1
            h.rr.replica = rh.rid
            h.rr.history.append(rh.rid)
            self.placed[rh.rid].append(h.rr)
            self.handoffs_done += 1
            if tr.enabled:
                tr.end_if_open(ROUTER_PID, h.rr.req.req_id,
                               placed_on=rh.rid)
                tr.instant(ROUTER_PID, "handoff", tid=h.rr.req.req_id,
                           src=h.src, dst=rh.rid, pages=h.n_pages,
                           wait=self.tick_count - h.tick)

    def _src_engine(self, h: Handoff):
        """The engine whose pool still holds a paged handoff's chain.
        The sweep removes handoffs whose source died, so a queued
        handoff's source engine is always alive."""
        eng = self.replicas[h.src].engine
        assert eng is not None, f"handoff source {h.src} fenced un-swept"
        return eng

    # ------------------------------------------------------------- chaos
    def _sweep_lost(self, rh: ReplicaHandle) -> list:
        """Handoffs whose source pool just died are unrecoverable as
        checkpoints (paged chains lived in the fenced engine; dense
        snapshots replay too — one uniform recovery path): close their
        HANDOFF spans and hand the requests to deterministic replay."""
        stranded = [h for h in self.handoffs if h.src == rh.rid]
        tr = self.tm.trace
        for h in stranded:
            self.handoffs.remove(h)
            if tr.enabled:
                tr.end_if_open(ROUTER_PID, h.rr.req.req_id,
                               lost_src=rh.rid)
        return [h.rr for h in stranded]

    def _flight_extra(self) -> dict:
        return {"handoffs_in_transit": [
            {"req_id": h.rr.req.req_id, "src_replica": h.src,
             "dst_replica": None, "target_role": "decode",
             "pages_in_flight": h.n_pages, "queued_tick": h.tick}
            for h in self.handoffs]}

    # ------------------------------------------------------ retire/drain
    def _can_retire(self, rh: ReplicaHandle) -> bool:
        return not any(h.src == rh.rid for h in self.handoffs)

    def retire(self, rid: int) -> None:
        """Drain ``rid`` for scale-down, actively migrating its work:
        running decodes checkpoint out and re-enter the handoff queue
        (their chains transfer to a sibling pool before the replica can
        reach DOWN — ``_can_retire``), checkpointed requests parked in
        its admission queue do the same, and never-admitted queued
        requests return to the router queue.  Mid-prefill/token-feed
        occupants drain naturally."""
        rh = self.replicas[rid]
        if rh.state is not ReplicaState.UP or rh.engine is None:
            return
        rh.state = ReplicaState.DRAINING
        eng = rh.engine
        tr = self.tm.trace
        for rr in list(self.placed[rid]):
            req = rr.req
            if _releasable(req):
                ck = eng.release(req)
                n = 0 if ck.pages is None else len(ck.pages)
            elif req in eng.scheduler.queue:
                eng.scheduler.queue.remove(req)
                self.tm.req_end(rid, req.req_id, reason="migrate")
                if getattr(req, "_preempted", False):
                    # checkpoint intact, pages (if paged) in THIS pool;
                    # the request leaves this engine for good — credit
                    # whatever DRF charge still rides on it
                    eng.scheduler.on_finish(req)
                    ck = req._ckpt
                    n = 0 if ck.pages is None else len(ck.pages)
                else:
                    # never admitted: nothing held here — requeue fresh
                    self.placed[rid].remove(rr)
                    rr.replica = None
                    self.queue.insert(0, rr)
                    continue
            else:
                continue  # mid-prefill / token-feed: drains naturally
            self.placed[rid].remove(rr)
            rr.replica = None
            self.handoffs.append(Handoff(rr=rr, src=rid, n_pages=n,
                                         tick=self.tick_count))
            if tr.enabled:
                tr.begin(ROUTER_PID, req.req_id, "HANDOFF", src=rid,
                         pages=n, migrate=True)

    # -------------------------------------------- autoscaler adapter
    def scale_roles(self) -> list[str]:
        seen = []
        for r in self.roles:
            if r not in seen:
                seen.append(r)
        return seen

    def replica_state(self, rid: int) -> str:
        return self.replicas[rid].state.value

    def observe(self, role: str):
        from repro_torch.runtime.autoscale import RoleObservation
        live = [rh for rh in self.replicas
                if self.roles[rh.rid] == role
                and rh.state is ReplicaState.UP and not rh.killed
                and rh.engine is not None]
        if role in _PREFILL_CAPABLE:
            backlog = [rr.req for rr in self.queue]
        else:
            backlog = []
        if role in _DECODE_CAPABLE:
            backlog = backlog + [h.rr.req for h in self.handoffs]
        slots = live[0].engine.slots if live else 0
        return RoleObservation(
            role=role, live=len(live), backlog=len(backlog),
            weighted_backlog=sum(self._weight(r.tenant) for r in backlog),
            free_slots=sum(rh.engine.free_slots() for rh in live),
            slots_per_replica=slots)

    def scale_up(self, role: str) -> Optional[int]:
        for rh in self.replicas:
            if (self.roles[rh.rid] == role
                    and rh.state in (ReplicaState.DOWN, ReplicaState.LOST)):
                self.rejoin(rh.rid)
                return rh.rid
        return None

    def begin_scale_down(self, role: str) -> Optional[int]:
        up = [rh for rh in self.replicas
              if self.roles[rh.rid] == role
              and rh.state is ReplicaState.UP and not rh.killed
              and rh.engine is not None]
        if not up:
            return None
        # idlest first: fewest in-flight requests, then highest rid so
        # the original low-rid replicas are the last to go
        rh = min(up, key=lambda rh: (len(self.placed[rh.rid]), -rh.rid))
        self.retire(rh.rid)
        return rh.rid

    # ------------------------------------------------------------ ticking
    def _pending_counts(self) -> tuple[int, int]:
        queued, live = super()._pending_counts()
        return queued, live + len(self.handoffs)

    def step(self) -> int:
        emitted = super().step()
        self._extract_handoffs()
        if self.autoscaler is not None:
            self.autoscaler.tick(self.tick_count)
        self._drain_handoffs()
        return emitted

    # ---------------------------------------------------------- telemetry
    def stats(self) -> dict:
        out = super().stats()
        v = self.tm.registry.value
        out["roles"] = {rh.rid: self.roles[rh.rid]
                        for rh in self.replicas}
        out["handoffs_done"] = int(v("disagg_handoffs_done"))
        out["handoffs_in_transit"] = int(v("disagg_handoffs_in_transit"))
        out["handoff_backpressure"] = int(
            v("disagg_handoff_backpressure"))
        return out
