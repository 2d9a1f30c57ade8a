"""Elastic per-role replica scaling: policy registry + autoscaler core.

The serving analogue of the auto-scaling Docker HPC clusters in
PAPERS.md (Yu & Huang 1509.08231; Vaillancourt et al. 2006.14784): a
policy watches each role's backlog and grows or shrinks that role's
replica set between ``min``/``max`` bounds.  The module is pure host
bookkeeping — no jax — so ``core/simulator.py`` drives the *same*
``Autoscaler`` against a fake cluster at thousands-of-requests scale
that ``runtime/disagg.py`` runs against real engines.

Policies mirror ``core/policies.get_policy``: small objects registered
in ``AUTOSCALE_POLICIES``, resolved by ``get_autoscale_policy(name)``:

* ``queue-depth``  — scale up when a role's backlog exceeds one
  replica's worth of slots; scale down when the backlog is empty and at
  least two replicas' worth of slots sit free (the asymmetric
  thresholds are the hysteresis band).
* ``slo-backlog``  — same shape, but the upward pressure is the
  *weighted* backlog (``tenant_weights`` — gold requests push the
  trigger 3x harder), so the pool grows for a gold burst before a
  free-tier flood of the same depth would.

**Invariant — anti-flap rules** (the autoscaler's, not the policy's;
a policy only votes a direction, it cannot flap the pool):

1. a direction must hold for ``sustain`` consecutive ticks to fire —
   any opposing or neutral vote resets the streak;
2. after any scale event the role is frozen for ``cooldown`` ticks
   (both directions — a scale-up cannot be "corrected" into an
   immediate scale-down);
3. at most one scale event per role per tick, and never past the
   role's ``min``/``max`` replica bounds.

Scale-down is graceful — the
adapter's ``begin_scale_down`` drains the victim through the existing
preemption-checkpoint path (running work migrates, pools empty, THEN
the replica leaves), and the autoscaler keeps the SCALE_DOWN telemetry
span open until the adapter reports the replica DOWN.

Adapter protocol (``DisaggRouter`` and ``core.simulator.ServeChurnSim``
both implement it)::

    scale_roles() -> list[str]            # roles under management
    observe(role) -> RoleObservation      # live/backlog/free_slots ...
    replica_state(rid) -> str             # "up"/"draining"/"down"/...
    scale_up(role) -> Optional[int]       # rejoin a spare; rid or None
    begin_scale_down(role) -> Optional[int]  # start draining; rid/None

Scale events land in the telemetry spine: ``autoscale_*`` gauges
(per-role replica counts, backlog, event counts) plus SCALE_UP /
SCALE_DOWN spans on the router's trace track.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.runtime.telemetry import ROUTER_PID, Telemetry

__all__ = ["Autoscaler", "AutoscalePolicy", "AUTOSCALE_POLICIES",
           "RoleObservation", "ScaleEvent", "get_autoscale_policy"]

# SCALE_* span tids live far above request ids on the router track
_SCALE_TID_BASE = 90_000


@dataclass(frozen=True)
class RoleObservation:
    """One role's load signal for a policy tick."""

    role: str
    live: int               # UP replicas of this role
    backlog: int            # requests awaiting this role's stage
    weighted_backlog: float  # backlog weighted by SLO tier
    free_slots: int         # idle slots across the role's UP replicas
    slots_per_replica: int  # capacity one more replica would add


# ---------------------------------------------------------------- policies
class AutoscalePolicy:
    """Maps one ``RoleObservation`` to a desired direction:
    +1 (grow), -1 (shrink), 0 (hold)."""

    name = "base"

    def desire(self, obs: RoleObservation) -> int:
        raise NotImplementedError

    def _pressure_up(self, obs: RoleObservation) -> bool:
        raise NotImplementedError

    def _band(self, obs: RoleObservation) -> int:
        """Shared hysteresis shape: grow under pressure, shrink only
        when idle by a clear margin, hold in between."""
        if self._pressure_up(obs):
            return 1
        if (obs.backlog == 0
                and obs.free_slots >= 2 * max(obs.slots_per_replica, 1)):
            return -1
        return 0


class QueueDepthPolicy(AutoscalePolicy):
    """Raw backlog vs one replica's slot capacity."""

    name = "queue-depth"

    def _pressure_up(self, obs):
        return obs.backlog > max(obs.slots_per_replica, 1)

    def desire(self, obs):
        return self._band(obs)


class SLOBacklogPolicy(AutoscalePolicy):
    """Weighted backlog: gold-tier demand triggers growth sooner (a
    weight-3 request counts as three toward the threshold), while the
    shrink side stays unweighted — capacity only leaves when the whole
    backlog is empty."""

    name = "slo-backlog"

    def _pressure_up(self, obs):
        return obs.weighted_backlog > max(obs.slots_per_replica, 1)

    def desire(self, obs):
        return self._band(obs)


AUTOSCALE_POLICIES = {
    "queue-depth": QueueDepthPolicy,
    "slo-backlog": SLOBacklogPolicy,
}


def get_autoscale_policy(name) -> AutoscalePolicy:
    if isinstance(name, AutoscalePolicy):
        return name
    return AUTOSCALE_POLICIES[name]()


# -------------------------------------------------------------- autoscaler
@dataclass(frozen=True)
class ScaleEvent:
    """One scaling decision, as recorded in ``Autoscaler.events``."""

    tick: int
    role: str
    action: str  # "up" | "down"
    replica: int
    backlog: int
    live: int


def _bound(spec, role: str, default: int) -> int:
    """Resolve an int-or-per-role-dict bound."""
    if spec is None:
        return default
    if isinstance(spec, dict):
        return int(spec.get(role, default))
    return int(spec)


class Autoscaler:
    """Drives an adapter's per-role replica counts from a policy.

    * ``min_replicas`` / ``max_replicas`` — int or ``{role: int}``
      bounds on each role's UP+DRAINING population (min defaults to 1,
      max to the adapter's current population — no growth unless spares
      exist).
    * ``cooldown`` — ticks a role is frozen after any event.
    * ``sustain`` — consecutive ticks a direction must hold to fire
      (with ``cooldown``, the anti-flap pair).
    """

    def __init__(self, adapter, policy="queue-depth", *,
                 min_replicas=1, max_replicas=None, cooldown: int = 10,
                 sustain: int = 3, telemetry: Optional[Telemetry] = None):
        if cooldown < 0:
            raise ValueError(f"cooldown must be >= 0: {cooldown}")
        if sustain < 1:
            raise ValueError(f"sustain must be >= 1: {sustain}")
        self.adapter = adapter
        self.policy = get_autoscale_policy(policy)
        self._min = min_replicas
        self._max = max_replicas
        self.cooldown = cooldown
        self.sustain = sustain
        self.tm = telemetry if telemetry is not None else Telemetry()
        self.events: list[ScaleEvent] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self._streak: dict[str, int] = {}
        self._last_event: dict[str, int] = {}
        self._retiring: dict[int, str] = {}  # rid -> role, span open
        reg = self.tm.registry
        self._g_replicas = reg.gauge(
            "autoscale_replicas", "UP replicas per role", ("role",))
        self._g_backlog = reg.gauge(
            "autoscale_backlog", "requests awaiting the role's stage",
            ("role",))
        for role in adapter.scale_roles():
            self._g_replicas.labels(role=role).set_function(
                lambda r=role: self.adapter.observe(r).live)
            self._g_backlog.labels(role=role).set_function(
                lambda r=role: self.adapter.observe(r).backlog)
        for name, help, fn in (
                ("autoscale_scale_ups", "scale-up events issued",
                 lambda: self.scale_ups),
                ("autoscale_scale_downs", "scale-down events issued",
                 lambda: self.scale_downs),
                ("autoscale_retiring", "replicas draining toward DOWN",
                 lambda: len(self._retiring))):
            reg.gauge(name, help).labels().set_function(fn)

    def bounds(self, role: str, population: int) -> tuple[int, int]:
        """(min, max) UP+DRAINING replicas for ``role``."""
        lo = _bound(self._min, role, 1)
        hi = _bound(self._max, role, population)
        return lo, max(lo, hi)

    # ------------------------------------------------------------ ticking
    def _retiring_of(self, role: str) -> int:
        return sum(1 for r in self._retiring.values() if r == role)

    def _finish_retirements(self) -> None:
        """Close the SCALE_DOWN span of every retiree that reached DOWN
        — the drain (checkpoint-migrate, pools emptied) completed."""
        tr = self.tm.trace
        for rid in [r for r, _ in list(self._retiring.items())
                    if self.adapter.replica_state(r) == "down"]:
            del self._retiring[rid]
            if tr.enabled:
                tr.end_if_open(ROUTER_PID, _SCALE_TID_BASE + rid,
                               drained=True)

    def tick(self, tick: int) -> None:
        """One autoscaler pass — call once per router/sim tick."""
        self._finish_retirements()
        tr = self.tm.trace
        for role in self.adapter.scale_roles():
            obs = self.adapter.observe(role)
            d = self.policy.desire(obs)
            streak = self._streak.get(role, 0)
            streak = (max(streak, 0) + 1 if d > 0
                      else min(streak, 0) - 1 if d < 0 else 0)
            self._streak[role] = streak
            last = self._last_event.get(role)
            if last is not None and tick - last < self.cooldown:
                continue  # frozen: sustained pressure still accumulates
            population = obs.live + self._retiring_of(role)
            lo, hi = self.bounds(role, population)
            if streak >= self.sustain and obs.live < hi:
                rid = self.adapter.scale_up(role)
                if rid is None:
                    continue  # no spare to rejoin
                self.scale_ups += 1
                self._record(tick, role, "up", rid, obs)
                if tr.enabled:
                    tr.begin(ROUTER_PID, _SCALE_TID_BASE + rid,
                             "SCALE_UP", role=role, tick=tick,
                             backlog=obs.backlog)
                    tr.end(ROUTER_PID, _SCALE_TID_BASE + rid,
                           replicas=obs.live + 1)
            elif (streak <= -self.sustain
                  and obs.live - self._retiring_of(role) > lo):
                rid = self.adapter.begin_scale_down(role)
                if rid is None:
                    continue
                self.scale_downs += 1
                self._record(tick, role, "down", rid, obs)
                self._retiring[rid] = role
                if tr.enabled:
                    # stays open until the drain completes (replica DOWN)
                    tr.begin(ROUTER_PID, _SCALE_TID_BASE + rid,
                             "SCALE_DOWN", role=role, tick=tick,
                             free_slots=obs.free_slots)

    def _record(self, tick: int, role: str, action: str, rid: int,
                obs: RoleObservation) -> None:
        self.events.append(ScaleEvent(tick=tick, role=role, action=action,
                                      replica=rid, backlog=obs.backlog,
                                      live=obs.live))
        self._last_event[role] = tick
        self._streak[role] = 0

    # ----------------------------------------------------------- telemetry
    def stats(self) -> dict:
        v = self.tm.registry.value
        return {
            "policy": self.policy.name,
            "scale_ups": int(v("autoscale_scale_ups")),
            "scale_downs": int(v("autoscale_scale_downs")),
            "retiring": int(v("autoscale_retiring")),
            "events": [dataclasses.asdict(e) for e in self.events],
        }
