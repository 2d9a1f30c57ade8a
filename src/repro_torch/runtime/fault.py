"""Fault tolerance around the training AND serving loops.

Training half (the original seed flow, mirrored by core/scheduler.py's
simulation):

1. A host dies -> the gang's collectives fail -> the job process exits.
2. Scylla re-places the job on the surviving hosts (possibly fewer chips /
   a different submesh shape) and relaunches the job's main process.
3. The job restores the last checkpoint *against the new mesh's
   shardings* (checkpoints are sharding-agnostic — see checkpoint/) and
   continues from the last checkpointed step.

``run_with_failures`` reproduces that flow in-process for tests/examples:
``FailureInjector`` raises ``SimulatedHostFailure`` at chosen steps; each
restart may present a different mesh (elastic).  Straggler mitigation at
the runtime level = per-step wall-time watchdog feeding the scheduler
(``StepWatchdog``); the placement change itself is the scheduler's call.

Serving half: ``ReplicaFaultInjector`` drives chaos into a
``runtime.cluster.ClusterRouter`` — replica kill/rejoin, straggler
stalls (feeding the router's per-replica ``StepWatchdog``), heartbeat
drops, and page-pool pressure — from a *schedule* of ``FaultEvent``s, so
every chaos run is reproducible: either an explicit schedule (the
``parse`` format the launcher's ``--fault-schedule`` takes) or one
generated deterministically from a seed (``seeded``).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.runtime.train import TrainConfig, Trainer


class SimulatedHostFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    fired: set = field(default_factory=set)

    def __call__(self, step: int, metrics):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedHostFailure(f"injected host failure at step {step}")


@dataclass
class StepWatchdog:
    """Flags straggling steps (gang runs at the slowest host's pace)."""

    threshold: float = 3.0
    window: int = 20
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)
    _last: float = 0.0

    def start(self):
        self._last = time.monotonic()

    def __call__(self, step: int, metrics):
        now = time.monotonic()
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        hist = self.times[-self.window:-1]
        if len(hist) >= 5:
            med = sorted(hist)[len(hist) // 2]
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))


# ------------------------------------------------------------------ serving
#: ``FaultEvent.action`` values understood by ``ClusterRouter``:
#:   kill      — the replica's process dies: heartbeats stop, steps stop;
#:               the router detects it after ``miss_threshold`` beats
#:   rejoin    — a LOST/DOWN replica comes back with a fresh engine
#:   stall     — straggle: every step sleeps ``arg`` seconds for ``ticks``
#:               ticks (feeds the router's per-replica StepWatchdog)
#:   hbdrop    — drop ``ticks`` consecutive heartbeats while the engine
#:               keeps serving (partition: below the miss threshold the
#:               router must tolerate it; at/above, it fences the replica)
#:   pressure  — hold ``arg`` (fraction, 0-1] of the replica's free KV
#:               pages for ``ticks`` ticks (paged engines only)
#:   drain     — operator drain: no new placements; in-flight finishes
FAULT_ACTIONS = ("kill", "rejoin", "stall", "hbdrop", "pressure", "drain")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled chaos action against replica ``replica`` at router
    tick ``tick``.  ``arg``/``ticks`` meaning depends on ``action`` (see
    ``FAULT_ACTIONS``)."""

    tick: int
    action: str
    replica: int
    arg: float = 0.0
    ticks: int = 1

    def __post_init__(self):
        if self.action not in FAULT_ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"known: {FAULT_ACTIONS}")
        if self.tick < 0 or self.ticks < 1:
            raise ValueError(f"bad fault timing: tick={self.tick} "
                             f"ticks={self.ticks}")


class ReplicaFaultInjector:
    """Replays a fixed ``FaultEvent`` schedule into the router's ticks.

    The schedule is data, never randomness at fire time — the same
    injector instance (or two built from the same seed/spec) drives the
    identical chaos run, which is what lets the benchmarks compare a
    chaos run bitwise against its fault-free twin.
    """

    def __init__(self, events=()):
        self.events = sorted(events, key=lambda e: e.tick)
        self._next = 0

    def pop(self, tick: int) -> list[FaultEvent]:
        """Events due at (or before — catch-up) ``tick``, each once."""
        due = []
        while (self._next < len(self.events)
               and self.events[self._next].tick <= tick):
            due.append(self.events[self._next])
            self._next += 1
        return due

    def reset(self) -> None:
        self._next = 0

    @classmethod
    def parse(cls, spec: str) -> "ReplicaFaultInjector":
        """Build from the launcher's ``--fault-schedule`` string.

        Comma-separated ``TICK:ACTION:REPLICA[:ARG[:TICKS]]`` entries,
        e.g. ``"8:kill:1,40:rejoin:1"`` or ``"5:stall:0:0.02:10"``; or
        ``"seed=SEED[:REPLICAS[:HORIZON]]"`` for a seeded random
        schedule (see ``seeded``)."""
        spec = spec.strip()
        if spec.startswith("seed="):
            parts = spec[len("seed="):].split(":")
            seed = int(parts[0])
            n_replicas = int(parts[1]) if len(parts) > 1 else 3
            horizon = int(parts[2]) if len(parts) > 2 else 60
            return cls.seeded(seed, n_replicas=n_replicas, horizon=horizon)
        events = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) < 3:
                raise ValueError(
                    f"fault entry {part!r}: expected "
                    f"TICK:ACTION:REPLICA[:ARG[:TICKS]]")
            events.append(FaultEvent(
                tick=int(fields[0]), action=fields[1],
                replica=int(fields[2]),
                arg=float(fields[3]) if len(fields) > 3 else 0.0,
                ticks=int(fields[4]) if len(fields) > 4 else 1))
        return cls(events)

    @classmethod
    def seeded(cls, seed: int, *, n_replicas: int, horizon: int = 60,
               n_faults: int = 2, rejoin_after: int = 12,
               kinds=("kill", "stall", "hbdrop")) -> "ReplicaFaultInjector":
        """Deterministic schedule from a seed: ``n_faults`` events drawn
        over ``[1, horizon)``, each kill paired with a rejoin
        ``rejoin_after`` ticks later.  Replica 0 is never killed so at
        least one replica always survives to absorb recoveries."""
        import numpy as np

        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            t = int(rng.integers(1, max(horizon, 2)))
            if kind == "kill":
                rid = int(rng.integers(1, n_replicas)) if n_replicas > 1 \
                    else 0
                events.append(FaultEvent(t, "kill", rid))
                events.append(FaultEvent(t + rejoin_after, "rejoin", rid))
            elif kind == "stall":
                rid = int(rng.integers(0, n_replicas))
                events.append(FaultEvent(t, "stall", rid,
                                         arg=0.02, ticks=8))
            elif kind == "hbdrop":
                rid = int(rng.integers(0, n_replicas))
                events.append(FaultEvent(t, "hbdrop", rid, ticks=2))
            elif kind == "pressure":
                rid = int(rng.integers(0, n_replicas))
                events.append(FaultEvent(t, "pressure", rid,
                                         arg=0.5, ticks=6))
        return cls(events)


def run_with_failures(make_trainer: Callable[[int], Trainer], *,
                      injector: FailureInjector,
                      max_restarts: int = 5) -> dict:
    """Run to completion across simulated failures.

    ``make_trainer(attempt)`` builds a fresh Trainer per attempt — the
    elastic path passes a different mesh/shardings per attempt.  State comes
    back from the checkpoint directory each time.
    """
    attempt = 0
    while True:
        trainer = make_trainer(attempt)
        try:
            out = trainer.run(on_step=injector)
            out["restarts"] = attempt
            return out
        except SimulatedHostFailure:
            attempt += 1
            if attempt > max_restarts:
                raise
