"""The port's autoscaler, on the CPU: the copied ``runtime/autoscale.py``
and ``core/simulator.py``'s ``ServeChurnSim``.  Twins of
``tests/test_autoscale.py`` (policy units, the sustain streak, the
cooldown, bounds, drain-before-retire, the churn simulator), the churn
simulator's trajectories equal to the reference's, and the autoscaler on
the port's ``DisaggRouter``: cold spares rejoin under backlog, an idle
decode replica retires after a burst, streams stay bitwise the unified
engine's and equal to the JAX router's, and every pool ends balanced."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import tiny_lm  # noqa: E402
from repro_torch.core.simulator import ServeChurnSim  # noqa: E402
from repro_torch.runtime.autoscale import (AUTOSCALE_POLICIES,  # noqa: E402
                                           Autoscaler, RoleObservation,
                                           get_autoscale_policy)
from repro_torch.runtime.disagg import DisaggRouter  # noqa: E402
from repro_torch.runtime.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.runtime.telemetry import (Telemetry,  # noqa: E402
                                           validate_chrome_trace)
from test_torch_cluster import (PAGED, assert_pools_balanced,  # noqa: E402
                                fresh, jax_reqs, make_reqs, port_lm,
                                steady_watchdogs, streams)


def _obs(role="decode", live=1, backlog=0, weighted=None, free=0, slots=2):
    return RoleObservation(role=role, live=live, backlog=backlog,
                           weighted_backlog=(float(backlog) if weighted is None
                                             else weighted),
                           free_slots=free, slots_per_replica=slots)


# --------------------------------------------------------------- policies
def test_policy_registry():
    assert set(AUTOSCALE_POLICIES) == {"queue-depth", "slo-backlog"}
    with pytest.raises(KeyError):
        get_autoscale_policy("bogus")
    pol = get_autoscale_policy("queue-depth")
    assert get_autoscale_policy(pol) is pol


def test_queue_depth_hysteresis_band():
    pol = get_autoscale_policy("queue-depth")
    assert pol.desire(_obs(backlog=3, slots=2)) == 1
    assert pol.desire(_obs(backlog=2, slots=2)) == 0
    assert pol.desire(_obs(backlog=0, free=4, slots=2)) == -1
    assert pol.desire(_obs(backlog=0, free=3, slots=2)) == 0
    assert pol.desire(_obs(backlog=1, free=0, slots=2)) == 0
    assert pol.desire(_obs(backlog=1, free=8, slots=2)) == 0


def test_slo_backlog_weights_gold_pressure():
    pol = get_autoscale_policy("slo-backlog")
    assert pol.desire(_obs(backlog=1, weighted=3.0, slots=2)) == 1
    assert pol.desire(_obs(backlog=1, weighted=1.0, slots=2)) == 0
    assert pol.desire(_obs(backlog=1, weighted=0.5, free=8, slots=2)) == 0
    assert pol.desire(_obs(backlog=0, weighted=0.0, free=4, slots=2)) == -1


# ------------------------------------------------------------ fake adapter
class FakeCluster:
    """One role, integer replica populations, a drain latch the test
    controls."""

    def __init__(self, role="decode", live=1, spares=2, slots=2):
        self.role = role
        self.backlog = 0
        self.weighted = None
        self.free_slots = 0
        self.slots = slots
        self.up = list(range(live))
        self.spare = [live + i for i in range(spares)]
        self.draining = []

    def scale_roles(self):
        return [self.role]

    def replica_state(self, rid):
        if rid in self.up:
            return "up"
        return "draining" if rid in self.draining else "down"

    def observe(self, role):
        return _obs(role, live=len(self.up), backlog=self.backlog,
                    weighted=self.weighted, free=self.free_slots,
                    slots=self.slots)

    def scale_up(self, role):
        if not self.spare:
            return None
        rid = self.spare.pop(0)
        self.up.append(rid)
        return rid

    def begin_scale_down(self, role):
        rid = self.up.pop()
        self.draining.append(rid)
        return rid

    def finish_drain(self):
        while self.draining:
            self.spare.append(self.draining.pop())


def test_ctor_validation():
    with pytest.raises(ValueError, match="cooldown"):
        Autoscaler(FakeCluster(), cooldown=-1)
    with pytest.raises(ValueError, match="sustain"):
        Autoscaler(FakeCluster(), sustain=0)


def test_bounds_int_and_dict():
    sc = Autoscaler(FakeCluster(), min_replicas={"decode": 2},
                    max_replicas=3)
    assert sc.bounds("decode", population=1) == (2, 3)
    assert sc.bounds("prefill", population=1) == (1, 3)
    assert Autoscaler(FakeCluster()).bounds("decode", population=4) == (1, 4)


def test_scale_up_needs_sustained_backlog():
    fc = FakeCluster()
    sc = Autoscaler(fc, sustain=3, cooldown=5, max_replicas=3)
    fc.backlog = 10
    sc.tick(0)
    sc.tick(1)
    assert sc.scale_ups == 0
    sc.tick(2)
    assert sc.scale_ups == 1 and len(fc.up) == 2
    assert [e.action for e in sc.events] == ["up"]
    assert sc.events[0].tick == 2 and sc.events[0].role == "decode"


def test_blip_resets_the_streak():
    fc = FakeCluster()
    sc = Autoscaler(fc, sustain=3, max_replicas=3)
    fc.backlog = 10
    sc.tick(0)
    sc.tick(1)
    fc.backlog = 0
    sc.tick(2)
    fc.backlog = 10
    sc.tick(3)
    sc.tick(4)
    assert sc.scale_ups == 0
    sc.tick(5)
    assert sc.scale_ups == 1


def test_no_flap_inside_cooldown():
    fc = FakeCluster(spares=3)
    sc = Autoscaler(fc, sustain=2, cooldown=6, max_replicas=4)
    fc.backlog = 50
    for t in range(7):
        sc.tick(t)
    assert sc.scale_ups == 1 and sc.events[0].tick == 1
    sc.tick(7)
    assert sc.scale_ups == 2
    assert [e.tick for e in sc.events] == [1, 7]


def test_scale_up_respects_max_and_spares():
    fc = FakeCluster(live=2, spares=2)
    sc = Autoscaler(fc, sustain=1, cooldown=0, max_replicas=2)
    fc.backlog = 50
    for t in range(5):
        sc.tick(t)
    assert sc.scale_ups == 0 and len(fc.up) == 2
    fc = FakeCluster(live=1, spares=0)
    sc = Autoscaler(fc, sustain=1, cooldown=0, max_replicas=4)
    fc.backlog = 50
    sc.tick(0)
    assert sc.scale_ups == 0 and sc.events == []


def test_scale_down_drains_before_retiring():
    tm = Telemetry(trace=True)
    fc = FakeCluster(live=3, spares=0)
    sc = Autoscaler(fc, sustain=2, cooldown=0, min_replicas=2, telemetry=tm)
    fc.free_slots = 12
    sc.tick(0)
    sc.tick(1)
    assert sc.scale_downs == 1
    assert fc.draining and sc.stats()["retiring"] == 1
    assert validate_chrome_trace(tm.trace.to_chrome())["unbalanced"]
    sc.tick(2)
    assert sc.stats()["retiring"] == 1
    fc.finish_drain()
    sc.tick(3)
    assert sc.stats()["retiring"] == 0
    assert validate_chrome_trace(tm.trace.to_chrome())["unbalanced"] == {}


def test_scale_down_respects_min_floor_and_retiring():
    fc = FakeCluster(live=1, spares=0)
    sc = Autoscaler(fc, sustain=1, cooldown=0, min_replicas=1)
    fc.free_slots = 20
    for t in range(5):
        sc.tick(t)
    assert sc.scale_downs == 0 and len(fc.up) == 1
    fc = FakeCluster(live=2, spares=0)
    sc = Autoscaler(fc, sustain=1, cooldown=0, min_replicas=1)
    fc.free_slots = 20
    sc.tick(0)
    assert sc.scale_downs == 1
    sc.tick(1)
    assert sc.scale_downs == 1


def test_stats_and_events_roundtrip():
    fc = FakeCluster()
    sc = Autoscaler(fc, sustain=1, cooldown=0, max_replicas=2)
    fc.backlog = 9
    sc.tick(4)
    st = sc.stats()
    assert st["policy"] == "queue-depth"
    assert st["scale_ups"] == 1 and st["scale_downs"] == 0
    assert st["events"] == [{"tick": 4, "role": "decode", "action": "up",
                             "replica": 1, "backlog": 9, "live": 1}]


# --------------------------------------------------------- churn simulator
def test_churn_sim_scales_and_loses_nothing():
    res = ServeChurnSim(seed=1, max_replicas=4, cooldown=8, sustain=2).run()
    assert res["lost"] == 0 and res["pending"] == 0
    assert res["completed"] == res["arrived"] > 100
    assert res["bounds_respected"]
    assert res["scale_ups"] >= 1 and res["scale_downs"] >= 1
    assert (res["peak_replicas"]["prefill"] >= 2
            or res["peak_replicas"]["decode"] >= 2)


@pytest.mark.parametrize("kw", [
    dict(seed=1, max_replicas=4, cooldown=8, sustain=2),
    dict(seed=7, policy="slo-backlog"),
    dict(seed=3, trace=[5] * 60 + [0] * 40 + [4] * 60, max_replicas=6,
         cooldown=6, sustain=2),
    dict(seed=11, slots=2, init_replicas=2, min_replicas=2, max_replicas=3),
], ids=["queue-depth", "slo-backlog", "burst-idle-burst", "floor-2"])
def test_churn_sim_matches_reference(kw):
    """The copied simulator and autoscaler follow the reference's
    trajectory exactly: the same results and scale events."""
    from repro.core.simulator import ServeChurnSim as JServeChurnSim

    ours, ref = ServeChurnSim(**kw), JServeChurnSim(**kw)
    assert ours.run() == ref.run()
    assert ours.replica_trace == ref.replica_trace


# ------------------------------------------------------------- real router
def _roles_router(make_engine, roles, **kw):
    tm = Telemetry(trace=True)
    router = DisaggRouter(make_engine, len(roles), roles=roles,
                          start_down=(1, 3), telemetry=tm)
    router.autoscaler = Autoscaler(router, "queue-depth", cooldown=2,
                                   sustain=2, max_replicas=2, telemetry=tm,
                                   **kw)
    return router, tm


ROLES4 = ["prefill", "prefill", "decode", "decode"]


def test_autoscaler_on_real_disagg_router():
    """Cold DOWN spares rejoin under backlog, streams stay bitwise the
    unified engine's, pools drain balanced, SCALE spans balance."""
    model, params = port_lm()
    base = ServeConfig(batch_slots=2, max_len=64, **PAGED)

    def make(rid):
        return ServeEngine(model, params,
                           dataclasses.replace(base, role=ROLES4[rid]))

    reqs = make_reqs(10, max_new=8, seed=5)
    ref_eng = ServeEngine(model, params, base)
    for r in fresh(reqs):
        ref_eng.submit(r)
    ref = streams(ref_eng.run())
    router, tm = _roles_router(make, ROLES4)
    for r in reqs:
        router.submit(r)
    done = router.run(max_ticks=800)
    assert router.autoscaler.scale_ups >= 1
    assert streams(done) == ref
    assert router.stats()["failed"] == 0
    assert_pools_balanced(router)
    names = {e.get("name") for e in tm.trace.to_chrome()["traceEvents"]}
    assert "SCALE_UP" in names
    assert validate_chrome_trace(tm.trace.to_chrome())["unbalanced"] == {}


def test_autoscaler_burst_idle_burst_scales_both_ways(monkeypatch):
    """A burst, an idle stretch and a second burst on the real router:
    decode scales up and then down (the idle replica retires and reaches
    DOWN), and every stream stays bitwise the unified engine's.  The JAX
    router under the same arrivals takes the same scale events and gives
    the same greedy streams."""
    from repro.runtime.autoscale import Autoscaler as JAutoscaler
    from repro.runtime.disagg import DisaggRouter as JDisaggRouter
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine

    steady_watchdogs(monkeypatch)
    model, params = port_lm()
    base = ServeConfig(batch_slots=2, max_len=64, **PAGED)
    jm, jp = tiny_lm()
    jbase = JServeConfig(batch_slots=2, max_len=64, **PAGED)
    # arrivals per tick: a burst of 8, 40 idle ticks, a burst of 4
    arrivals = {0: 4, 1: 4, 42: 2, 43: 2}
    reqs = make_reqs(12, max_new=12, seed=6, sampled=False)
    jreqs = jax_reqs(12, max_new=12, seed=6, sampled=False)

    def drive(router, reqs):
        queue, t = fresh(reqs), 0
        while queue or router._pending_counts() != (0, 0) or t < 44:
            for _ in range(arrivals.get(t, 0)):
                router.submit(queue.pop(0))
            router.step()
            t += 1
            assert t < 800
        return streams(router.run(max_ticks=10))

    results = []
    for jax_side in (False, True):
        if jax_side:
            make = lambda rid: JServeEngine(  # noqa: E731
                jm, jp, dataclasses.replace(jbase, role=ROLES4[rid]))
            router = JDisaggRouter(make, 4, roles=ROLES4, start_down=(1, 3))
            router.autoscaler = JAutoscaler(router, "queue-depth",
                                            cooldown=2, sustain=2,
                                            max_replicas=2)
        else:
            make = lambda rid: ServeEngine(  # noqa: E731
                model, params, dataclasses.replace(base, role=ROLES4[rid]))
            router, _ = _roles_router(make, ROLES4)
        got = drive(router, jreqs if jax_side else reqs)
        sc = router.autoscaler
        events = [(e.tick, e.role, e.action, e.replica) for e in sc.events]
        results.append((got, events, router.stats()["handoffs_done"]))
        if not jax_side:
            assert sc.scale_ups >= 1 and sc.scale_downs >= 1
            downs = [e for e in sc.events if e.action == "down"]
            assert any(e.role == "decode" for e in downs)
            assert router.stats()["failed"] == 0
            assert_pools_balanced(router)
    ref_eng = ServeEngine(model, params, base)
    for r in fresh(reqs):
        ref_eng.submit(r)
    assert results[0][0] == streams(ref_eng.run())
    assert results[0] == results[1]
