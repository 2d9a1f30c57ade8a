"""The port's cluster router on the CPU: the copied ``runtime/cluster.py``
and ``runtime/fault.py`` over the port's ``ServeEngine`` replicas.  Twins
of ``tests/test_cluster_serve.py`` (offers, placement policies, the fault
injector and watchdog, heartbeat loss, replay recovery, backoff, drain and
rejoin, brown-out ordering, chaos kills mid-prefill, mid-decode and during
a preemption checkpoint), with chaos streams bitwise their fault-free
twins within the port; the port's router giving the JAX router's greedy
streams under the same fault schedule; a fenced engine's pools freed once
its replica rejoins; and the launcher's cluster flags."""
import dataclasses
import functools
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import tiny_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.runtime.cluster import (ROUTER_POLICIES,  # noqa: E402
                                         ClusterRouter, ReplicaOffer,
                                         ReplicaState, get_router_policy,
                                         reset_for_replay)
from repro_torch.runtime.fault import (FaultEvent,  # noqa: E402
                                       ReplicaFaultInjector, StepWatchdog)
from repro_torch.runtime.sampling import SamplingParams  # noqa: E402
from repro_torch.runtime.serve import (Request, ServeConfig,  # noqa: E402
                                       ServeEngine)

WEIGHTS = {"gold": 3.0, "free": 1.0}
PAGED = dict(cache="paged", page_size=8, prefix_cache=False)


@functools.lru_cache(maxsize=None)
def port_lm(arch="internlm2-1.8b"):
    """The port's model over ``tiny_lm(arch)``'s weights (2 layers, vocab
    64, f32 cache), carried across from the JAX init."""
    _, jp = tiny_lm(arch)
    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=2,
                              vocab_size=64)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    return model, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def factory(**kw):
    """make_engine(rid): a fresh port engine per call over one config."""
    model, params = port_lm()
    cfg = ServeConfig(**{"batch_slots": 2, "max_len": 64, **kw})
    return lambda rid: ServeEngine(model, params, cfg)


def jax_factory(**kw):
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine

    model, params = tiny_lm()
    cfg = JServeConfig(**{"batch_slots": 2, "max_len": 64, **kw})
    return lambda rid: JServeEngine(model, params, cfg)


def make_reqs(n=4, *, max_new=8, seed=0, sampled=True, base_id=100,
              cls=Request, sampling_cls=SamplingParams):
    """The reference tests' request set: prompts of 3-8 tokens, every
    other request seeded-sampled (temperature 0.8) when ``sampled``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, 60,
                              size=int(rng.integers(3, 9))).astype(np.int32)
        sp = sampling_cls(temperature=0.8 if (sampled and i % 2) else 0.0,
                          seed=7)
        out.append(cls(base_id + i, prompt, max_new_tokens=max_new,
                       sampling=sp, tenant="gold" if i % 3 == 0 else "free"))
    return out


def jax_reqs(n=4, **kw):
    from repro.runtime.sampling import SamplingParams as JSamplingParams
    from repro.runtime.serve import Request as JRequest

    return make_reqs(n, cls=JRequest, sampling_cls=JSamplingParams, **kw)


def fresh(reqs):
    return [dataclasses.replace(r, prompt=np.asarray(r.prompt), output=[])
            for r in reqs]


def streams(done):
    return {r.req_id: list(r.output) for r in done}


def reference(reqs, **kw):
    """Fault-free single-engine streams of a request set."""
    eng = factory(**kw)(0)
    for r in fresh(reqs):
        eng.submit(r)
    return streams(eng.run())


def steady_watchdogs(monkeypatch):
    """Routers whose straggler watchdogs never flag.  A flag comes from
    the wall clock (a step 3x its median) and routes around the replica,
    so a comparison of placement-dependent counts (recoveries, scale
    events) across two runs holds only without it; streams hold either
    way."""
    import repro.runtime.cluster as jcluster
    from repro_torch.runtime import cluster

    for mod in (cluster, jcluster):
        monkeypatch.setattr(mod, "StepWatchdog", functools.partial(
            mod.StepWatchdog, threshold=float("inf")))


def assert_pools_balanced(router):
    for rh in router.replicas:
        if rh.engine is not None and rh.engine.kv is not None:
            pool = rh.engine.kv.pool
            assert pool.in_use == 0, f"replica {rh.rid} leaked pages"
            assert not np.any(np.asarray(pool.ref[1:]))


# ----------------------------------------------------------------- offers
def test_engine_offer_and_free_slots():
    eng = factory()(0)
    off = eng.offer()
    assert off == {"free_slots": 2, "free_pages": None, "page_size": None,
                   "queue_depth": 0}
    eng.submit(Request(1, np.array([3, 4], np.int32), max_new_tokens=2))
    assert eng.offer()["free_slots"] == 1
    assert eng.offer()["queue_depth"] == 1
    assert eng.live_requests()[0].req_id == 1
    eng.run()
    assert eng.offer() == off
    assert eng.live_requests() == []


def test_paged_offer_advertises_pool():
    eng = factory(**PAGED)(0)
    off = eng.offer()
    assert off["page_size"] == 8
    assert off["free_pages"] == eng.kv.pool.available > 0
    assert eng.kv_stats()["cache"] == "paged"


def test_offer_and_can_accept_match_jax_engine():
    """The hooks the routers read give the JAX engine's answers at every
    tick of one trace (dense and paged)."""
    for kw in ({}, PAGED):
        eng, jeng = factory(**kw)(0), jax_factory(**kw)(0)
        probe, jprobe = make_reqs(1, seed=9)[0], jax_reqs(1, seed=9)[0]
        for r in fresh(make_reqs(3, max_new=4)):
            eng.submit(r)
        for r in fresh(jax_reqs(3, max_new=4)):
            jeng.submit(r)
        for _ in range(8):
            assert eng.offer() == jeng.offer()
            assert eng.can_accept(probe) == jeng.can_accept(jprobe)
            assert ([r.req_id for r in eng.live_requests()]
                    == [r.req_id for r in jeng.live_requests()])
            eng.step()
            jeng.step()


# --------------------------------------------------------------- policies
def _offers(slots):
    return [ReplicaOffer(replica=i, free_slots=s, free_pages=None,
                         page_size=None, queue_depth=0)
            for i, s in enumerate(slots)]


def test_pack_picks_busiest_spread_picks_emptiest():
    offers = _offers([3, 1, 2])
    assert get_router_policy("pack").select(offers).replica == 1
    assert get_router_policy("spread").select(offers).replica == 0
    tie = _offers([2, 2])
    assert get_router_policy("pack").select(tie).replica == 0
    assert get_router_policy("spread").select(tie).replica == 0


def test_router_policy_registry():
    assert set(ROUTER_POLICIES) == {"pack", "spread"}
    with pytest.raises(KeyError):
        get_router_policy("bogus")
    pol = get_router_policy("pack")
    assert get_router_policy(pol) is pol


# --------------------------------------------------------------- injector
def test_injector_parse_explicit():
    inj = ReplicaFaultInjector.parse("8:kill:1, 20:rejoin:1,"
                                     "5:stall:0:0.02:10")
    assert [(e.tick, e.action, e.replica) for e in inj.events] == \
        [(5, "stall", 0), (8, "kill", 1), (20, "rejoin", 1)]
    assert inj.events[0].arg == 0.02 and inj.events[0].ticks == 10
    assert inj.pop(4) == []
    assert [e.action for e in inj.pop(8)] == ["stall", "kill"]
    assert inj.pop(8) == []
    inj.reset()
    assert len(inj.pop(100)) == 3


def test_injector_rejects_junk():
    with pytest.raises(ValueError):
        ReplicaFaultInjector.parse("8:explode:1")
    with pytest.raises(ValueError):
        ReplicaFaultInjector.parse("8:kill")
    with pytest.raises(ValueError):
        FaultEvent(-1, "kill", 0)
    with pytest.raises(ValueError):
        FaultEvent(1, "kill", 0, ticks=0)


def test_injector_seeded_matches_reference():
    from repro.runtime.fault import ReplicaFaultInjector as JInjector

    for seed in range(12):
        ours = ReplicaFaultInjector.seeded(seed, n_replicas=3, n_faults=4)
        ref = JInjector.seeded(seed, n_replicas=3, n_faults=4)
        assert ([dataclasses.astuple(e) for e in ours.events]
                == [dataclasses.astuple(e) for e in ref.events])
        assert all(e.replica != 0 for e in ours.events
                   if e.action == "kill")
    assert (ReplicaFaultInjector.seeded(5, n_replicas=3).events
            == ReplicaFaultInjector.parse("seed=5:3").events)


def test_watchdog_flag_threshold(monkeypatch):
    from repro_torch.runtime import fault

    clock = {"t": 0.0}
    monkeypatch.setattr(fault.time, "monotonic", lambda: clock["t"])

    def tick(wd, step, dt):
        wd.start()
        clock["t"] += dt
        wd(step, None)

    wd = StepWatchdog(threshold=3.0)
    tick(wd, 0, 10.0)
    for s in range(1, 8):
        tick(wd, s, 0.1)
    assert wd.flagged == []
    tick(wd, 8, 0.29)
    assert wd.flagged == []
    tick(wd, 9, 0.31)
    assert [f[0] for f in wd.flagged] == [9]
    assert wd.flagged[0][2] == pytest.approx(0.1)


class _Straggler(ServeEngine):
    """A replica-1 engine whose 8th and 9th steps take 0.6 s longer, inside
    the step the router's watchdog times: a slow host."""

    def step(self):
        self.n_steps = getattr(self, "n_steps", 0) + 1
        if self.replica == 1 and self.n_steps in (8, 9):
            time.sleep(0.6)
        return super().step()


def test_router_flags_and_routes_around_straggler():
    """A straggling replica is flagged, the pool browns out, and the
    streams hold.  The straggle is in the engine's step: the injector's
    ``stall`` sleeps outside the watchdog's window (next test), so the
    reference's twin of this test is flagged only by the spread of its
    step times."""
    model, params = port_lm()
    config = ServeConfig(batch_slots=2, max_len=64)
    inj = ReplicaFaultInjector([FaultEvent(8, "stall", 1, arg=0.25,
                                           ticks=2)])
    router = ClusterRouter(lambda rid: _Straggler(model, params, config), 2,
                           policy="spread", injector=inj)
    reqs = make_reqs(6, max_new=12)
    ref = reference(reqs)
    for r in fresh(reqs):
        router.submit(r)
    done = router.run(max_ticks=500)
    st = router.stats()
    assert st["replicas"][1]["flags"] >= 1
    assert st["brownout_ticks"] >= 1
    assert streams(done) == ref


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_injector_stall_sleeps_outside_the_watchdog_window(pkg,
                                                           monkeypatch):
    """A fault of the reference, copied with ``runtime/cluster.py``:
    ``ReplicaHandle.step`` sleeps a scheduled stall before
    ``watchdog.start()``, so the watchdog never sees it (its docstring says
    it does).  On a fake clock: 5 s stalls go unflagged, a 5 s step is
    flagged."""
    import importlib

    cluster = importlib.import_module(f"{pkg}.runtime.cluster")
    clock = {"t": 0.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    monkeypatch.setattr(time, "sleep",
                        lambda s: clock.__setitem__("t", clock["t"] + s))

    class Engine:
        cost = 0.1

        def step(self):
            clock["t"] += self.cost
            return 0

    rh = cluster.ReplicaHandle(0, lambda rid: Engine())
    rh.stall_s, rh.stall_until = 5.0, 12
    for tick in range(13):
        rh.step(tick)
    assert clock["t"] == pytest.approx(13 * 5.0 + 13 * 0.1)
    assert rh.watchdog.flagged == [] and not rh.slow
    rh.engine.cost = 5.0
    rh.step(13)
    assert [f[0] for f in rh.watchdog.flagged] == [13] and rh.slow


# ------------------------------------------------------- health/recovery
def test_kill_detected_at_miss_threshold():
    inj = ReplicaFaultInjector([FaultEvent(3, "kill", 1)])
    router = ClusterRouter(factory(), 2, miss_threshold=3, injector=inj)
    for r in make_reqs(4, max_new=16):
        router.submit(r)
    for _ in range(4):
        router.step()
    rh = router.replicas[1]
    assert rh.state is ReplicaState.UP and rh.misses == 2
    router.step()
    assert rh.state is ReplicaState.LOST
    assert rh.engine is None
    assert router.placed[1] == []
    done = router.run(max_ticks=500)
    assert len(done) == 4
    assert all(r.finish_reason != "failed" for r in done)


def test_hbdrop_below_threshold_is_tolerated():
    inj = ReplicaFaultInjector([FaultEvent(3, "hbdrop", 1, ticks=2)])
    router = ClusterRouter(factory(), 2, miss_threshold=3, injector=inj)
    reqs = make_reqs(4)
    ref = reference(reqs)
    for r in fresh(reqs):
        router.submit(r)
    done = router.run(max_ticks=500)
    st = router.stats()
    assert st["replicas_lost"] == 0 and st["recoveries"] == 0
    assert streams(done) == ref


def test_hbdrop_past_threshold_fences_live_replica():
    inj = ReplicaFaultInjector([FaultEvent(2, "hbdrop", 1, ticks=4)])
    router = ClusterRouter(factory(), 2, miss_threshold=2, injector=inj)
    reqs = make_reqs(4, max_new=10)
    ref = reference(reqs)
    for r in fresh(reqs):
        router.submit(r)
    done = router.run(max_ticks=500)
    st = router.stats()
    assert st["replicas_lost"] == 1 and st["recoveries"] >= 1
    assert streams(done) == ref


def test_retry_budget_exhaustion_fails_request():
    sched = []
    for i in range(4):
        sched += [FaultEvent(2 + 8 * i, "kill", 0),
                  FaultEvent(8 + 8 * i, "rejoin", 0)]
    router = ClusterRouter(factory(), 1, retry_budget=2, miss_threshold=1,
                           backoff_ticks=1,
                           injector=ReplicaFaultInjector(sched))
    h = router.submit(make_reqs(1, max_new=32)[0])
    done = router.run(max_ticks=300)
    assert done[0].finish_reason == "failed"
    assert h.retries == 3
    assert router.stats()["failed"] == 1


def test_exponential_backoff_defers_replacement():
    router = ClusterRouter(factory(), 2, miss_threshold=1, backoff_ticks=4,
                           injector=ReplicaFaultInjector(
                               [FaultEvent(2, "kill", 1)]))
    for r in make_reqs(4, max_new=16):
        router.submit(r)
    for _ in range(2):
        router.step()
    recovered = [rr for rr in router.queue if rr.retries == 1]
    assert recovered
    assert all(rr.not_before == 2 + 4 for rr in recovered)
    done = router.run(max_ticks=500)
    assert all(r.finish_reason != "failed" for r in done)


def test_drain_and_rejoin():
    router = ClusterRouter(factory(), 2, policy="pack")
    for r in make_reqs(3, max_new=6):
        router.submit(r)
    router.step()
    router.drain(1)
    assert len(router.run(max_ticks=500)) == 3
    assert router.replicas[1].state is ReplicaState.DOWN
    assert router.replicas[1].engine is None
    router.rejoin(1)
    assert router.replicas[1].state is ReplicaState.UP
    router.drain(1)
    for r in make_reqs(2, base_id=300):
        router.submit(r)
    assert len(router.run(max_ticks=500)) == 2


# --------------------------------------------------------------- brownout
def test_brownout_orders_gold_before_free():
    router = ClusterRouter(factory(), 2, tenant_weights=WEIGHTS)
    for r in make_reqs(2, base_id=10):
        r.tenant = "free"
        router.submit(r)
    for r in make_reqs(1, base_id=20):
        r.tenant = "gold"
        router.submit(r)
    assert [rr.req.req_id for rr in router._placement_order()] == \
        [10, 11, 20]
    router.replicas[1].killed = True
    assert router.degraded()
    assert [rr.req.req_id for rr in router._placement_order()] == \
        [20, 10, 11]


def test_brownout_sheds_free_but_completes_everything():
    reqs = make_reqs(8, max_new=10, seed=3)
    ref = reference(reqs)
    inj = ReplicaFaultInjector([FaultEvent(2, "kill", 1),
                                FaultEvent(14, "rejoin", 1)])
    router = ClusterRouter(factory(), 2, miss_threshold=1,
                           tenant_weights=WEIGHTS, injector=inj)
    handles = [router.submit(r) for r in fresh(reqs)]
    done = router.run(max_ticks=500)
    assert router.stats()["brownout_ticks"] >= 1
    assert len(done) == 8
    assert streams(done) == ref
    assert all(h.finish_reason != "failed" for h in handles)


# ------------------------------------------------------------------ chaos
def chaos_run(reqs, *, kill_tick, n_replicas=3, engine_kw=None,
              rejoin_tick=None, jax_side=False, **router_kw):
    """``reqs`` through a router of ``n_replicas`` (paged by default)
    with replica 1 killed at ``kill_tick`` (and rejoined); the JAX
    router over JAX engines when ``jax_side``."""
    if jax_side:
        from repro.runtime import cluster, fault
        make = jax_factory
    else:
        from repro_torch.runtime import cluster, fault
        make = factory
    engine_kw = dict(PAGED, **(engine_kw or {}))
    events = [fault.FaultEvent(kill_tick, "kill", 1)]
    if rejoin_tick:
        events.append(fault.FaultEvent(rejoin_tick, "rejoin", 1))
    router = cluster.ClusterRouter(
        make(**engine_kw), n_replicas, miss_threshold=1,
        injector=fault.ReplicaFaultInjector(events), **router_kw)
    for r in fresh(reqs):
        router.submit(r)
    return router, streams(router.run(max_ticks=800))


def test_chaos_kill_mid_prefill_bitwise():
    rng = np.random.default_rng(11)
    reqs = [Request(500 + i, rng.integers(1, 60, size=24).astype(np.int32),
                    max_new_tokens=6,
                    sampling=SamplingParams(temperature=0.8 if i % 2
                                            else 0.0, seed=7))
            for i in range(4)]
    ref = reference(reqs, **PAGED, prefill_chunk=8)
    router, out = chaos_run(reqs, kill_tick=2,
                            engine_kw={"prefill_chunk": 8})
    assert router.stats()["recoveries"] >= 1
    assert all(len(v) == 6 for v in out.values())
    assert out == ref
    assert_pools_balanced(router)


@pytest.mark.parametrize("policy", ["spread", "pack"])
def test_chaos_kill_mid_decode_bitwise(policy):
    reqs = make_reqs(6, max_new=16, seed=5)
    ref = reference(reqs, **PAGED)
    router, out = chaos_run(reqs, kill_tick=6, rejoin_tick=20,
                            policy=policy)
    assert router.stats()["recoveries"] >= 1
    # the kill landed mid-decode: a victim replayed emitted tokens
    assert any(h.retries and len(h.req.prompt) > len(r.prompt)
               for h, r in zip(router._handles, reqs))
    assert out == ref
    assert_pools_balanced(router)


def test_chaos_kill_during_preemption_checkpoint_bitwise():
    kw = dict(PAGED, policy="drf-fair", preempt=True, tenant_weights=WEIGHTS)
    free = make_reqs(2, max_new=24, seed=8, base_id=700)
    gold = make_reqs(1, max_new=24, seed=9, base_id=800)
    for r in free:
        r.tenant = "free"
    gold[0].tenant = "gold"
    ref = reference(free + gold, **kw)
    router = ClusterRouter(factory(**kw), 2, policy="pack", miss_threshold=1,
                           tenant_weights=WEIGHTS)
    for r in fresh(free):
        router.submit(r)
    for _ in range(3):
        router.step()
    assert router.placed[0]
    hg = router.submit(fresh(gold)[0])
    rr = next(rr for rr in router.queue if rr.req.req_id == 800)
    router.queue.remove(rr)
    router.replicas[0].engine.submit(rr.req)
    rr.replica = 0
    router.placed[0].append(rr)
    eng0 = router.replicas[0].engine
    for _ in range(60):
        router.step()
        if eng0.scheduler.preempted_total >= 1:
            break
    assert eng0.scheduler.preempted_total >= 1
    victim = next((rr.req for rr in router.placed[0]
                   if getattr(rr.req, "_preempted", False)), None)
    assert victim is not None and victim._ckpt_pages is not None
    router.replicas[0].killed = True
    done = router.run(max_ticks=800)
    assert len(done) == 3
    assert all(r.finish_reason != "failed" for r in done)
    assert not getattr(victim, "_preempted", False)
    assert streams(done) == ref
    assert hg.done
    assert_pools_balanced(router)


def test_reset_for_replay_clears_engine_state():
    req = Request(1, np.array([5, 6, 7], np.int32), max_new_tokens=8,
                  tenant="gold")
    req.output = [10, 11]
    req._preempted = True
    req._ckpt_pages = [3, 4]
    req._drf_charged = object()
    req._feed = object()
    req.done = True
    req.finish_reason = "length"
    assert reset_for_replay(req) is req
    assert list(req.prompt) == [5, 6, 7, 10, 11]
    assert req.output == [10, 11]
    assert not req.done and req.finish_reason is None
    assert req._preempted is False
    assert req._ckpt_pages is None and req._drf_charged is None


# -------------------------------------------- against the JAX router
@pytest.mark.parametrize("engine_kw", [{}, PAGED], ids=["dense", "paged"])
def test_chaos_greedy_streams_match_jax_router(engine_kw, monkeypatch):
    """Under one fault schedule (a kill mid-decode and a rejoin), the
    port's router over port engines gives the JAX router's greedy streams
    over JAX engines, and both equal their fault-free runs."""
    steady_watchdogs(monkeypatch)
    reqs = make_reqs(6, max_new=12, seed=5, sampled=False)
    jreqs = jax_reqs(6, max_new=12, seed=5, sampled=False)
    kw = {"engine_kw": engine_kw, "kill_tick": 5, "rejoin_tick": 15}
    router, out = chaos_run(reqs, **kw)
    jrouter, jout = chaos_run(jreqs, jax_side=True, **kw)
    assert router.stats()["recoveries"] == jrouter.stats()["recoveries"] >= 1
    assert out == jout
    assert out == reference(reqs, **dict(PAGED, **engine_kw))


# ------------------------------------------------------- fenced memory
def test_fenced_engine_is_freed_at_rejoin():
    """A fenced replica's engine (and with it its page pools) is held by
    the router's shared telemetry until the replica rejoins; the rejoin
    rebinds those series to the fresh engine, and then nothing holds the
    old one: refcounting frees it, with no garbage collection run."""
    inj = ReplicaFaultInjector([FaultEvent(3, "kill", 1),
                                FaultEvent(8, "rejoin", 1)])
    router = ClusterRouter(factory(**PAGED), 2, miss_threshold=1,
                           injector=inj)
    for r in make_reqs(4, max_new=12):
        router.submit(r)
    old = weakref.ref(router.replicas[1].engine)
    pool = weakref.ref(router.replicas[1].engine.caches["stack"]["k"])
    for _ in range(3):
        router.step()
    while router.replicas[1].engine is None:
        router.step()
    assert router.replicas[1].engine is not old()
    assert old() is None and pool() is None
    router.run(max_ticks=500)
    assert_pools_balanced(router)


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("flags", [
    ["--replicas", "2", "--fault-schedule", "6:kill:1,14:rejoin:1"],
    ["--replicas", "2", "--cache", "paged", "--page-size", "8",
     "--router-policy", "pack", "--fault-schedule", "4:kill:1"],
    ["--replicas", "3", "--roles", "prefill=1,decode=2", "--cache",
     "paged", "--page-size", "8"],
    ["--replicas", "2", "--roles", "prefill=1,decode=1",
     "--autoscale-policy", "queue-depth", "--max-replicas", "2"],
], ids=["chaos-dense", "chaos-paged-pack", "disagg", "autoscale"])
def test_launcher_cluster_streams_equal_single_engine(flags, capsys):
    """The launcher's router paths on the CPU: every request finishes,
    none fails, and the greedy streams equal the single engine's."""
    base = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
            "--requests", "8"]
    paged = ["--cache", "paged", "--page-size", "8"] if "paged" in flags \
        else []
    want = streams(launch.main(base + paged))
    done = launch.main(base + flags)
    assert len(done) == 8 and streams(done) == want
    out = capsys.readouterr().out
    assert "cluster: replicas=" in out and "finished=8/8" in out
    if "--fault-schedule" in flags:
        assert "lost=1" in out


@pytest.mark.parametrize("flags", [
    ["--roles", "prefill=1,decode=1"],  # counts sum to 2, replicas 1
    ["--replicas", "2", "--roles", "decode=2"],
    ["--replicas", "2", "--roles", "verify=2"],
    ["--autoscale-policy", "queue-depth"],
    ["--replicas", "0"],
    ["--replicas", "2", "--roles", "prefill=1,decode=1", "--mode", "wave"],
])
def test_launcher_rejects_bad_cluster_flags(flags):
    with pytest.raises(SystemExit):
        launch.main(["--arch", "internlm2-1.8b", "--smoke", "--device",
                     "cpu"] + flags)


def test_parse_roles_matches_reference():
    from repro.launch.serve import parse_roles as jparse

    for spec in ("prefill=2,decode=1", "unified=3", " decode=1 , prefill=4"):
        assert launch.parse_roles(spec) == jparse(spec)
    for bad in ("", "prefill=0", "prefill=1,prefill=2", "verify=1", "x"):
        with pytest.raises(ValueError):
            launch.parse_roles(bad)
