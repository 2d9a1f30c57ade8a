"""Disaggregated prefill/decode in the port, on the CPU: the port's
``runtime/disagg.py`` over its ``ServeEngine`` replicas.  Twins of
``tests/test_disagg.py`` (roles, the prefill and decode engines, the
cross-pool transfer's refcounts and backpressure, the dense host snapshot,
streams bitwise the unified engine's with the same slots through
backpressure, unified replicas, chaos kills mid-handoff, the flight dump,
retirement and telemetry), plus ``copy_cache_pages(_across)`` bitwise the
reference's on f32 and int8 pools (scales included), int8 pools handed off
bitwise, and the disaggregated streams equal to the JAX ``DisaggRouter``'s."""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.runtime.cluster import ReplicaState  # noqa: E402
from repro_torch.runtime.disagg import (ROLES, DisaggRouter,  # noqa: E402
                                        Handoff, transfer_chain)
from repro_torch.runtime.fault import (FaultEvent,  # noqa: E402
                                       ReplicaFaultInjector)
from repro_torch.runtime.serve import (Request, ServeConfig,  # noqa: E402
                                       ServeEngine)
from repro_torch.runtime.telemetry import (Telemetry,  # noqa: E402
                                           validate_chrome_trace)
from test_torch_cluster import (PAGED, assert_pools_balanced,  # noqa: E402
                                fresh, jax_reqs, make_reqs, port_lm,
                                streams)

INT8 = dict(PAGED, kv_dtype="int8")


def _role_factory(roles, **kw):
    model, params = port_lm()
    base = ServeConfig(**{"batch_slots": 2, "max_len": 64, **kw})
    return lambda rid: ServeEngine(
        model, params, dataclasses.replace(base, role=roles[rid]))


def _router(roles, *, engine_kw=None, **kw):
    roles = list(roles)
    return DisaggRouter(_role_factory(roles, **(engine_kw or {})),
                        len(roles), roles=roles, **kw)


def _reqs(n=4, **kw):
    """Mixed greedy / seeded-sampled requests (every tenant tag set)."""
    return make_reqs(n, **kw)


def _reference(reqs, **kw):
    """Unified single-engine streams of a request set."""
    model, params = port_lm()
    eng = ServeEngine(model, params,
                      ServeConfig(**{"batch_slots": 2, "max_len": 64, **kw}))
    for r in fresh(reqs):
        eng.submit(r)
    return streams(eng.run())


def _prefilled(src, req):
    src.submit(req)
    for _ in range(10):
        src.step()
        if req.output:
            break
    assert req.output
    return src.release(req)


# ------------------------------------------------------------------- roles
def test_role_validation():
    with pytest.raises(ValueError, match="2 entries for 3"):
        DisaggRouter(_role_factory(["prefill", "decode", "decode"]), 3,
                     roles=["prefill", "decode"])
    with pytest.raises(ValueError, match="unknown roles"):
        _router(["prefill", "verify"])
    with pytest.raises(ValueError, match="prefill-capable"):
        _router(["decode", "decode"])
    with pytest.raises(ValueError, match="decode-capable"):
        _router(["prefill", "prefill"])
    with pytest.raises(ValueError, match="decode-capable"):
        _router(["prefill", "decode"], start_down=(1,))


def test_serve_config_role_validation():
    model, params = port_lm()
    with pytest.raises(ValueError, match="role"):
        ServeEngine(model, params, ServeConfig(role="verify"))
    with pytest.raises(ValueError, match="continuous"):
        ServeEngine(model, params, ServeConfig(role="prefill", mode="wave"))
    ssm, ssm_params = port_lm("mamba2-1.3b")
    with pytest.raises(ValueError, match="chunked prefill"):
        ServeEngine(ssm, ssm_params, ServeConfig(role="decode"))


def test_decode_engine_rejects_fresh_requests():
    model, params = port_lm()
    eng = ServeEngine(model, params, ServeConfig(role="decode"))
    with pytest.raises(ValueError, match="handed-off"):
        eng.submit(Request(1, np.array([3, 4], np.int32), max_new_tokens=2))


@pytest.mark.parametrize("engine_kw", [{}, PAGED], ids=["dense", "paged"])
def test_prefill_engine_emits_one_token_and_never_decodes(engine_kw):
    """A prefill engine's tick ends at admission: the whole prompt is
    prefilled, the first token emitted, and no decode step runs."""
    model, params = port_lm()
    eng = ServeEngine(model, params, ServeConfig(
        batch_slots=2, max_len=64, role="prefill", **engine_kw))
    reqs = [eng.submit(r).req for r in fresh(_reqs(2, max_new=6))]
    assert eng.step() == 2
    for _ in range(3):
        assert eng.step() == 0
    assert [len(r.output) for r in reqs] == [1, 1]
    assert all(r.state.value == "decode" for r in reqs)
    assert list(eng.pos) == [len(r.prompt) for r in reqs]


def test_router_places_fresh_only_on_prefill_capable():
    router = _router(["prefill", "decode"])
    for r in _reqs(4):
        router.submit(r)
    router.step()
    assert all(rr.history[0] == 0 for rr in router.placed[1])
    assert not router._accepts_new(router.replicas[1])
    assert router._accepts_new(router.replicas[0])


# ----------------------------------------------------- cross-pool transfer
@pytest.mark.parametrize("engine_kw", [PAGED, INT8], ids=["f32", "int8"])
def test_transfer_chain_refcount_balanced(engine_kw):
    model, params = port_lm()
    cfg = ServeConfig(batch_slots=2, max_len=64, **engine_kw)
    src = ServeEngine(model, params, dataclasses.replace(cfg, role="prefill"))
    dst = ServeEngine(model, params, dataclasses.replace(cfg, role="decode"))
    req = _reqs(1, max_new=6)[0]
    ck = _prefilled(src, req)
    n = len(ck.pages)
    assert n > 0
    assert src.kv.pool.in_use == n and dst.kv.pool.in_use == 0
    src_pages = list(ck.pages)
    assert transfer_chain(src, dst, req)
    assert src.kv.pool.in_use == 0
    assert not np.any(np.asarray(src.kv.pool.ref[1:]))
    assert dst.kv.pool.in_use == n
    # the chain's bytes (and an int8 pool's scales) arrived unchanged
    for key, leaf in dst.caches["stack"].items():
        np.testing.assert_array_equal(
            leaf[:, ck.pages].numpy(),
            src.caches["stack"][key][:, src_pages].numpy(), err_msg=key)
    dst.submit(req)
    dst.run()
    assert req.done
    assert dst.kv.pool.in_use == 0
    assert not np.any(np.asarray(dst.kv.pool.ref[1:]))


def test_transfer_chain_backpressure_leaves_source_intact():
    model, params = port_lm()
    cfg = ServeConfig(batch_slots=2, max_len=64, **PAGED)
    src = ServeEngine(model, params, dataclasses.replace(cfg, role="prefill"))
    dst = ServeEngine(model, params, dataclasses.replace(
        cfg, role="decode", num_pages=2))
    req = _reqs(1, max_new=6, seed=3)[0]
    ck = _prefilled(src, req)
    held = src.kv.pool.in_use
    assert len(ck.pages) > 1  # more than the 2-page pool's one free page
    assert not transfer_chain(src, dst, req)
    assert src.kv.pool.in_use == held
    assert dst.kv.pool.in_use == 0


def test_dense_checkpoint_transfer_is_free():
    model, params = port_lm()
    cfg = ServeConfig(batch_slots=2, max_len=64)
    src = ServeEngine(model, params, dataclasses.replace(cfg, role="prefill"))
    dst = ServeEngine(model, params, dataclasses.replace(cfg, role="decode"))
    req = _reqs(1, max_new=4)[0]
    ck = _prefilled(src, req)
    assert ck.pages is None and ck.kv is not None
    assert ck.kv["stack"]["k"].device.type == "cpu"  # a host snapshot
    assert transfer_chain(src, dst, req)


def _jax_pools(kv_quant, num_pages, seed):
    """JAX paged pools of ``tiny_lm``'s model with random content in every
    leaf (quantized values and their scales alike)."""
    from repro.models import LM as JLM
    from repro.models import RuntimeKnobs as JKnobs

    jm, _ = tiny_lm()
    model = JLM(jm.cfg, JKnobs(cache_dtype=jnp.float32, kv_quant=kv_quant))
    pools = model.init_cache_paged(num_pages, 8)
    rng = np.random.default_rng(seed)

    def fill(leaf):
        if leaf.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, leaf.shape), jnp.int8)
        return jnp.asarray(rng.normal(size=leaf.shape), leaf.dtype)

    return model, jax.tree.map(fill, pools)


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32", "int8"])
def test_copy_cache_pages_across_matches_reference(kv_quant):
    """The cross-pool page copy, bitwise the reference's on the same pools
    of different sizes: every leaf, the int8 values and their f32 scales
    included.  The reference pads its index vectors with 0, copying the
    source's null page onto the destination's; the port copies the chain
    alone, so its destination null page keeps what it held."""
    jm, src = _jax_pools(kv_quant, 9, seed=1)
    _, dst = _jax_pools(kv_quant, 13, seed=2)
    src_idx, dst_idx = [3, 7, 1, 5], [12, 2, 9, 4]
    pad = lambda v: jnp.asarray(v + [0] * 4, jnp.int32)  # noqa: E731
    want = jm.copy_cache_pages_across(src, dst, pad(src_idx), pad(dst_idx))
    model, _ = port_lm()
    model = type(model)(model.cfg, model.knobs.with_(kv_quant=kv_quant),
                        "cpu")
    t_src = convert.paged_cache_from_jax(jax.tree.map(np.asarray, src))
    t_dst = convert.paged_cache_from_jax(jax.tree.map(np.asarray, dst))
    out = model.copy_cache_pages_across(
        t_src, t_dst, torch.tensor(src_idx), torch.tensor(dst_idx))
    assert out is t_dst  # written in place
    got = convert.paged_cache_to_numpy(out)
    names = {"k", "v"} | ({"k_scale", "v_scale"} if kv_quant else set())
    assert set(got["stack"]) == names
    before = jax.tree.map(np.asarray, dst)
    for key in names:
        np.testing.assert_array_equal(got["stack"][key][:, 1:],
                                      np.asarray(want["stack"][key])[:, 1:],
                                      err_msg=key)
        np.testing.assert_array_equal(got["stack"][key][:, 0],
                                      before["stack"][key][:, 0])


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32", "int8"])
def test_copy_cache_pages_matches_reference(kv_quant):
    jm, pools = _jax_pools(kv_quant, 9, seed=3)
    want = jm.copy_cache_pages(pools, 4, 6)
    model, _ = port_lm()
    model = type(model)(model.cfg, model.knobs.with_(kv_quant=kv_quant),
                        "cpu")
    got = convert.paged_cache_to_numpy(model.copy_cache_pages(
        convert.paged_cache_from_jax(jax.tree.map(np.asarray, pools)), 4,
        6))
    for key, leaf in got["stack"].items():
        np.testing.assert_array_equal(leaf, np.asarray(want["stack"][key]))


# ----------------------------------------------------------- bitwise runs
@pytest.mark.parametrize("engine_kw", [{}, PAGED, INT8],
                         ids=["dense", "paged", "int8"])
def test_disagg_bitwise_identical_to_unified(engine_kw):
    reqs = _reqs(6, max_new=10, seed=2)
    ref = _reference(reqs, **engine_kw)
    router = _router(["prefill", "decode", "decode"], engine_kw=engine_kw)
    for r in fresh(reqs):
        router.submit(r)
    done = router.run(max_ticks=500)
    st = router.stats()
    assert st["handoffs_done"] == 6
    assert st["handoffs_in_transit"] == 0
    assert streams(done) == ref
    assert_pools_balanced(router)


@pytest.mark.parametrize("engine_kw", [{}, PAGED], ids=["dense", "paged"])
def test_disagg_greedy_streams_match_jax_router(engine_kw):
    """The port's DisaggRouter over port engines gives the JAX
    DisaggRouter's greedy streams over JAX engines, handoff for
    handoff."""
    from repro.runtime.disagg import DisaggRouter as JDisaggRouter
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine

    roles = ["prefill", "decode", "decode"]
    jm, jp = tiny_lm()
    jbase = JServeConfig(batch_slots=2, max_len=64, **engine_kw)
    jrouter = JDisaggRouter(lambda rid: JServeEngine(
        jm, jp, dataclasses.replace(jbase, role=roles[rid])), 3, roles=roles)
    router = _router(roles, engine_kw=engine_kw)
    for r in fresh(jax_reqs(6, max_new=10, seed=2, sampled=False)):
        jrouter.submit(r)
    for r in fresh(_reqs(6, max_new=10, seed=2, sampled=False)):
        router.submit(r)
    want = streams(jrouter.run(max_ticks=500))
    assert streams(router.run(max_ticks=500)) == want
    assert (router.stats()["handoffs_done"]
            == jrouter.stats()["handoffs_done"] == 6)


def test_handoff_backpressure_queues_and_completes():
    reqs = _reqs(5, max_new=8, seed=4)
    router = _router(["prefill", "decode"],
                     engine_kw=dict(PAGED, batch_slots=1))
    ref = _reference(reqs, **dict(PAGED, batch_slots=1))
    for r in fresh(reqs):
        router.submit(r)
    done = router.run(max_ticks=500)
    st = router.stats()
    assert st["handoff_backpressure"] >= 1
    assert st["handoffs_done"] == 5
    assert streams(done) == ref
    assert_pools_balanced(router)


def test_unified_role_in_disagg_pool():
    reqs = _reqs(4, max_new=6, seed=6)
    ref = _reference(reqs)
    router = _router(["unified", "unified"])
    for r in fresh(reqs):
        router.submit(r)
    done = router.run(max_ticks=300)
    assert router.stats()["handoffs_done"] == 0
    assert streams(done) == ref


# ------------------------------------------------------------------ chaos
def _drive_until_handoff_from(router, src_rid, max_ticks=60):
    for _ in range(max_ticks):
        router.step()
        if any(h.src == src_rid for h in router.handoffs):
            return True
    return False


@pytest.mark.parametrize("engine_kw", [{}, PAGED, INT8],
                         ids=["dense", "paged", "int8"])
def test_chaos_kill_prefill_mid_handoff_bitwise(engine_kw):
    reqs = _reqs(6, max_new=10, seed=8)
    ref = _reference(reqs, **dict(engine_kw, batch_slots=1))
    router = _router(["prefill", "prefill", "decode"],
                     engine_kw=dict(engine_kw, batch_slots=1),
                     miss_threshold=1)
    for r in fresh(reqs):
        router.submit(r)
    assert _drive_until_handoff_from(router, 1)
    in_flight = [h.rr.req.req_id for h in router.handoffs if h.src == 1]
    router.replicas[1].killed = True
    done = router.run(max_ticks=800)
    st = router.stats()
    assert st["replicas_lost"] == 1
    assert st["recoveries"] >= len(in_flight) >= 1
    assert st["failed"] == 0
    assert streams(done) == ref
    assert_pools_balanced(router)


def test_fence_flight_dump_snapshots_handoff_queue(tmp_path):
    tm = Telemetry(trace=True, flight=128, flight_dir=str(tmp_path))
    router = _router(["prefill", "prefill", "decode"],
                     engine_kw=dict(PAGED, batch_slots=1),
                     miss_threshold=1, telemetry=tm)
    for r in fresh(_reqs(6, max_new=10, seed=8)):
        router.submit(r)
    assert _drive_until_handoff_from(router, 1)
    in_flight = {h.rr.req.req_id: h for h in router.handoffs if h.src == 1}
    router.replicas[1].killed = True
    router.run(max_ticks=800)
    dumps = sorted(glob.glob(os.path.join(str(tmp_path), "flight_*.json")))
    assert dumps
    with open(dumps[0]) as f:
        payload = json.load(f)
    snap = {e["req_id"]: e for e in payload["handoffs_in_transit"]}
    for rid, h in in_flight.items():
        assert snap[rid]["src_replica"] == 1
        assert snap[rid]["pages_in_flight"] == h.n_pages > 0
        assert snap[rid]["target_role"] == "decode"
    assert validate_chrome_trace(tm.trace.to_chrome())["unbalanced"] == {}


def test_chaos_injector_schedule_with_rejoin():
    reqs = _reqs(8, max_new=8, seed=9)
    ref = _reference(reqs, **PAGED)
    inj = ReplicaFaultInjector([FaultEvent(3, "kill", 1),
                                FaultEvent(20, "rejoin", 1)])
    router = _router(["prefill", "prefill", "decode"], engine_kw=PAGED,
                     miss_threshold=1, injector=inj)
    for r in fresh(reqs):
        router.submit(r)
    done = router.run(max_ticks=800)
    assert router.stats()["failed"] == 0
    assert streams(done) == ref
    assert_pools_balanced(router)


# ----------------------------------------------------------- retire/drain
def test_retire_migrates_work_and_reaches_down():
    reqs = _reqs(6, max_new=12, seed=10)
    ref = _reference(reqs, **PAGED)
    router = _router(["unified", "unified", "decode"], engine_kw=PAGED)
    for r in fresh(reqs):
        router.submit(r)
    for _ in range(3):
        router.step()
    assert any(len(router.placed[rid]) for rid in (0, 1))
    victim = 0 if router.placed[0] else 1
    router.retire(victim)
    assert router.replicas[victim].state is ReplicaState.DRAINING
    done = router.run(max_ticks=800)
    assert router.replicas[victim].state is ReplicaState.DOWN
    assert router.replicas[victim].engine is None
    assert streams(done) == ref
    assert_pools_balanced(router)
    assert router.stats()["failed"] == 0


def test_can_retire_blocks_on_in_transit_handoff():
    router = _router(["prefill", "decode"])
    rh = router.replicas[0]
    assert router._can_retire(rh)
    rr = type("RR", (), {"req": type("R", (), {"req_id": 1})()})()
    router.handoffs.append(Handoff(rr=rr, src=0, n_pages=2, tick=0))
    assert not router._can_retire(rh)
    assert router._can_retire(router.replicas[1])
    router.handoffs.clear()


# -------------------------------------------------------------- telemetry
def test_disagg_stats_and_gauges():
    router = _router(["prefill", "decode"])
    st = router.stats()
    assert st["roles"] == {0: "prefill", 1: "decode"}
    assert st["handoffs_done"] == 0
    for r in _reqs(3, max_new=4):
        router.submit(r)
    router.run(max_ticks=300)
    st = router.stats()
    assert st["handoffs_done"] == 3 and st["handoffs_in_transit"] == 0
    assert router.tm.registry.value("disagg_handoffs_done") == 3


def test_handoff_spans_balanced():
    tm = Telemetry(trace=True)
    router = _router(["prefill", "decode"], telemetry=tm)
    for r in _reqs(4, max_new=6):
        router.submit(r)
    router.run(max_ticks=300)
    events = tm.trace.to_chrome()["traceEvents"]
    assert any(e.get("name") == "HANDOFF" for e in events)
    assert validate_chrome_trace(tm.trace.to_chrome())["unbalanced"] == {}


def test_roles_tuple_export():
    assert ROLES == ("prefill", "decode", "unified")
