"""Preemption in the port, on the CPU: slot checkpoint and restore (dense:
a host copy of the slot's stripe through ``copy_cache_out/in``; paged: the
page chain detached, zero-copy), the resumed stream bitwise its
uninterrupted run and equal to the JAX engine's under the same flood, no
page leaked, weighted-DRF tiers, the failed-swap rollback and the
detach/attach round trip of the copied scheduler and page manager, and the
step cache shared across engines."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.runtime.kv_pool import KVCacheManager  # noqa: E402
from repro_torch.runtime.scheduler import (Scheduler,  # noqa: E402
                                           ServeResource)
from repro_torch.runtime.serve import (Checkpoint, Request,  # noqa: E402
                                       RequestState, ServeConfig,
                                       ServeEngine)


def _pair():
    jm, jp = tiny_lm()
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    return jm, jp, tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _engine(**kw):
    _, _, tm, tp = _pair()
    return ServeEngine(tm, tp, ServeConfig(**kw))


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=int(rng.integers(2, 6)))
            .astype(np.int32) for _ in range(n)]


def _solo_outputs(prompts, max_new=8, **kw):
    eng = _engine(batch_slots=1, max_len=64, **kw)
    return [eng.submit(Request(i, p.copy(), max_new_tokens=max_new))
            .result().output for i, p in enumerate(prompts)]


def _flood(eng, prompts, *, n_gold, max_new=8, req_cls=Request):
    """Gold floods, then free trickles in after two ticks; the drained
    requests by id."""
    for i in range(n_gold):
        eng.submit(req_cls(i, prompts[i].copy(), max_new_tokens=max_new,
                           tenant="gold"))
    eng.step()
    eng.step()
    for i in range(n_gold, len(prompts)):
        eng.submit(req_cls(i, prompts[i].copy(), max_new_tokens=max_new,
                           tenant="free"))
    return {r.req_id: r for r in eng.run()}


_WEIGHTED = dict(policy="drf-fair", tenant_weights={"gold": 3, "free": 1},
                 preempt=True, victim_policy="lowest-weight-share-first")
_CACHES = {"dense": {}, "paged": {"cache": "paged", "page_size": 8},
           "int8": {"cache": "paged", "page_size": 8, "kv_dtype": "int8"},
           "fp8": {"cache": "paged", "page_size": 8, "kv_dtype": "fp8"}}


@pytest.mark.parametrize("layout", list(_CACHES))
def test_preempted_request_resumes_bitwise_identical(layout):
    """A preempted-then-resumed request's stream equals its uninterrupted
    run: the checkpoint restores pos, the last token and the KV exactly."""
    prompts = _prompts(8)
    solo_kw = _CACHES[layout] if layout in ("int8", "fp8") else {}
    ref = _solo_outputs(prompts, **solo_kw)
    eng = _engine(batch_slots=4, max_len=64, **_WEIGHTED, **_CACHES[layout])
    done = _flood(eng, prompts, n_gold=6)
    assert eng.scheduler.preempted_total >= 1
    assert sum(r.preempt_count for r in done.values()) >= 1
    for i in range(len(prompts)):
        assert done[i].output == ref[i], \
            f"request {i} (preempted {done[i].preempt_count}x) diverged"
    assert all(v == 0.0 for v in eng.scheduler.shares().values())


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_preempted_streams_equal_jax_engine(layout):
    """The same flood through the JAX engine: the same preemptions leave
    the same streams."""
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine

    jm, jp, _, _ = _pair()
    prompts = _prompts(8)
    jeng = JServeEngine(jm, jp, JServeConfig(batch_slots=4, max_len=64,
                                             **_WEIGHTED, **_CACHES[layout]))
    want = _flood(jeng, prompts, n_gold=6, req_cls=JRequest)
    eng = _engine(batch_slots=4, max_len=64, **_WEIGHTED, **_CACHES[layout])
    got = _flood(eng, prompts, n_gold=6)
    assert eng.scheduler.preempted_total == jeng.scheduler.preempted_total
    assert {i: r.output for i, r in got.items()} \
        == {i: r.output for i, r in want.items()}
    assert {i: r.preempt_count for i, r in got.items()} \
        == {i: r.preempt_count for i, r in want.items()}


def test_no_page_leak_after_preempt_resume_finish():
    prompts = _prompts(9, seed=3)
    eng = _engine(batch_slots=4, max_len=64, cache="paged", page_size=8,
                  prefix_cache=False, **_WEIGHTED)
    _flood(eng, prompts, n_gold=7)
    assert eng.scheduler.preempted_total >= 1
    assert eng.kv.pool.in_use == 0
    assert not np.any(np.asarray(eng.kv.pool.ref[1:]))
    assert not np.any(eng.kv.page_table)


def test_weighted_drf_share_converges_under_flood():
    """With weights {gold: 3, free: 1} over 4 slots preemption clamps gold
    to its 3/4 while free has queued work, and PREEMPTED is observable."""
    prompts = _prompts(12, seed=5)
    eng = _engine(batch_slots=4, max_len=64, **_WEIGHTED)
    for i in range(9):
        eng.submit(Request(i, prompts[i].copy(), max_new_tokens=8,
                           tenant="gold"))
    eng.step()
    handles = [eng.submit(Request(i, prompts[i].copy(), max_new_tokens=4,
                                  tenant="free"))
               for i in range(9, 12)]
    seen_preempted = False
    gold_shares = []
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
        seen_preempted |= any(r.state is RequestState.PREEMPTED
                              for r in eng.queue)
        if any(r.tenant == "free" for r in eng.queue):
            gold = sum(1 for r in eng.active
                       if r is not None and r.tenant == "gold")
            gold_shares.append(gold / 4)
    assert seen_preempted
    assert max(gold_shares) == pytest.approx(0.75)
    assert all(h.done for h in handles)


def test_preempt_requires_continuous_mode():
    with pytest.raises(ValueError, match="continuous"):
        _engine(batch_slots=2, max_len=32, mode="wave", preempt=True)


def test_dense_checkpoint_is_a_host_copy_of_the_stripe():
    """The dense checkpoint holds the slot's stripe of every leaf as a
    copy: later writes to the cache do not reach it, and restoring it into
    another slot reproduces the stripe there bitwise."""
    eng = _engine(batch_slots=2, max_len=32, **_WEIGHTED)
    eng.submit(Request(0, np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=8, tenant="free"))
    eng.step()
    eng.step()
    s = next(i for i, r in enumerate(eng.active) if r is not None)
    eng._ensure_ckpt_fns()
    snap = eng._copy_out(eng.caches, s)
    stripe = {k: v[:, s:s + 1].clone() for k, v in
              eng.caches["stack"].items()}
    assert all(snap["stack"][k].device.type == "cpu"
               and torch.equal(snap["stack"][k], stripe[k]) for k in stripe)
    for leaf in eng.caches["stack"].values():
        leaf.add_(1.0)
    assert all(torch.equal(snap["stack"][k], stripe[k]) for k in stripe)
    eng._copy_in(eng.caches, snap, 1 - s)
    assert all(torch.equal(eng.caches["stack"][k][:, 1 - s:2 - s], stripe[k])
               for k in stripe)
    ck = Checkpoint(pos=3, last_token=7)
    assert ck.pages is None and ck.kv is None


def test_copy_cache_out_in_match_jax_bitwise():
    jm, _, tm, _ = _pair()
    rng = np.random.default_rng(2)
    b, s = 3, 16
    shapes = jax.tree.map(lambda a: a.shape, jm.init_cache(b, s))
    filled = jax.tree.map(lambda shp: rng.normal(size=shp).astype(
        np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    jc = jax.tree.map(jnp.asarray, filled)
    tc = convert.cache_from_jax(filled)
    jaxes = jm.cache_batch_axes(s)
    taxes = tm.cache_batch_axes(s)
    assert taxes == jaxes
    want = jtransformer.copy_cache_out(jc, 1, jaxes)
    got = tm.copy_cache_out(tc, 1, taxes)
    for k in ("k", "v"):
        np.testing.assert_array_equal(got["stack"][k].numpy(),
                                      np.asarray(want["stack"][k]))
    want_in = jtransformer.copy_cache_in(jc, want, 2, jaxes)
    tm.copy_cache_in(tc, got, 2, taxes)
    for k in ("k", "v"):
        np.testing.assert_array_equal(tc["stack"][k].numpy(),
                                      np.asarray(want_in["stack"][k]))


def test_release_is_not_ported():
    """``release()`` is ported now (the disaggregated handoff): it
    checkpoints a running request out of its slot as the JAX engine's
    does (dense: a host copy of the stripe; the same position and feed
    token, the slot parked, the request marked preempted)."""
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine

    jm, jp, _, _ = _pair()
    eng = _engine(batch_slots=1, max_len=32)
    jeng = JServeEngine(jm, jp, JServeConfig(batch_slots=1, max_len=32))
    got, snaps = [], []
    for e, cls in ((eng, Request), (jeng, JRequest)):
        req = cls(0, np.arange(1, 4, dtype=np.int32), max_new_tokens=4)
        e.submit(req)
        e.step()
        ck = e.release(req)
        assert ck.pages is None and req._preempted
        assert req.state.value == "preempted" and e.active[0] is None
        got.append((ck.pos, ck.last_token, list(req.output)))
        snaps.append(ck.kv)
    assert got[0] == got[1]
    for k in ("k", "v"):
        assert snaps[0]["stack"][k].device.type == "cpu"  # a host copy
        np.testing.assert_allclose(snaps[0]["stack"][k].numpy(),
                                   np.asarray(snaps[1]["stack"][k]),
                                   atol=1e-5, rtol=1e-5)


# ------------------------------------------------ scheduler host logic
def _decoding(i, tenant, seq):
    r = Request(i, np.arange(1, 3, dtype=np.int32), max_new_tokens=8,
                tenant=tenant)
    r.state = RequestState.DECODE
    r.output = [1]
    r._feed = None
    r._admit_seq = seq
    r._drf_charged = ServeResource(slots=1, kv=10)
    return r


def test_failed_swap_rolls_back_preemption(monkeypatch):
    """If the admission paired with a preemption fails, the host-side
    preemption is undone: the victim keeps its slot and pages and the DRF
    book returns to its state before the swap."""
    kv = KVCacheManager(slots=2, max_len=32, page_size=8, num_pages=9,
                        prefix_cache=False)
    sched = Scheduler("drf-fair", slots=2, max_len=32, kv=kv,
                      preempt=True, weights={"a": 1, "b": 8})
    victims = []
    for s, i in enumerate(range(2)):
        r = _decoding(i, "a", i)
        res = kv.admit(s, r.prompt, r.max_new_tokens)
        r._drf_charged = ServeResource(slots=1, kv=len(res.blocks))
        sched.allocator.charge("a", r._drf_charged)
        victims.append(r)
    monkeypatch.setattr(kv, "admit", lambda *a, **k: None)
    shares_before = sched.allocator.shares()
    held_before = [list(h) for h in kv._held]
    sched.submit(Request(9, np.arange(1, 3, dtype=np.int32), tenant="b"))
    plan = sched.decide(victims)
    assert not plan.preemptions and not plan.admissions
    assert sched.preempted_total == 0
    assert not any(getattr(r, "_preempted", False) for r in victims)
    assert [list(h) for h in kv._held] == held_before
    assert sched.allocator.shares()["a"] == shares_before["a"]
    assert sched.allocator.shares().get("b", 0.0) == 0.0
    assert len(sched.queue) == 1


def test_paged_detach_attach_round_trip():
    kv = KVCacheManager(slots=2, max_len=32, page_size=8, num_pages=9,
                        prefix_cache=False)
    res = kv.admit(0, np.arange(1, 12, dtype=np.int32), max_new=4)
    pages = list(res.blocks)
    refs_before = kv.pool.ref.copy()
    detached = kv.detach_slot(0)
    assert detached == pages
    assert not np.any(kv.page_table[0])
    assert np.array_equal(kv.pool.ref, refs_before)
    kv.attach_slot(1, detached)
    assert list(kv.page_table[1, :len(pages)]) == pages
    assert np.array_equal(kv.pool.ref, refs_before)
    kv.free_slot(1)
    assert kv.pool.in_use == 0


# ------------------------------------------------- step cache
def test_compiled_step_cache_shared_across_engines():
    """A second engine over the same model reuses the first's steps,
    greedy and sampled; a different knob set is a different key."""
    _, _, tm, tp = _pair()
    e1 = ServeEngine(tm, tp, ServeConfig(batch_slots=2, max_len=32,
                                         draft_k=2))
    before = steps.step_cache_stats()
    e2 = ServeEngine(tm, tp, ServeConfig(batch_slots=2, max_len=32,
                                         draft_k=2))
    after = steps.step_cache_stats()
    assert e2._step is e1._step
    assert e2._step_sampled is e1._step_sampled
    assert e2._spec_step is e1._spec_step
    assert e2._spec_step_sampled is e1._spec_step_sampled
    assert e2._decode_one is e1._decode_one
    assert after["hits"] >= before["hits"] + 5
    assert after["misses"] == before["misses"]
    other = LM(tm.cfg, RuntimeKnobs(cache_dtype=torch.bfloat16),
               device="cpu")
    assert steps.compiled_step(other, "serve") is not e1._step
    with pytest.raises(ValueError):
        steps.compiled_step(tm, "spec_serve")  # no draft_len
    with pytest.raises(ValueError):
        steps.compiled_step(tm, "decode_one", sampled=True)
