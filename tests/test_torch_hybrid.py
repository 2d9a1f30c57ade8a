"""The hybrid plan in the port (zamba2: groups of mamba2 layers, each
followed by one *shared* attention block), on the CPU, against the JAX
package: the blocks' and caches' trees (the shared block's one unstacked
set of weights, one K/V cache per group, SSM leaves inside) and
``cache_batch_axes``; ``LM.hidden``, ``prefill`` (logits and every cache
leaf) and ``loss``; six ``decode_step``s from a zero cache and from a
prefill's caches; greedy token-fed engine streams, continuous and wave,
equal to the JAX engine's with more requests than slots; preempted streams
bitwise the port's unpreempted ones; the reference's refusals (paged
pools, chunked prefill, speculative decode); a narrow config at zamba2's
head_dim of 80; and the launcher.

The JAX side runs both its routes where the test says so: XLA and
``use_pallas=True`` (its Pallas kernels in interpret mode).  Weights come
from the JAX ``LM.init`` through ``convert.params_from_jax``, with the SSM
projections boosted as in ``test_torch_forward.py`` so that SSM state
decides the tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from test_torch_forward import SSM_BOOST  # noqa: E402
from test_torch_grouped import assert_trees_close  # noqa: E402
from repro.runtime.serve import Request as JRequest  # noqa: E402
from repro.runtime.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.runtime.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.runtime.serve import (Request, ServeConfig,  # noqa: E402
                                       ServeEngine)

ARCH = "zamba2-2.7b"
# f32 end to end on both sides: 4-5 mamba2 layers (boosted, the chunked
# scan's exp/cumsum) and 2 shared-block calls summed in other orders stay
# inside 1e-4, as mamba2's do (test_torch_forward.py)
ATOL = 1e-4
LOSS_TOL = 2e-4  # the reference's own bound (tests/test_pallas_integration)
B, S = 2, 32  # 4 SSD chunks of the smoke config's 8
# the smoke config: 4 mamba2 layers in 2 groups of 2, each followed by the
# shared block (head_dim 16), no remainder; "rem" adds a 1-layer remainder
# stack after the groups
OVERRIDES = {"smoke": dict(num_layers=4), "rem": dict(num_layers=5)}
# zamba2's head_dim, 2560 / 32 = 80, at a narrow width: 2 heads of 80
HD80 = dict(num_layers=4, d_model=160, num_heads=2, num_kv_heads=2,
            head_dim=80)


def _boost(params):
    """A numpy copy of a JAX hybrid params tree with every mamba2 layer's
    in_proj and out_proj scaled by SSM_BOOST."""
    params = jax.tree.map(np.asarray, params)
    blocks = params["blocks"]
    for stack in ("inner", "rem"):
        if stack in blocks:
            for key in ("in_proj", "out_proj"):
                blocks[stack]["ssm"][key] = \
                    blocks[stack]["ssm"][key] * SSM_BOOST
    return params


def pair(over, use_pallas=False):
    """(JAX model, JAX params, port model, port params) for the smoke
    config with ``over``; vocab 64, f32 caches, SSM projections boosted."""
    jm, jp = tiny_lm(ARCH, **over)
    jp = jax.tree.map(jnp.asarray, _boost(jp))
    if use_pallas:
        jm = type(jm)(jm.cfg, jm.knobs.with_(use_pallas=True))
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              **dict({"vocab_size": 64}, **over))
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    return jm, jp, tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def _tokens(seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, 64, size=(b, s)).astype(
        np.int32)


# -------------------------------------------------------------------- trees
@pytest.mark.parametrize("name", list(OVERRIDES))
def test_hybrid_trees_are_the_references(name):
    """The port's own init and the dense caches keep the reference's hybrid
    trees leaf for leaf: mamba2 layers (G, P, ...) and (R, ...), the shared
    block unstacked, one K/V cache (G, B, S, KV, D) per group; the caches'
    batch axes are the reference's; the layers run group by group, the
    shared block after each group at parameter index () and cache index
    (g,)."""
    jm, jp, tm, tp = pair(OVERRIDES[name])
    own = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(own) == _shapes(jp) == _shapes(tp)
    plan = ttransformer.build_plan(tm.cfg)
    assert plan.outer_shared and plan.inner_kind == "ssm"
    assert set(own["blocks"]) == {"inner", "outer"} | (
        {"rem"} if plan.remainder else set())
    assert own["blocks"]["outer"]["attn"]["wq"].shape == (
        tm.cfg.d_model, tm.cfg.num_heads, tm.cfg.head_dim)
    assert _shapes(tm.init_cache(B, S)) == _shapes(jm.init_cache(B, S))
    cache = tm.init_cache(B, S)
    assert set(cache["groups"]["inner"]) == {"conv", "state"}
    assert cache["groups"]["outer"]["k"].shape == (
        plan.n_groups, B, S, tm.cfg.num_kv_heads, tm.cfg.head_dim)
    assert tm.cache_batch_axes(S) == jax.tree.map(int,
                                                  jm.cache_batch_axes(S))
    layers = ttransformer._layers(plan, tm.cfg)
    want = []
    for g in range(plan.n_groups):
        want += [("inner", (g, i), (g, i), "ssm")
                 for i in range(plan.inner_per_group)]
        want.append(("outer", (), (g,), "attn"))
    want += [("rem", (i,), (i,), "ssm") for i in range(plan.remainder)]
    assert [(la.stack, la.index, la.cache_index, la.kind)
            for la in layers] == want
    assert {la.ffn for la in layers if la.kind == "attn"} == {"mlp"}
    assert {la.window for la in layers} == {0}


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", list(OVERRIDES))
def test_hybrid_forward_matches_jax(name, use_pallas):
    """``LM.hidden`` (train and prefill), ``prefill``'s last-position
    logits and every cache leaf, and ``loss`` with a CE chunk that splits
    the sequence."""
    jm, jp, tm, tp = pair(OVERRIDES[name], use_pallas)
    toks = _tokens(7)
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, {"tokens": toks}
    for mode in ("train", "prefill"):
        jx, _, jc = jax.jit(lambda p, b, m=mode: jm.hidden(p, b, m))(
            jp, batch_j)
        tx, aux, tc = tm.hidden(tp, batch_t, mode)
        assert aux == {}
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL,
                                   rtol=ATOL)
        if mode == "prefill":
            assert_trees_close(convert.cache_to_numpy(tc), jc, ATOL)
        else:
            assert tc is None and jc is None
    jl, jc = jax.jit(jm.prefill)(jp, batch_j)
    tl, tc = tm.prefill(tp, batch_t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    assert_trees_close(convert.cache_to_numpy(tc), jc, ATOL)
    jm8 = type(jm)(jm.cfg, jm.knobs.with_(ce_chunk=8))
    tm8 = LM(tm.cfg, tm.knobs.with_(ce_chunk=8), device="cpu")
    jloss, _ = jax.jit(jm8.loss)(jp, batch_j)
    tloss, tmet = tm8.loss(tp, batch_t)
    assert abs(float(tloss) - float(jloss)) < LOSS_TOL
    assert set(tmet) == {"ce_loss", "loss"}


def _pad_kv(caches, extra):
    """A prefill's caches (numpy) with room for ``extra`` decode positions:
    the shared block's K/V stripes grow along the sequence axis (zeros),
    the SSM leaves do not depend on the length."""
    out = jax.tree.map(lambda a: a, caches)
    outer = out["groups"]["outer"]
    for key in ("k", "v"):
        outer[key] = np.pad(outer[key], ((0, 0), (0, 0), (0, extra), (0, 0),
                                         (0, 0)))
    return out


@pytest.mark.parametrize("start", ["zero", "prefill"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_hybrid_decode_matches_jax(use_pallas, start):
    """Six decode steps, logits and every cache leaf after each, from a
    zero cache (positions 0..5, both slots in lockstep) and from a
    prefill's caches (ragged positions)."""
    jm, jp, tm, tp = pair(OVERRIDES["smoke"], use_pallas)
    toks = _tokens(8, s=16 + 6)
    if start == "zero":
        jc, tc = jm.init_cache(B, 16), tm.init_cache(B, 16)
        pos0 = np.zeros(B, np.int32)
    else:
        _, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :16])})
        _, tc = tm.prefill(tp, {"tokens": toks[:, :16]})
        jc = jax.tree.map(jnp.asarray, _pad_kv(jax.tree.map(np.asarray, jc),
                                               8))
        tc = convert.cache_from_jax(_pad_kv(convert.cache_to_numpy(tc), 8))
        # slot 1 starts two positions back: its last prompt rows rewritten
        pos0 = np.array([16, 14], np.int32)
    jstep = jax.jit(jm.decode_step)
    for i in range(6):
        pos = pos0 + i
        feed = toks[:, 16 + i:17 + i] if start == "prefill" \
            else toks[:, i:i + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(feed), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL, err_msg=f"step {i}")
    assert_trees_close(convert.cache_to_numpy(tc), jc, ATOL)


def test_hybrid_decode_reproduces_teacher_forced_logits():
    """Token-by-token decode from an empty cache reproduces the
    whole-sequence forward's logits at every position, within 2e-3 of the
    logits' scale (the SSM recurrence against the chunked scan)."""
    from repro_torch.models import layers as tlayers

    _, _, tm, tp = pair(OVERRIDES["rem"])
    toks = torch.from_numpy(_tokens(10, s=16))
    x, _, _ = tm.hidden(tp, {"tokens": toks}, "prefill")
    full = tlayers.unembed(tp["embed"], x)
    caches = tm.init_cache(B, 16)
    worst = 0.0
    for t in range(16):
        logits, caches = tm.decode_step(tp, caches, toks[:, t:t + 1], t)
        worst = max(worst, float((logits - full[:, t]).abs().max()))
    assert worst / float(full.abs().max()) < 2e-3, worst


@pytest.mark.parametrize("use_pallas", [False, True])
def test_head_dim_80_matches_jax(use_pallas):
    """zamba2's head_dim of 80 (2 heads, d_model 160) through the plain
    attention versions: prefill logits and caches, then four ragged decode
    steps from them, against both JAX routes."""
    jm, jp, tm, tp = pair(HD80, use_pallas)
    assert tm.cfg.head_dim == 80
    toks = _tokens(11, s=24)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :16])})
    tl, tc = tm.prefill(tp, {"tokens": toks[:, :16]})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    assert_trees_close(convert.cache_to_numpy(tc), jc, ATOL)
    jc = jax.tree.map(jnp.asarray, _pad_kv(jax.tree.map(np.asarray, jc), 8))
    tc = convert.cache_from_jax(_pad_kv(convert.cache_to_numpy(tc), 8))
    jstep = jax.jit(jm.decode_step)
    for i in range(4):
        pos = np.array([16 + i, 12 + i], np.int32)
        feed = toks[:, 16 + i:17 + i]
        jl, jc = jstep(jp, jc, jnp.asarray(feed), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL, err_msg=f"step {i}")


# ------------------------------------------------------------------ engines
ENGINE = dict(batch_slots=2, max_len=48)


def _trace(n=5, seed=17):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 64, size=int(rng.integers(1, 9))).astype(
        np.int32)) for i in range(n)]


def _serve(eng, req_cls, trace, max_new=6):
    for i, prompt in trace:
        eng.submit(req_cls(i, prompt.copy(), max_new_tokens=max_new))
    done = eng.run()
    assert len(done) == len(trace)
    return {r.req_id: list(r.output) for r in done}


_JAX_STREAMS = {}


def _jax_streams(mode):
    if mode not in _JAX_STREAMS:
        jm, jp, _, _ = pair(OVERRIDES["smoke"])
        eng = JServeEngine(jm, jp, JServeConfig(mode=mode, **ENGINE))
        _JAX_STREAMS[mode] = _serve(eng, JRequest, _trace())
    return _JAX_STREAMS[mode]


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_hybrid_engine_matches_jax_engine(mode):
    """Five token-fed requests through two slots (slots reset and reused):
    the greedy streams equal the JAX engine's; continuous equals wave."""
    _, _, tm, tp = pair(OVERRIDES["smoke"])
    eng = ServeEngine(tm, tp, ServeConfig(mode=mode, **ENGINE))
    assert not eng.chunked and eng._needs_reset
    assert _serve(eng, Request, _trace()) == _jax_streams(mode)
    assert _jax_streams("continuous") == _jax_streams(mode)


def test_hybrid_reused_slot_equals_a_fresh_engine():
    """The last request lands in a slot two others used; alone, in a fresh
    engine, it gives the same tokens: admission zeroes the slot's SSM
    leaves and its K/V stripes."""
    _, _, tm, tp = pair(OVERRIDES["rem"])
    trace = _trace(5, seed=23)
    busy = _serve(ServeEngine(tm, tp, ServeConfig(**ENGINE)), Request,
                  trace)
    solo = _serve(ServeEngine(tm, tp, ServeConfig(**ENGINE)), Request,
                  trace[-1:])
    assert solo[trace[-1][0]] == busy[trace[-1][0]]


def test_hybrid_admission_zeroes_every_leaf_of_the_slot():
    """Continuous admission zeroes the slot's conv windows, states and K/V
    stripes, and only that slot's; a new wave zeroes everything."""
    _, _, tm, tp = pair(OVERRIDES["rem"])
    eng = ServeEngine(tm, tp, ServeConfig(**ENGINE))
    axes = tm.cache_batch_axes(ENGINE["max_len"])
    for leaf in ttransformer.tree_leaves(eng.caches):
        leaf.fill_(1.0)
    eng.submit(Request(0, np.arange(3, dtype=np.int32), max_new_tokens=1))
    eng._admit_continuous()
    slot = next(s for s, r in enumerate(eng.active) if r is not None)
    for leaf, ax in zip(ttransformer.tree_leaves(eng.caches),
                        ttransformer.tree_leaves(axes)):
        assert not leaf.narrow(ax, slot, 1).any()
        assert bool((leaf.narrow(ax, 1 - slot, 1) == 1).all())
    wave = ServeEngine(tm, tp, ServeConfig(mode="wave", **ENGINE))
    for leaf in ttransformer.tree_leaves(wave.caches):
        leaf.fill_(1.0)
    wave.submit(Request(0, np.arange(3, dtype=np.int32), max_new_tokens=1))
    wave._admit_wave()
    assert not any(leaf.any()
                   for leaf in ttransformer.tree_leaves(wave.caches))


def test_hybrid_preemption_streams_unchanged():
    """``policy="priority"`` with preemption: high-priority requests arrive
    while low-priority ones hold both slots mid-prompt; every stream
    equals the run without preemption (the checkpoint carries the SSM
    state and the K/V stripes of the slot)."""
    _, _, tm, tp = pair(OVERRIDES["smoke"])
    rng = np.random.default_rng(7)
    low = [rng.integers(0, 64, size=n).astype(np.int32) for n in (14, 11)]
    high = [rng.integers(0, 64, size=n).astype(np.int32) for n in (5, 7)]

    def run(preempt):
        eng = ServeEngine(tm, tp, ServeConfig(preempt=preempt,
                                              policy="priority", **ENGINE))
        for i, p in enumerate(low):
            eng.submit(Request(i, p.copy(), max_new_tokens=8,
                               tenant="batch"))
        for _ in range(4):
            eng.step()
        for i, p in enumerate(high):
            eng.submit(Request(10 + i, p.copy(), max_new_tokens=5,
                               tenant="interactive", priority=5))
        done = eng.run()
        return {r.req_id: (list(r.output), r.preempt_count) for r in done}

    want, got = run(False), run(True)
    assert any(n for _, n in got.values())
    assert {i: o for i, (o, _) in got.items()} == \
        {i: o for i, (o, _) in want.items()}


def test_hybrid_checkpoint_round_trips_a_slot():
    """``copy_cache_out``/``copy_cache_in`` carry one slot's whole stripe
    of the mixed tree (conv, state, K/V) and nothing else."""
    _, _, tm, tp = pair(OVERRIDES["rem"])
    caches = tm.init_cache(B, 16)
    g = torch.Generator().manual_seed(1)
    for leaf in ttransformer.tree_leaves(caches):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    axes = tm.cache_batch_axes(16)
    snap = tm.copy_cache_out(caches, 1, axes)
    fresh = tm.init_cache(B, 16)
    tm.copy_cache_in(fresh, snap, 1, axes)
    for a, b, ax in zip(ttransformer.tree_leaves(fresh),
                        ttransformer.tree_leaves(caches),
                        ttransformer.tree_leaves(axes)):
        assert torch.equal(a.narrow(ax, 1, 1), b.narrow(ax, 1, 1))
        assert not a.narrow(ax, 0, 1).any()


# ---------------------------------------------------------------- refusals
def _raises_like_reference(jcall, tcall):
    """Both calls raise the same exception type with the same message."""
    with pytest.raises(Exception) as want:
        jcall()
    with pytest.raises(want.type) as got:
        tcall()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("what", ["init_cache_paged", "prefill_chunk",
                                  "paged_engine", "draft_k", "verify"])
def test_hybrid_refusals_follow_the_reference(what):
    jm, jp, tm, tp = pair(OVERRIDES["smoke"])
    assert not (tm.supports_chunked_prefill() or tm.supports_paged_cache()
                or tm.supports_speculative())
    if what == "init_cache_paged":
        msg = _raises_like_reference(lambda: jm.init_cache_paged(4, 8),
                                     lambda: tm.init_cache_paged(4, 8))
    elif what == "prefill_chunk":
        toks = np.zeros((1, 8), np.int32)
        msg = _raises_like_reference(
            lambda: jm.prefill_chunk_step(jp, jm.init_cache(1, 16),
                                          jnp.asarray(toks), 0, 0),
            lambda: tm.prefill_chunk_step(tp, tm.init_cache(1, 16), toks, 0,
                                          0))
    elif what == "paged_engine":
        msg = _raises_like_reference(
            lambda: JServeEngine(jm, jp, JServeConfig(cache="paged",
                                                      **ENGINE)),
            lambda: ServeEngine(tm, tp, ServeConfig(cache="paged",
                                                    **ENGINE)))
    elif what == "draft_k":
        msg = _raises_like_reference(
            lambda: JServeEngine(jm, jp, JServeConfig(draft_k=2, **ENGINE)),
            lambda: ServeEngine(tm, tp, ServeConfig(draft_k=2, **ENGINE)))
    else:
        with pytest.raises(NotImplementedError, match="one token") as e:
            tm.decode_step_spec(tp, tm.init_cache(B, 16),
                                torch.zeros((B, 2), dtype=torch.long), 0)
        msg = str(e.value)
    assert "hybrid" in msg and "ROADMAP" not in msg


def test_launcher_serves_zamba2(capsys):
    from repro_torch.launch import serve as launch

    for mode in ("continuous", "wave"):
        launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--requests", "5", "--max-new", "4", "--slots", "2",
                     "--mode", mode])
    assert capsys.readouterr().out.count("served 5 requests") == 2
