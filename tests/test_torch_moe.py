"""The MoE FFN in the port, on the CPU, against the JAX package: ``moe_ffn``
(train and eval capacity, a case that drops, a decode-shaped call that
never drops, a dispatch chunk shorter than the sequence, the aux losses),
``moe_ffn_ref``, mixtral and qwen3-moe through the model (prefill logits
and caches, ragged decode, ``LM.loss`` with the aux losses), mixtral's
greedy engine streams equal to the JAX engine's (dense continuous, wave,
paged with a prefix hit, int8 paged), speculative and preempted streams
bitwise the port's plain ones, the fixed-shape rule (a token's bits do not
depend on another slot's routing), and the reference's verify block,
which routes its T rows as one dispatch chunk and drops where the
one-token tick does not."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from test_torch_grouped import (ATOL, check_engine_matches_jax,  # noqa: E402
                                check_forward, check_preemption_unchanged,
                                check_spec_bitwise_plain, pair)

MIXTRAL, QWEN = "mixtral-8x7b", "qwen3-moe-235b-a22b"
D = 16


def _params(cfg, seed=0):
    """Random MoE weights (numpy), scaled so that routing and expert
    outputs are O(1)."""
    rng = np.random.default_rng(seed)
    e, f = cfg.num_experts, cfg.d_ff
    return {"router": rng.normal(size=(D, e)).astype(np.float32),
            "w_gate": (rng.normal(size=(e, D, f)) / 4).astype(np.float32),
            "w_up": (rng.normal(size=(e, D, f)) / 4).astype(np.float32),
            "w_down": (rng.normal(size=(e, f, D)) / 4).astype(np.float32)}


def _both(cfg_kw, shape, train, seed=0):
    """(port out, port aux, JAX out, JAX aux) on the same numpy inputs."""
    tcfg = MoEConfig(**cfg_kw)
    jcfg = JMoEConfig(**cfg_kw)
    p = _params(tcfg, seed)
    x = np.random.default_rng(seed + 1).normal(size=shape).astype(
        np.float32)
    tout, taux = tmoe.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), tcfg, train=train)
    jout, jaux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jcfg, train=train)
    return tout, taux, np.asarray(jout), {k: float(v)
                                          for k, v in jaux.items()}


def _assert_match(tout, taux, jout, jaux):
    np.testing.assert_allclose(tout.numpy(), jout, atol=ATOL, rtol=ATOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), jaux[k], atol=ATOL,
                                   rtol=ATOL, err_msg=k)


BASE = dict(num_experts=8, experts_per_token=2, d_ff=24, dispatch_chunk=16)
CASES = {
    # (config, x shape, train)
    "train": (BASE, (2, 32, D), True),
    "eval": (BASE, (2, 32, D), False),
    "chunk_lt_seq": (dict(BASE, dispatch_chunk=8), (2, 40, D), False),
    "top8_of_16": (dict(BASE, num_experts=16, experts_per_token=8),
                   (3, 16, D), True),
    "decode": (BASE, (4, 1, D), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case):
    cfg_kw, shape, train = CASES[case]
    tout, taux, jout, jaux = _both(cfg_kw, shape, train)
    _assert_match(tout, taux, jout, jaux)
    if case == "decode":  # one token: capacity k, never a drop
        assert jaux["moe_drop_frac"] == 0.0 == float(taux["moe_drop_frac"])


@pytest.mark.parametrize("cf", [0.5, 0.25])
def test_moe_ffn_drops_as_jax_does(cf):
    """A lowered capacity factor drops choices (JAX's drop fraction > 0):
    the same choices drop, with their weights, nothing renormalised."""
    cfg_kw = dict(BASE, capacity_factor=cf)
    tout, taux, jout, jaux = _both(cfg_kw, (2, 32, D), True, seed=3)
    assert jaux["moe_drop_frac"] > 0
    _assert_match(tout, taux, jout, jaux)


def test_moe_capacity_matches_jax():
    for chunk in (1, 4, 16, 512):
        for train in (True, False):
            for e, k in ((8, 2), (128, 8), (4, 2)):
                kw = dict(num_experts=e, experts_per_token=k, d_ff=8)
                assert tmoe._capacity(chunk, MoEConfig(**kw), train) == \
                    jmoe._capacity(chunk, JMoEConfig(**kw), train)


def test_moe_ffn_ref_matches_jax_and_the_dispatch_without_drops():
    """The dense oracle against JAX's, and ``moe_ffn`` at a capacity that
    never binds against the oracle."""
    cfg_kw = dict(BASE, eval_capacity_factor=100.0)
    tcfg = MoEConfig(**cfg_kw)
    p = _params(tcfg, 5)
    x = np.random.default_rng(6).normal(size=(2, 16, D)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ref = tmoe.moe_ffn_ref(tp, torch.from_numpy(x), tcfg)
    want = jmoe.moe_ffn_ref({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), JMoEConfig(**cfg_kw))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    out, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, train=False)
    assert float(aux["moe_drop_frac"]) == 0.0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL,
                               rtol=ATOL)


def test_moe_token_bits_do_not_depend_on_other_slots_routing():
    """A decode tick's (B, 1, d) call: changing the other slots' inputs
    (and so their experts) leaves slot 0's output bitwise the same; the
    products' shapes depend on (B, n, E, C) only."""
    tcfg = MoEConfig(**BASE)
    tp = {k: torch.from_numpy(v) for k, v in _params(tcfg, 1).items()}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 1, D)).astype(np.float32))
    out, _ = tmoe.moe_ffn(tp, x, tcfg, train=False)
    for seed in range(3):
        y = x.clone()
        y[1:] = torch.from_numpy(np.random.default_rng(10 + seed).normal(
            size=(3, 1, D)).astype(np.float32))
        assert torch.equal(tmoe.moe_ffn(tp, y, tcfg, train=False)[0][0],
                           out[0])


def test_moe_ffn_refuses_a_ragged_dispatch_chunk():
    tcfg = MoEConfig(**BASE)
    tp = {k: torch.from_numpy(v) for k, v in _params(tcfg).items()}
    with pytest.raises(ValueError, match="dispatch chunk"):
        tmoe.moe_ffn(tp, torch.zeros((1, 20, D)), tcfg)


def test_moe_init_keeps_the_router_f32():
    cfg = MoEConfig(**BASE)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), D, cfg,
                      dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == torch.bfloat16
    assert tuple(p["w_down"].shape) == (8, 24, D)


# --------------------------------------------------------- through the model
@pytest.mark.parametrize("arch", [MIXTRAL, QWEN])
def test_moe_model_matches_jax(arch):
    """Prefill logits and caches, ragged decode and ``LM.loss`` with the
    aux losses (mean over the MoE layers, added with the reference's
    coefficients); 80 tokens pass mixtral's smoke window of 64."""
    met = check_forward(arch, s=80)
    assert {"moe_lb_loss", "moe_z_loss", "moe_drop_frac"} <= set(met)
    assert float(met["loss"]) > float(met["ce_loss"])


@pytest.mark.parametrize("layout", ["dense", "wave", "paged", "int8"])
def test_moe_engine_matches_jax_engine(layout):
    check_engine_matches_jax(MIXTRAL, layout)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_moe_spec_engine_bitwise_plain(layout):
    check_spec_bitwise_plain(MIXTRAL, layout)


def test_moe_spec_streams_equal_jax_spec_engine():
    """The JAX speculative engine's streams equal the port's on the smoke
    config, whose verify capacity never binds (4 experts, top-2: the
    capacity of a 4-row block is max(2, int(4 * 2 * 2.0 / 4)) = 4, and a
    block routes at most 4 choices to an expert); where it binds the
    reference's verify block drops (the next test)."""
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine
    from test_torch_grouped import ENGINE, serve

    jm, jp, tm, tp = pair(MIXTRAL)
    rng = np.random.default_rng(9)
    trace = [(i, np.tile(rng.integers(0, 64, size=6).astype(np.int32), 7))
             for i in range(3)]
    want = serve(JServeEngine(jm, jp, JServeConfig(draft_k=3, **ENGINE)),
                 JRequest, trace, max_new=12)
    assert serve(ServeEngine(tm, tp, ServeConfig(draft_k=3, **ENGINE)),
                 Request, trace, max_new=12) == want


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_moe_preemption_streams_unchanged(layout):
    check_preemption_unchanged(MIXTRAL, layout)


def test_reference_verify_block_drops_where_the_port_does_not():
    """With 8 experts top-2 the reference's 4-row verify block has capacity
    max(2, int(4 * 2 * 2.0 / 8)) = 2 per expert and slot, so a third row
    routed to one expert is dropped: JAX's ``decode_step_spec`` logits
    differ from its four sequential steps.  The port routes each row in
    the one-token shape (capacity k per token), so its verify logits are
    bitwise its sequential steps and match JAX's sequential ones."""
    from conftest import tiny_lm
    from repro.configs import get_config as jget_config
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import LM, RuntimeKnobs

    jmoe_cfg = dataclasses.replace(jget_config(MIXTRAL, smoke=True).moe,
                                   num_experts=8)
    jm, jp = tiny_lm(MIXTRAL, moe=jmoe_cfg)
    cfg = get_config(MIXTRAL, smoke=True)
    cfg = dataclasses.replace(cfg, num_layers=2, vocab_size=64,
                              moe=dataclasses.replace(cfg.moe,
                                                      num_experts=8))
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    b, t, s = 2, 4, 32
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 64, size=(b, t)).astype(np.int32)
    pos = np.array([3, 11], np.int32)
    jseq, jc = [], jm.init_cache(b, s)
    tseq, tc = [], tm.init_cache(b, s)
    for i in range(t):
        lg, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos + i))
        jseq.append(np.asarray(lg))
        lg, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                pos + i)
        tseq.append(lg)
    jseq, tseq = np.stack(jseq, 1), torch.stack(tseq, 1)
    jspec, _ = jm.decode_step_spec(jp, jm.init_cache(b, s),
                                   jnp.asarray(toks), jnp.asarray(pos))
    tspec, _ = tm.decode_step_spec(tp, tm.init_cache(b, s),
                                   torch.from_numpy(toks), pos)
    assert np.abs(np.asarray(jspec) - jseq).max() > 1e-3  # JAX drops
    assert torch.equal(tspec, tseq)
    np.testing.assert_allclose(tspec.numpy(), jseq, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("name", ["", "int8"])
def test_prefill_chunk_null_page_takes_the_last_padded_block(name):
    """A prompt chunk whose last blocks lie past the slot's reservation
    writes them all to the null page 0, which must end as the last of them
    on every device (the reference's write, on the CPU): the padded rows
    read it back, and through an MoE FFN's shared capacity they reach the
    real rows, so a write that keeps any one of them made a paged MoE
    engine's tokens differ from run to run on the card."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    rng = np.random.default_rng(4)
    ps, kv, d = 4, 2, 8
    pools = rng.normal(size=(8, ps, kv, d)).astype(np.float32)
    new = rng.normal(size=(1, 4 * ps, kv, d)).astype(np.float32)
    table = np.array([[3, 5, 0, 0, 0, 0]], np.int32)  # blocks 2.. unmapped
    if name:
        kq, ks = tattn.quantize_kv(torch.from_numpy(new), torch.int8)
        got = torch.zeros((8, ps, kv, d), dtype=torch.int8)
        got_s = torch.zeros((8, ps, kv, 1))
        tattn.paged_prefill_chunk_update_quant(
            got, got.clone(), got_s, got_s.clone(), torch.from_numpy(new),
            torch.from_numpy(new), 0, 4, torch.from_numpy(table), ps)
        want = kq[0].reshape(4, ps, kv, d)
        assert torch.equal(got[0], want[3]) and torch.equal(got[5], want[0])
        assert torch.equal(got_s[0], ks[0].reshape(4, ps, kv, 1)[3])
        return
    got = torch.from_numpy(pools.copy())
    tattn.paged_prefill_chunk_update(got, got.clone(), torch.from_numpy(new),
                                     torch.from_numpy(new), 0, 4,
                                     torch.from_numpy(table), ps)
    blocks = new[0].reshape(4, ps, kv, d)
    np.testing.assert_array_equal(got[0].numpy(), blocks[3])
    np.testing.assert_array_equal(got[5].numpy(), blocks[0])
    jk, _ = jattn.paged_prefill_chunk_update(
        jnp.asarray(pools), jnp.asarray(pools), jnp.asarray(new),
        jnp.asarray(new), 0, 4, jnp.asarray(table), ps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jk))


# ------------------------------------------------- a capacity that binds
# 8 experts, top-2, at the reference's eval capacity factor lowered to 1.0:
# a dispatch chunk of c tokens keeps max(2, int(c * 2 * 1.0 / 8)) = c / 4
# choices per expert, the average load, so any imbalance drops choices
BINDING = dict(num_experts=8, experts_per_token=2, d_ff=32,
               dispatch_chunk=16, eval_capacity_factor=1.0)


def _binding_pair():
    """(JAX model, JAX params, port model, port params): mixtral's smoke
    config with the binding MoE."""
    from conftest import tiny_lm
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import LM, RuntimeKnobs

    jm, jp = tiny_lm(MIXTRAL, moe=JMoEConfig(**BINDING))
    cfg = dataclasses.replace(get_config(MIXTRAL, smoke=True), num_layers=2,
                              vocab_size=64, moe=MoEConfig(**BINDING))
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    return jm, jp, tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def test_binding_capacity_prefill_matches_jax():
    """Whole-prompt prefill of 3 dispatch chunks under a capacity that
    drops a share of the choices: the last-position logits, every cache
    leaf and the drop fraction equal the reference's within ATOL."""
    from repro_torch import convert

    jm, jp, tm, tp = _binding_pair()
    toks = np.random.default_rng(4).integers(0, 64, size=(2, 48)).astype(
        np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    for got, want in zip(jax.tree.leaves(convert.cache_to_numpy(tc)),
                         jax.tree.leaves(jc)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   rtol=ATOL)
    _, jaux, _ = jax.jit(lambda p, b: jm.hidden(p, b, "prefill"))(
        jp, {"tokens": jnp.asarray(toks)})
    _, taux, _ = tm.hidden(tp, {"tokens": toks}, "prefill")
    drop = float(taux["moe_drop_frac"])
    assert drop > 0.05  # the capacity binds
    assert drop == pytest.approx(float(jaux["moe_drop_frac"]), abs=1e-6)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_binding_capacity_engine_matches_jax_engine(layout):
    """Greedy streams, dense and paged, equal to the JAX engine's where the
    capacity binds: prompts of 13, 29, 37, 22 and 5 tokens are no whole
    number of the engine's 8-token prefill chunks (each one dispatch chunk
    of capacity 2), so the padded rows of a last chunk share its capacity
    with the real ones, as in the reference."""
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine
    from test_torch_grouped import ENGINE, LAYOUTS, serve

    jm, jp, tm, tp = _binding_pair()
    rng = np.random.default_rng(13)
    trace = [(i, rng.integers(0, 64, size=n).astype(np.int32))
             for i, n in enumerate((13, 29, 37, 22, 5))]
    config = dict(ENGINE, **LAYOUTS[layout])
    want = serve(JServeEngine(jm, jp, JServeConfig(**config)), JRequest,
                 trace)
    assert serve(ServeEngine(tm, tp, ServeConfig(**config)), Request,
                 trace) == want
