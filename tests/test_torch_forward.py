"""The port's whole-sequence forward held against the JAX package: the same
weights (built by the JAX ``LM.init`` and carried across with
``params_from_jax``) and the same numpy tokens must give the same prefill
logits and caches, the same loss, the same SSM block outputs and states,
and the same greedy stream after a prefill, for internlm2 (attention) and
mamba2 (SSM) at smoke size.  The JAX side runs both its routes: the XLA
path (``use_pallas=False``) and its Pallas kernels in interpret mode
(``use_pallas=True``); the port's CPU path runs the plain versions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.runtime.steps import (make_prefill_step,  # noqa: E402
                                       make_serve_step)

# f32 end to end on both sides.  Logits, caches and SSM states go through
# 2 layers and the unembedding with sums in other orders (and, for mamba2,
# the chunked scan's exp/cumsum), which stays inside 1e-4.
ATOL = 1e-4
LOSS_TOL = 2e-4  # the reference's own bound (tests/test_pallas_integration)
ARCHS = ["internlm2-1.8b", "mamba2-1.3b"]
B, S = 2, 32  # mamba2 smoke: 4 chunks of 8


# The SSM projections at 10x their init scale (0.02): at the init's scale
# an SSM block adds ~1e-6 to the residual stream, below any tolerance here,
# so a broken SSD would pass unseen; at 10x its states and outputs are
# O(0.1-1), as trained weights make them, and removing the SSD diagonal
# moves the logits by ~5e-3 while the port stays ~2e-7 from JAX.
SSM_BOOST = 10.0


def boost_ssm(params):
    """A copy of a JAX params tree with every SSM block's in_proj and
    out_proj scaled by SSM_BOOST (numpy leaves)."""
    params = jax.tree.map(np.asarray, params)
    blocks = params["blocks"]["stack"] if "blocks" in params else None
    ssm = blocks["ssm"] if blocks is not None else params
    for key in ("in_proj", "out_proj"):
        ssm[key] = ssm[key] * SSM_BOOST
    return params


def _pair(arch, use_pallas=False):
    """(JAX model, JAX params, port model, port params): the shared tiny
    config of the serving tests (2 layers, vocab 64, f32 caches); mamba2's
    SSM projections boosted (``SSM_BOOST``)."""
    jm, jp = tiny_lm(arch)
    if arch == "mamba2-1.3b":
        jp = jax.tree.map(jnp.asarray, boost_ssm(jp))
    if use_pallas:
        jm = type(jm)(jm.cfg, jm.knobs.with_(use_pallas=True))
    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=2,
                              vocab_size=64)
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _tokens(seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, 64, size=(b, s)).astype(
        np.int32)


def _ssm_params(seed):
    """One mamba2 smoke SSM block's params from the JAX init (projections
    boosted), both sides."""
    cfg = get_config("mamba2-1.3b", smoke=True)
    jp = boost_ssm(jssm.ssm_init(jax.random.PRNGKey(seed), cfg.d_model,
                                 cfg.ssm))
    return (cfg, jax.tree.map(jnp.asarray, jp),
            convert.params_from_jax(jp))


@pytest.mark.parametrize("s", [32, 8, 2])
def test_ssm_forward_matches_jax(s):
    """y, the conv tail (raw xBC rows, zero-padded when S < 3) and the final
    state; S = 8 is one chunk, S = 2 a chunk shorter than chunk_size."""
    cfg, jp, tp = _ssm_params(1)
    x = np.random.default_rng(2).normal(size=(B, s, cfg.d_model)).astype(
        np.float32)
    jy, jc = jssm.ssm_forward(jp, jnp.asarray(x), cfg.d_model, cfg.ssm,
                              return_state=True)
    ty, tc = tssm.ssm_forward(tp, torch.from_numpy(x), cfg.d_model, cfg.ssm,
                              return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    for key in ("conv", "state"):
        assert tc[key].shape == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ssm_forward_from_initial_state_matches_jax(use_pallas):
    cfg, jp, tp = _ssm_params(3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32)
    nh = cfg.ssm.n_heads(cfg.d_model)
    s0 = rng.normal(size=(B, nh, cfg.ssm.head_dim, cfg.ssm.d_state)).astype(
        np.float32)
    jy = jssm.ssm_forward(jp, jnp.asarray(x), cfg.d_model, cfg.ssm,
                          initial_state=jnp.asarray(s0),
                          use_pallas=use_pallas)
    ty = tssm.ssm_forward(tp, torch.from_numpy(x), cfg.d_model, cfg.ssm,
                          initial_state=torch.from_numpy(s0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)


def test_ssm_decode_step_matches_jax():
    """Three tokens through the recurrence from a random cache: outputs,
    the conv window and the state, updated in place."""
    cfg, jp, tp = _ssm_params(5)
    rng = np.random.default_rng(6)
    jcache = jssm.ssm_init_cache(B, cfg.d_model, cfg.ssm, jnp.float32)
    filled = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in jcache.items()}
    jcache = {k: jnp.asarray(v) for k, v in filled.items()}
    tcache = convert.cache_from_jax(filled)
    conv_before = tcache["conv"]
    for t in range(3):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jssm.ssm_decode_step(jp, jcache, jnp.asarray(x),
                                          cfg.d_model, cfg.ssm)
        ty, tcache = tssm.ssm_decode_step(tp, tcache, torch.from_numpy(x),
                                          cfg.d_model, cfg.ssm)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=ATOL)
    assert tcache["conv"] is conv_before  # written in place
    for key in ("conv", "state"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=ATOL,
                                   rtol=ATOL)


def test_ssm_init_distributions():
    """The port's own init draws the reference's ranges: softplus(dt_bias)
    in [1e-3, 1e-1], A = -exp(A_log) in [-16, -1], D = 1, f32 whatever
    the param dtype, and conv_w at scale 0.2."""
    cfg = get_config("mamba2-1.3b")
    p = tssm.ssm_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.ssm,
                      dtype=torch.bfloat16)
    nh = cfg.ssm.n_heads(cfg.d_model)
    for key in ("A_log", "dt_bias", "D"):
        assert p[key].dtype == torch.float32 and p[key].shape == (nh,)
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) <= float(dt.max()) <= 0.1 * 1.001
    a = torch.exp(p["A_log"])
    assert 1.0 <= float(a.min()) <= float(a.max()) <= 16.0
    assert bool((p["D"] == 1).all())
    assert p["in_proj"].dtype == torch.bfloat16
    std = float(p["conv_w"].float().std())
    assert 0.18 < std < 0.22, std


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, use_pallas):
    """Last-position logits and every layer's cache (K/V, or the SSM conv
    window and state) of ``LM.prefill``."""
    jm, jp, tm, tp = _pair(arch, use_pallas)
    toks = _tokens(7)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    got = convert.cache_to_numpy(tc)
    assert sorted(got["stack"]) == sorted(jc["stack"])
    for key, want in jc["stack"].items():
        assert got["stack"][key].shape == want.shape
        np.testing.assert_allclose(got["stack"][key], np.asarray(want),
                                   atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch, use_pallas):
    """Forward next-token CE, with a CE chunk that splits the sequence."""
    jm, jp, tm, tp = _pair(arch, use_pallas)
    jm = type(jm)(jm.cfg, jm.knobs.with_(ce_chunk=8))
    tm = LM(tm.cfg, tm.knobs.with_(ce_chunk=8), device="cpu")
    toks = _tokens(8)
    jl, jmet = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks)})
    tl, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) < LOSS_TOL, (float(tl), float(jl))
    assert float(tmet["ce_loss"]) == float(tl) == float(tmet["loss"])


def _pad_caches(caches, arch, extra):
    """Room for ``extra`` decode positions after a prefill: attention K/V
    stripes grow along the sequence axis (zeros); SSM caches do not
    depend on the length."""
    if arch == "mamba2-1.3b":
        return caches
    return {"stack": {k: np.pad(v, ((0, 0), (0, 0), (0, extra), (0, 0),
                                    (0, 0)))
                      for k, v in caches["stack"].items()}}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_greedy_decode_matches_jax(arch):
    """The prefill step's first tokens, then greedy decode from its caches:
    the same token stream as the JAX package's steps."""
    from repro.runtime.steps import make_prefill_step as jmake_prefill
    from repro.runtime.steps import make_serve_step as jmake_serve

    jm, jp, tm, tp = _pair(arch)
    toks, n = _tokens(9, s=16), 6
    jt, jc = jax.jit(jmake_prefill(jm))(jp, {"tokens": jnp.asarray(toks)})
    tt, tc = make_prefill_step(tm)(tp, {"tokens": torch.from_numpy(toks)})
    assert tt.dtype == torch.int32 and tt.shape == (B, 1)
    jc = jax.tree.map(jnp.asarray, _pad_caches(
        jax.tree.map(np.asarray, jc), arch, n))
    tc = convert.cache_from_jax(_pad_caches(convert.cache_to_numpy(tc),
                                            arch, n))
    jstep, tstep = jax.jit(jmake_serve(jm)), make_serve_step(tm)
    jstream, tstream = [np.asarray(jt)], [tt.numpy()]
    for i in range(n):
        pos = 16 + i
        jt, jc = jstep(jp, jc, jt, jnp.int32(pos))
        tt, tc = tstep(tp, tc, tt, pos)
        jstream.append(np.asarray(jt))
        tstream.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(tstream, 1),
                                  np.concatenate(jstream, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reproduces_teacher_forced_logits(arch):
    """Token-by-token decode from an empty cache reproduces the
    whole-sequence forward's logits at every position (the port's own
    ``scripts/check_decode.py``), within 2e-3 of the logits' scale."""
    _, _, tm, tp = _pair(arch)
    toks = torch.from_numpy(_tokens(10, s=16))
    x, _, _ = tm.hidden(tp, {"tokens": toks}, "prefill")
    full = tlayers.unembed(tp["embed"], x)  # (B,S,V)
    caches = tm.init_cache(B, 16)
    worst = 0.0
    for t in range(16):
        logits, caches = tm.decode_step(tp, caches, toks[:, t:t + 1], t)
        worst = max(worst, float((logits - full[:, t]).abs().max()))
    assert worst / float(full.abs().max()) < 2e-3, worst


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_ce_loss_matches_jax(masked):
    """Tied and untied heads, a partial mask, chunks that split S."""
    from repro.models import layers as jlayers

    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 12, 8)).astype(np.float32)
    emb = {"table": rng.normal(size=(20, 8)).astype(np.float32)}
    if masked:
        emb["head"] = rng.normal(size=(20, 8)).astype(np.float32)
    targets = rng.integers(0, 20, size=(2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.3 if masked
            else np.ones((2, 12))).astype(np.float32)
    want = jlayers.chunked_ce_loss({k: jnp.asarray(v) for k, v in
                                    emb.items()}, jnp.asarray(x),
                                   jnp.asarray(targets), jnp.asarray(mask),
                                   chunk=4)
    got = tlayers.chunked_ce_loss({k: torch.from_numpy(v) for k, v in
                                   emb.items()}, torch.from_numpy(x),
                                  torch.from_numpy(targets),
                                  torch.from_numpy(mask), chunk=4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_ssm_plan_capabilities_follow_reference():
    """SSM plans: no chunked prefill, no paged pool, no speculation, no
    multi-token decode; the forward takes only "train" and "prefill"."""
    from repro_torch.models.transformer import apply_blocks

    _, _, tm, tp = _pair("mamba2-1.3b")
    assert not (tm.supports_chunked_prefill() or tm.supports_paged_cache()
                or tm.supports_speculative())
    with pytest.raises(NotImplementedError):
        tm.init_cache_paged(4, 8)
    with pytest.raises(NotImplementedError, match="one token"):
        tm.decode_step(tp, tm.init_cache(B, 8),
                       torch.zeros((B, 2), dtype=torch.long), 0)
    with pytest.raises(ValueError, match="mode"):
        apply_blocks(tp["blocks"], torch.zeros((1, 8, tm.cfg.d_model)),
                     torch.zeros((1, 8)), cfg=tm.cfg, knobs=tm.knobs,
                     mode="decode")
    assert tm.cache_batch_axes(8) == {"stack": {"conv": 1, "state": 1}}
