"""The port's model held against the JAX model: the same weights (built by
the JAX ``LM.init`` and carried across with ``params_from_jax``) and the
same numpy inputs must give the same logits and caches."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

# f32 end to end on both sides; the frameworks sum in different orders
# through 2 layers and the unembedding, which stays well inside 1e-4.
ATOL = 1e-4


def _pair(**knobs):
    """(JAX model, JAX params, port model, port params) over the tiny
    internlm2 config the JAX serving tests use."""
    jm, jp = tiny_lm()
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32, **knobs),
            device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _filled_caches(jm, tm, b, s, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda a: a.shape, jm.init_cache(b, s))
    filled = jax.tree.map(
        lambda shp: rng.normal(size=shp).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    jc = jax.tree.map(jnp.asarray, filled)
    tc = convert.cache_from_jax(filled)
    assert tc["stack"]["k"].shape == tm.init_cache(b, s)["stack"]["k"].shape
    return jc, tc


def test_params_keep_stacked_head_explicit_layout():
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    a = tp["blocks"]["stack"]["attn"]
    assert a["wq"].shape == (2, cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert a["wk"].shape == (2, cfg.d_model, cfg.num_kv_heads, cfg.head_dim)
    assert a["wo"].shape == (2, cfg.num_heads, cfg.head_dim, cfg.d_model)
    own = tm.init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, tp))


@pytest.mark.parametrize("splits", [1, 2])
def test_decode_step_matches_jax(splits):
    """Ragged positions with a parked slot (-1) and the last row (S-1)."""
    jm, jp, tm, tp = _pair(decode_splits=splits)
    b, s = 4, 32
    jc, tc = _filled_caches(jm, tm, b, s, seed=1)
    toks = np.random.default_rng(2).integers(0, 64, size=(b, 1))
    pos = np.array([-1, 0, 13, s - 1], np.int32)
    jl, jc2 = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(toks, jnp.int32),
                                      jnp.asarray(pos))
    tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(toks), pos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    got = convert.cache_to_numpy(tc2)
    for key in ("k", "v"):
        want = np.asarray(jc2["stack"][key])
        # live slots agree everywhere; the parked slot's don't-care write
        # lands on row 0 in the port and on row S-1 under jax >= 0.5,
        # which wraps negative update indices (see ROADMAP.md, faults)
        np.testing.assert_allclose(got["stack"][key][:, 1:], want[:, 1:],
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(got["stack"][key][:, 0, 1:s - 1],
                                   want[:, 0, 1:s - 1], atol=ATOL, rtol=ATOL)


def test_prefill_chunk_step_matches_jax():
    jm, jp, tm, tp = _pair()
    b, s, c = 2, 32, 8
    jc, tc = _filled_caches(jm, tm, b, s, seed=4)
    prompt = np.random.default_rng(5).integers(0, 64, size=(1, 2 * c))
    jstep = jax.jit(jm.prefill_chunk_step)
    for ci in range(2):
        chunk = prompt[:, ci * c:(ci + 1) * c]
        jl, jc = jstep(jp, jc, jnp.asarray(chunk, jnp.int32), jnp.int32(1),
                       jnp.int32(ci * c))
        tl, tc = tm.prefill_chunk_step(tp, tc, torch.from_numpy(chunk), 1,
                                       ci * c)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL)
    got = convert.cache_to_numpy(tc)
    for key in ("k", "v"):
        np.testing.assert_allclose(got["stack"][key],
                                   np.asarray(jc["stack"][key]),
                                   atol=ATOL, rtol=ATOL)


def test_cache_update_clamps_negative_pos_to_row_zero():
    """The reference's documented contract (repro/models/attention.py
    ``cache_update``): an out-of-range position clamps into [0, S-1], so
    a parked slot (pos -1) writes row 0 -- never row S-1, where a torch
    [-1] index would write.  Past the end both frameworks clamp to S-1."""
    from repro.models import attention as jattn

    rng = np.random.default_rng(6)
    kc = rng.normal(size=(2, 8, 1, 4)).astype(np.float32)
    new = rng.normal(size=(2, 1, 1, 4)).astype(np.float32)
    tk = torch.from_numpy(kc.copy())
    tattn.cache_update(tk, tk.clone(), torch.from_numpy(new),
                       torch.from_numpy(new), torch.tensor([-1, 8]))
    np.testing.assert_array_equal(tk[0, 0].numpy(), new[0, 0])
    np.testing.assert_array_equal(tk[0, 1:].numpy(), kc[0, 1:])
    np.testing.assert_array_equal(tk[1, 7].numpy(), new[1, 0])
    np.testing.assert_array_equal(tk[1, :7].numpy(), kc[1, :7])
    # in-range and past-the-end positions agree with JAX exactly
    pos = np.array([3, 8], np.int32)
    jk, _ = jattn.cache_update(jnp.asarray(kc), jnp.asarray(kc),
                               jnp.asarray(new), jnp.asarray(new),
                               jnp.asarray(pos))
    tk = torch.from_numpy(kc.copy())
    tattn.cache_update(tk, tk.clone(), torch.from_numpy(new),
                       torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_cache_update_multi_clips_each_row():
    from repro.models import attention as jattn

    rng = np.random.default_rng(7)
    kc = rng.normal(size=(2, 8, 1, 4)).astype(np.float32)
    new = rng.normal(size=(2, 3, 1, 4)).astype(np.float32)
    pos = np.array([-2, 6], np.int32)
    jk, _ = jattn.cache_update_multi(jnp.asarray(kc), jnp.asarray(kc),
                                     jnp.asarray(new), jnp.asarray(new),
                                     jnp.asarray(pos))
    tk = torch.from_numpy(kc.copy())
    tattn.cache_update_multi(tk, tk.clone(), torch.from_numpy(new),
                             torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("t", [1, 3])
def test_plain_decode_attention_matches_jax(t):
    """``decode_attention_xla`` (model layout, ragged pos with a parked
    slot, T > 1 verify rows, a window)."""
    from repro.models import attention as jattn

    rng = np.random.default_rng(10)
    q = rng.normal(size=(3, t, 4, 16)).astype(np.float32)
    k = rng.normal(size=(3, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 32, 2, 16)).astype(np.float32)
    pos = np.array([-1, 7, 31], np.int32)
    want = jattn.decode_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(pos),
                                      window=6)
    got = tattn.decode_attention_xla(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(pos), window=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("window", [0, 6])
def test_chunked_attention_matches_jax(window):
    from repro.models import attention as jattn

    rng = np.random.default_rng(8)
    q = rng.normal(size=(1, 8, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 32, 2, 16)).astype(np.float32)
    want = jattn.flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), window=window,
                                     q_chunk=4, q_offset=12)
    got = tattn.flash_attention_xla(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), window=window,
                                    q_chunk=4, q_offset=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_layers_match_jax(gated):
    """rmsnorm, half-split RoPE and both MLP forms (GELU is the tanh
    approximation, as jax.nn.gelu)."""
    from repro.models import layers as jlayers

    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    scale = rng.normal(size=(8,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                        torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    xr = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    positions = np.arange(5)[None].repeat(2, 0) + np.array([[0], [100]])
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(xr), torch.from_numpy(positions),
                           1e4).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(xr),
                                      jnp.asarray(positions), 1e4)),
        atol=1e-5, rtol=1e-5)
    w = {name: rng.normal(size=shp).astype(np.float32) * 0.3
         for name, shp in (("w_gate", (8, 16)), ("w_up", (8, 16)),
                           ("w_down", (16, 8)))}
    np.testing.assert_allclose(
        tlayers.mlp({k: torch.from_numpy(a) for k, a in w.items()},
                    torch.from_numpy(x), gated).numpy(),
        np.asarray(jlayers.mlp({k: jnp.asarray(a) for k, a in w.items()},
                               jnp.asarray(x), gated)), atol=1e-5, rtol=1e-5)


def test_unported_plans_raise():
    cfg = get_config("gemma3-27b", smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LM(cfg, device="cpu").init_cache(1, 8)


def test_cuda_device_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA model is legal here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(get_config("internlm2-1.8b", smoke=True))
