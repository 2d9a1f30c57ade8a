"""mamba2 (the uniform SSM plan) through the port's ServeEngine, on the
CPU, against the JAX ServeEngine: the same weights and the same greedy
trace -- more requests than slots, so slots are reset and reused -- must
give identical token streams in continuous and wave mode.  A request
served in a reused slot must give the tokens a fresh engine gives it.
Plus the SSM leaves' round trip through ``convert``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import tiny_lm  # noqa: E402
from test_torch_forward import boost_ssm  # noqa: E402
from repro.runtime.serve import Request as JRequest  # noqa: E402
from repro.runtime.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.runtime.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.runtime.serve import (Request, ServeConfig,  # noqa: E402
                                       ServeEngine)

ARCH = "mamba2-1.3b"
CONFIG = dict(batch_slots=2, max_len=32, prefill_chunk=4)


def _trace(n=5):
    rng = np.random.default_rng(17)
    return [(i, rng.integers(0, 64, size=int(rng.integers(1, 9))).astype(
        np.int32)) for i in range(n)]


def _jax_params():
    """The shared tiny mamba2's JAX params with the SSM projections boosted
    (see ``test_torch_forward.SSM_BOOST``), so that SSM state decides the
    tokens."""
    return boost_ssm(tiny_lm(ARCH)[1])


def _port():
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), num_layers=2,
                              vocab_size=64)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    return model, convert.params_from_jax(_jax_params())


def _run(engine, req_cls, trace, max_new=6):
    for i, prompt in trace:
        engine.submit(req_cls(i, prompt, max_new_tokens=max_new))
    done = engine.run()
    assert len(done) == len(trace)
    return {r.req_id: list(r.output) for r in done}


_JAX_STREAMS = {}


def _jax_streams(mode):
    if mode not in _JAX_STREAMS:
        import jax.numpy as jnp

        jm, _ = tiny_lm(ARCH)
        jp = jax.tree.map(jnp.asarray, _jax_params())
        eng = JServeEngine(jm, jp, JServeConfig(mode=mode, **CONFIG))
        _JAX_STREAMS[mode] = _run(eng, JRequest, _trace())
    return _JAX_STREAMS[mode]


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_ssm_engine_matches_jax_engine(mode):
    model, params = _port()
    eng = ServeEngine(model, params, ServeConfig(mode=mode, **CONFIG))
    assert not eng.chunked  # SSM prompts are token-fed
    assert _run(eng, Request, _trace()) == _jax_streams(mode)


def test_ssm_continuous_equals_wave_within_port():
    model, params = _port()
    outs = {mode: _run(ServeEngine(model, params, ServeConfig(
        mode=mode, **CONFIG)), Request, _trace())
        for mode in ("continuous", "wave")}
    assert outs["continuous"] == outs["wave"]


def test_reused_slot_matches_fresh_engine():
    """Five requests through two slots: each request's tokens equal what
    a fresh engine gives it alone, so no state leaks from a slot's last
    occupant (the reset on admission works)."""
    model, params = _port()
    shared = _run(ServeEngine(model, params, ServeConfig(**CONFIG)), Request,
                  _trace())
    for i, prompt in _trace():
        fresh = _run(ServeEngine(model, params, ServeConfig(**CONFIG)),
                     Request, [(i, prompt)])
        assert fresh[i] == shared[i], i


def test_slot_reset_zeroes_only_its_slot():
    model, params = _port()
    eng = ServeEngine(model, params, ServeConfig(**CONFIG))
    for leaf in eng.caches["stack"].values():
        leaf.fill_(1.0)
    eng._reset(eng.caches, 1)
    for leaf in eng.caches["stack"].values():  # batch axis 1 of (L, B, ...)
        assert bool((leaf[:, 1] == 0).all()) and bool((leaf[:, 0] == 1).all())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", ARCH])
def test_engine_resets_slots_as_the_jax_engine(arch):
    """The port decides the slot reset from the model's plan; the JAX
    engine from the family name.  They agree for every ported plan."""
    jm, jp = tiny_lm(arch)
    jeng = JServeEngine(jm, jp, JServeConfig(**CONFIG))
    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=2,
                              vocab_size=64)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    eng = ServeEngine(model, convert.params_from_jax(jp),
                      ServeConfig(**CONFIG))
    assert eng._needs_reset == jeng._needs_reset == (arch == ARCH)


def test_ssm_engine_refuses_paged_cache():
    model, params = _port()
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(model, params, ServeConfig(cache="paged", page_size=8,
                                               **CONFIG))


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_launcher_serves_mamba2_on_cpu(mode, capsys):
    from repro_torch.launch import serve as launcher

    done = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "6", "--max-new", "4", "--mode",
                          mode])
    assert len(done) == 6 and all(len(r.output) == 4 for r in done)
    assert "served 6 requests, 24 tokens" in capsys.readouterr().out


def test_convert_round_trips_ssm_params():
    """The generic tree conversion carries every SSM leaf across with its
    shape, dtype and value (A_log, dt_bias and D stay f32)."""
    _, jp = tiny_lm(ARCH)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    ssm = tp["blocks"]["stack"]["ssm"]
    assert sorted(ssm) == ["A_log", "D", "conv_b", "conv_w", "dt_bias",
                           "in_proj", "norm_scale", "out_proj"]
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    own = LM(_port()[0].cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, tp))


def test_convert_round_trips_ssm_caches():
    """conv (L,B,3,conv_dim) and state (L,B,NH,hp,ds) from the JAX
    ``init_cache`` layout and back to numpy, bf16 conv included."""
    import jax.numpy as jnp

    jm, _ = tiny_lm(ARCH)
    shapes = jax.tree.map(lambda a: a.shape, jm.init_cache(2, 16))
    model, _ = _port()
    want = model.init_cache(2, 16)
    rng = np.random.default_rng(3)
    filled = jax.tree.map(lambda shp: rng.normal(size=shp).astype(
        np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    tc = convert.cache_from_jax(filled)
    for key in ("conv", "state"):
        assert tc["stack"][key].shape == want["stack"][key].shape
    back = convert.cache_to_numpy(tc)
    for key in ("conv", "state"):
        np.testing.assert_array_equal(back["stack"][key],
                                      filled["stack"][key])
    bf = np.asarray(jnp.asarray(filled["stack"]["conv"], jnp.bfloat16))
    tbf = convert.cache_from_jax({"conv": bf})["conv"]
    assert tbf.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.cache_to_numpy({"conv": tbf})[
        "conv"], bf.astype(np.float32))
