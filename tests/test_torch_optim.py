"""The port's AdamW (``repro_torch.optim``) held against the reference's
``repro.optim.adamw``: twins of ``tests/test_optim_data_ckpt.py``'s AdamW
tests, and ``adamw_update``, ``global_norm`` and ``warmup_cosine`` against
the reference's on the same random trees, with f32 and bf16 moments."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, global_norm, warmup_cosine)

# f32 on both sides; the update's divisions, square roots and the norm's
# sums round in other orders (XLA fuses the update): a few f32 ulps.
RTOL = 1e-5
# A bf16 moment is the f32 moment rounded to bf16 on both sides: equal
# unless the f32 values straddle a rounding boundary, one bf16 ulp.
BF16_RTOL = 2.0 ** -7


# ------------------------------------------------------------------ twins
def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0, clip_norm=0.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    state = adamw_init({"w": torch.zeros(3)})
    for _ in range(200):
        w = state["master"]["w"].clone().requires_grad_()
        ((w - target) ** 2).sum().backward()
        adamw_update({"w": w.grad}, state, cfg)
    assert float(((state["master"]["w"] - target) ** 2).sum()) < 1e-2


def test_adamw_clipping_bounds_update():
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0, total_steps=10,
                      weight_decay=0.0)
    state = adamw_init({"w": torch.zeros(4)})
    new_master, state, m = adamw_update({"w": torch.full((4,), 1e6)}, state,
                                        cfg)
    assert float(m["grad_norm"]) > 1e5
    assert float(new_master["w"].abs().max()) < 2.0  # clipped step


def test_bf16_moments_track_fp32():
    cfg = AdamWConfig(lr=0.01, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    s32 = adamw_init({"w": torch.ones(16)}, torch.float32)
    s16 = adamw_init({"w": torch.ones(16)}, torch.bfloat16)
    assert s16["mu"]["w"].dtype == torch.bfloat16
    assert s16["master"]["w"].dtype == torch.float32
    for i in range(20):
        g = {"w": torch.sin(torch.arange(16.0) + i)}
        m32, s32, _ = adamw_update(g, s32, cfg)
        m16, s16, _ = adamw_update(g, s16, cfg)
    np.testing.assert_allclose(m32["w"].numpy(), m16["w"].numpy(),
                               atol=5e-3)


def test_warmup_cosine_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    sched = warmup_cosine(cfg)
    assert float(sched(0)) == 0.0
    assert float(sched(10)) == pytest.approx(1.0)
    assert float(sched(100)) == pytest.approx(0.1, abs=1e-6)
    assert float(sched(55)) < float(sched(20))


def test_master_never_aliases_the_params():
    params = {"w": torch.ones(3), "b": {"c": torch.zeros(2)}}
    state = adamw_init(params)
    for p, m in ((params["w"], state["master"]["w"]),
                 (params["b"]["c"], state["master"]["b"]["c"])):
        assert m.data_ptr() != p.data_ptr() and torch.equal(m, p)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()


# ------------------------------------------------------ against the reference
def _tree(rng, scale=1.0):
    """A nested tree of f32 arrays of a few shapes (numpy)."""
    return {"a": (scale * rng.normal(size=(3, 5))).astype(np.float32),
            "b": {"c": (scale * rng.normal(size=(7,))).astype(np.float32),
                  "d": (scale * rng.normal(size=(2, 2, 4))).astype(
                      np.float32)}}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm_matches_reference(seed):
    tree = _tree(np.random.default_rng(seed), scale=10.0 ** seed)
    want = float(joptim.global_norm(_map(jnp.asarray, tree)))
    got = float(global_norm(_map(torch.from_numpy, tree)))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 57, 100, 150])
def test_warmup_cosine_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = float(joptim.warmup_cosine(joptim.AdamWConfig(**cfg))(step))
    got = warmup_cosine(AdamWConfig(**cfg))(torch.tensor(step,
                                                         dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=RTOL, abs=1e-12)


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments, clip):
    """Five updates from the same params with the same random gradients
    (norms above the clip, so the clipping scale is live): the master,
    mu, nu, step and the metrics against the reference's."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=clip)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if moments == "bfloat16"
                else (jnp.float32, torch.float32))
    jcfg, tcfg = joptim.AdamWConfig(**kw), AdamWConfig(**kw)
    jstate = joptim.adamw_init(_map(jnp.asarray, params), jdt)
    tstate = adamw_init(_map(torch.from_numpy, params), tdt)
    jupd = jax.jit(lambda g, s: joptim.adamw_update(g, s, jcfg))
    for _ in range(5):
        grads = _tree(rng, scale=3.0)
        _, jstate, jm = jupd(_map(jnp.asarray, grads), jstate)
        _, tstate, tm = adamw_update(_map(torch.from_numpy, grads), tstate,
                                     tcfg)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=RTOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 5
    rtol = {"master": RTOL, "mu": RTOL, "nu": RTOL}
    if moments == "bfloat16":
        rtol = {"master": 1e-3, "mu": BF16_RTOL, "nu": BF16_RTOL}
    for part, tol in rtol.items():
        for path, got, want in _pairs(tstate[part], jstate[part]):
            assert got.dtype == (torch.float32 if part == "master" else tdt)
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                       atol=tol * np.abs(want).max(),
                                       err_msg=f"{part}{path}")
