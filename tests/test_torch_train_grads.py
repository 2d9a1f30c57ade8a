"""The port's training route held against ``jax.value_and_grad`` of the
reference's ``LM.loss`` on every arch's smoke config (one train step
against the reference's jitted ``make_train_step`` is in
``test_torch_train_step.py``).

The reference side is its training route: ``RuntimeKnobs(cache_dtype=
jnp.float32)`` with the default ``use_pallas=False`` (as
``tests/test_models_smoke.py``), the only one it can differentiate.  Both
sides take the same params and the same numpy batch; ``q_chunk`` and
``ce_chunk`` split the 32-token sequence, so the per-chunk remat of
attention and the CE runs.  The gradient tests draw the params with the
port's ``LM.init`` (the reference's distributions and layout) and carry
them to JAX through numpy: the JAX ``LM.init`` of a smoke config takes
5-12 s eagerly and 2-5 s jitted on a CPU, more than the jitted gradient
itself.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import RuntimeKnobs as JKnobs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402

ARCHS = list_archs()
B, S = 2, 32
KNOBS = dict(q_chunk=8, ce_chunk=16)
# Per leaf, f32 gradients through up to 4 layers whose sums run in other
# orders: max|g_port - g_jax| <= GRAD_RTOL * max|g_jax| + GRAD_ATOL.
# Measured: at most 0.8% of this bound (zamba2), 0.2% on most archs.
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
LOSS_RTOL = 1e-6  # the scalar loss: a few f32 ulps


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for torch while this module runs: its tensors
    are tiny, and the suite runs several workers side by side, whose
    thread pools would otherwise oversubscribe the cores (a training step
    of tiny ops took 45x longer so).  The module's comparisons hold at any
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(
        np.int32)}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return batch


def _flat(tree, prefix=()):
    """{"a/b/c": leaf} in sorted-key order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


_REF = {}


def _reference(arch):
    """(JAX model, params as numpy, batch, loss, metrics, grads as a flat
    numpy dict) of ``jax.value_and_grad(LM.loss)``, jitted once per arch,
    at the port's init carried across."""
    if arch not in _REF:
        cfg = jget_config(arch, smoke=True)
        jm = JLM(cfg, JKnobs(cache_dtype=jnp.float32, **KNOBS))
        init = _port(arch).init(torch.Generator().manual_seed(0))
        jp = jax.tree.map(jnp.asarray, convert.cache_to_numpy(init))
        batch = _batch(cfg)
        (loss, met), grads = jax.jit(jax.value_and_grad(
            jm.loss, has_aux=True))(jp, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        _REF[arch] = (jm, jax.tree.map(np.asarray, jp), batch, float(loss),
                      {k: float(v) for k, v in met.items()},
                      {k: np.asarray(v) for k, v in _flat(grads).items()})
    return _REF[arch]


def _port(arch, **knobs):
    return LM(get_config(arch, smoke=True),
              RuntimeKnobs(cache_dtype=torch.float32, **KNOBS, **knobs),
              device="cpu")


def _loss_and_grads(model, params, batch):
    """(loss, metrics, {key: grad}) of the port's ``LM.loss``; a leaf the
    loss does not read gets a zero gradient (as under ``jax.grad``)."""
    leaves = _flat(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss, met = model.loss(params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in leaves.items()}
    return loss.detach(), {k: v.detach() for k, v in met.items()}, grads


def _assert_close(got, want, what, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    err = float(np.abs(got - want).max()) if want.size else 0.0
    bound = rtol * float(np.abs(want).max(initial=0.0)) + atol
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_jax(arch):
    jm, jp, batch, jloss, jmet, jgrads = _reference(arch)
    tloss, tmet, tgrads = _loss_and_grads(_port(arch),
                                          convert.params_from_jax(jp), batch)
    assert float(tloss) == pytest.approx(jloss, rel=LOSS_RTOL)
    assert set(tmet) == set(jmet)
    for k, v in jmet.items():
        assert float(tmet[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert set(tgrads) == set(jgrads)
    for key, want in jgrads.items():
        got = tgrads[key]
        assert got.shape == want.shape and got.dtype == torch.float32, key
        _assert_close(got.numpy(), want, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_bitwise_equal_grads(arch):
    """``knobs.remat`` changes what the backward keeps, never a bit of the
    loss or a gradient (the recompute runs the same ops on the same
    inputs).  The port's own init: no reference needed."""
    batch = _batch(get_config(arch, smoke=True), seed=1)
    out = []
    for remat in (True, False):
        model = _port(arch, remat=remat)
        params = model.init(torch.Generator().manual_seed(0))
        out.append(_loss_and_grads(model, params, batch))
    (l1, m1, g1), (l2, m2, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_route_reaches_no_kernel(arch, monkeypatch):
    """``LM.loss`` and its backward call no kernel dispatch: the kernels'
    outputs carry no gradient, so the training route must not reach
    them (the reference trains on its XLA route too)."""
    def refuse(*a, **k):
        raise AssertionError("the training route reached a kernel")

    for name in ("flash_attention", "ssd_chunk", "decode_attention",
                 "paged_decode_attention", "paged_prefill_attention"):
        monkeypatch.setattr(ops, name, refuse)
    model = _port(arch)
    params = model.init(torch.Generator().manual_seed(0))
    loss, _, grads = _loss_and_grads(
        model, params, _batch(get_config(arch, smoke=True), seed=2))
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_ssd_gradient_stays_finite_at_a_full_chunk():
    """mamba2's smoke block at its real chunk size (256) on 256 tokens:
    the reference's einsum route takes exp(cum_t - cum_j) above the
    diagonal before masking it, which overflows to inf, and its gradient
    is NaN there (a fault of the reference).  The port masks before the
    exp: the same loss, finite gradients."""
    cfg = jget_config("mamba2-1.3b", smoke=True)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk_size=256))
    model = LM(dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                                   ssm=cfg.ssm),
               RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, b=1, s=256)
    jm = JLM(cfg, JKnobs(cache_dtype=jnp.float32))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, convert.cache_to_numpy(params)),
        {"tokens": jnp.asarray(batch["tokens"])})
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jgrads))
    tloss, _, tgrads = _loss_and_grads(model, params, batch)
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert all(torch.isfinite(g).all() for g in tgrads.values())
