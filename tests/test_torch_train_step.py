"""One train step of the port (``runtime.steps.make_train_step``) against
the reference's jitted ``make_train_step`` at ``grad_accum`` 1 and 2, from
the reference's ``init_train_state`` carried to the port by
``convert.train_state_from_jax``: the metrics, mu, nu and the new params
and master.  A dense arch and an MoE arch (whose metrics carry the aux
losses); every arch's gradient is held to ``jax.grad`` in
``test_torch_train_grads.py``, whose tolerances these tests share."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import RuntimeKnobs as JKnobs  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.runtime.steps import init_train_state as jinit_train_state  # noqa: E402,E501
from repro.runtime.steps import make_train_step as jmake_train_step  # noqa: E402,E501
from repro_torch import convert  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402
from test_torch_train_grads import (GRAD_ATOL, GRAD_RTOL, KNOBS,  # noqa: E402,E501,F401
                                    _assert_close, _batch, _flat, _port,
                                    one_thread)

STEP_ARCHS = ["internlm2-1.8b", "qwen3-moe-235b-a22b"]  # dense; MoE metrics
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


_STEP = {}


def _reference_step(arch, grad_accum):
    """The reference's state before and after one jitted train step, and
    its metrics (numpy / floats); its ``init_train_state`` jitted once per
    arch."""
    if arch not in _STEP:
        jm = JLM(jget_config(arch, smoke=True),
                 JKnobs(cache_dtype=jnp.float32, **KNOBS))
        state = jax.jit(lambda k: jinit_train_state(jm, k))(
            jax.random.PRNGKey(0))
        _STEP[arch] = (jm, state)
    key = (arch, grad_accum)
    if key not in _STEP:
        jm, state = _STEP[arch]
        step = jax.jit(jmake_train_step(jm, JAdamWConfig(**OPT), grad_accum))
        batch = _batch(jm.cfg, seed=3)
        new, met = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        _STEP[key] = (jax.tree.map(np.asarray, state), batch,
                      jax.tree.map(np.asarray, new),
                      {k: float(v) for k, v in met.items()})
    return _STEP[key]


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch, grad_accum):
    """One ``make_train_step`` from the reference's initial state: the
    metrics, mu and nu within the gradients' tolerance, and the new
    params.  At the first step AdamW moves each param by about lr *
    sign(g), so an element whose gradient lies within the gradients'
    tolerance of 0 may move either way on either side: those elements are
    held to 2 lr, every other one to 1e-6."""
    before, batch, want, wmet = _reference_step(arch, grad_accum)
    state = convert.train_state_from_jax(before)
    assert state["opt"]["step"].dtype == torch.int32
    step = make_train_step(_port(arch), AdamWConfig(**OPT), grad_accum)
    state, met = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert set(met) == set(wmet)
    for k, v in wmet.items():
        assert float(met[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    got = convert.train_state_to_numpy(state)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    lr = wmet["lr"]
    # mu = (1 - b1) * s * g at the first step, s the clipping scale
    mu_atol = 0.1 * min(1.0, 1.0 / wmet["grad_norm"]) * GRAD_ATOL
    mu_w, nu_w = _flat(want["opt"]["mu"]), _flat(want["opt"]["nu"])
    n_sure = n_all = 0
    for key, w_mu in mu_w.items():
        _assert_close(_flat(got["opt"]["mu"])[key], w_mu, f"mu/{key}",
                      atol=mu_atol)
        # nu ~ g^2: twice g's relative error
        _assert_close(_flat(got["opt"]["nu"])[key], nu_w[key], f"nu/{key}",
                      rtol=2 * GRAD_RTOL, atol=mu_atol ** 2)
        sure = np.abs(w_mu) > 10 * (GRAD_RTOL * np.abs(w_mu).max()
                                    + mu_atol)
        n_sure, n_all = n_sure + sure.sum(), n_all + sure.size
        old = _flat(before["params"])[key]
        for part in ("params", "opt/master"):
            err = np.abs((_flat(got)[f"{part}/{key}"] - old)
                         - (_flat(want)[f"{part}/{key}"] - old))
            assert (err[sure] <= 1e-6).all(), f"{part}/{key}"
            assert (err <= 2 * lr + 1e-6).all(), f"{part}/{key}"
    assert n_sure > 0.5 * n_all, (n_sure, n_all)
