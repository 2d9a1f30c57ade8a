"""The port's ``Trainer`` (``runtime/train.py``), the copied
``run_with_failures`` around it and the training launcher: a 5-step run
against the reference's ``Trainer`` from the same converted state, twins
of ``tests/test_runtime.py``'s training tests, and
``python -m repro_torch.launch.train --smoke --device cpu``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from test_torch_train_grads import one_thread  # noqa: E402,F401
from repro.data import MarkovSynthetic as JMarkovSynthetic  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.runtime.steps import init_train_state as jinit_train_state  # noqa: E402,E501
from repro.runtime.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime.train import Trainer as JTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import MarkovSynthetic  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.fault import (FailureInjector,  # noqa: E402
                                       run_with_failures)
from repro_torch.runtime.train import TrainConfig, Trainer  # noqa: E402

# The 5-step histories: step 1 is the same f32 loss to a few ulps; each
# AdamW step then moves an element whose gradient is within the two
# packages' rounding of 0 by +-lr on either side, so the later metrics
# drift apart (measured <= 6e-7 of their value, grad_accum 1 and 2).
HIST_RTOL = 1e-5
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=5)


def _tiny_model():
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    return LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")


def _dataset(model, batch=8, seq=32, cls=MarkovSynthetic):
    return cls(vocab_size=model.cfg.vocab_size, seq_len=seq,
               global_batch=batch, seed=1, noise=0.05)


def _jax_state():
    """The reference's initial train state of ``tiny_lm`` (jitted init) as
    numpy."""
    jm, _ = tiny_lm()
    state = jax.jit(lambda k: jinit_train_state(jm, k))(jax.random.PRNGKey(0))
    return jm, jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_trainer_follows_the_reference_history(grad_accum):
    """5 steps of ``Trainer.run`` on ``MarkovSynthetic`` from one state:
    every logged metric against the reference ``Trainer``'s."""
    jm, state = _jax_state()
    jtr = JTrainer(jm, _dataset(jm, cls=JMarkovSynthetic), JTrainConfig(
        steps=5, grad_accum=grad_accum, log_every=1, checkpoint_every=0,
        opt=JAdamWConfig(**OPT)))
    jtr.state = jax.tree.map(jnp.asarray, state)
    want = jtr.run()["history"]
    model = _tiny_model()
    tr = Trainer(model, _dataset(model), TrainConfig(
        steps=5, grad_accum=grad_accum, log_every=1, checkpoint_every=0,
        opt=AdamWConfig(**OPT)))
    tr.state = convert.train_state_from_jax(state)
    got = tr.run()["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == [
        1, 2, 3, 4, 5]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=HIST_RTOL), (k, g, w)


def test_trainer_refuses_a_mesh():
    """The Trainer trains over a mesh (``test_torch_sharded_train.py``);
    it refuses shardings without the mesh they cut over, and a mesh other
    than the one the model's seams run over."""
    from repro_torch.sharding import make_shard_fn

    model = _tiny_model()
    for kw in ("state_shardings", "batch_shardings"):
        with pytest.raises(ValueError, match="needs the mesh"):
            Trainer(model, _dataset(model), TrainConfig(), **{kw: {}})
    sizes = {"data": 1, "model": 1}
    sharded = type(model)(model.cfg, model.knobs.with_(
        shard_fn=make_shard_fn(sizes, model.cfg)), model.device)
    with pytest.raises(ValueError, match="another mesh"):
        Trainer(sharded, _dataset(model), TrainConfig(), mesh=dict(sizes))


# ------------------------------------------- twins of tests/test_runtime.py
def test_training_reduces_loss():
    model = _tiny_model()
    tcfg = TrainConfig(steps=40, log_every=1, checkpoint_every=0,
                       opt=AdamWConfig(lr=3e-3, warmup_steps=5,
                                       total_steps=40))
    out = Trainer(model, _dataset(model), tcfg).run()
    first = out["history"][0]["loss"]
    last = out["history"][-1]["loss"]
    assert last < 0.8 * first, (first, last)


def test_grad_accum_equivalent_loss_scale():
    """grad_accum=2 over the same data: finite metrics, and the first
    step's loss (the same params on the same rows) equal to grad_accum=1's
    to a few ulps."""
    model = _tiny_model()
    first = []
    for accum in (1, 2):
        tcfg = TrainConfig(steps=2, grad_accum=accum, log_every=1,
                           checkpoint_every=0)
        out = Trainer(model, _dataset(model), tcfg).run()
        assert np.isfinite(out["history"][-1]["loss"])
        first.append(out["history"][0]["loss"])
    assert first[1] == pytest.approx(first[0], rel=1e-6)


def test_fault_restart_resumes_from_checkpoint(tmp_path):
    model = _tiny_model()
    ckpt = str(tmp_path / "ck")
    inj = FailureInjector(fail_at_steps=(12,))

    def make_trainer(attempt):
        tcfg = TrainConfig(steps=25, checkpoint_every=5, log_every=1,
                           checkpoint_dir=ckpt)
        return Trainer(model, _dataset(model), tcfg)

    out = run_with_failures(make_trainer, injector=inj)
    assert out["restarts"] == 1
    assert out["step"] == 25
    # restart resumed from step 10 (last checkpoint before 12)
    steps = [h["step"] for h in out["history"]]
    assert steps == list(range(11, 26))


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """The restart restores the state of step 10 bitwise and replays the
    same batches (the data is keyed on the step), so its losses are the
    uninterrupted run's, bitwise, on the CPU."""
    model = _tiny_model()
    tcfg = dict(steps=16, checkpoint_every=5, log_every=1)
    whole = Trainer(model, _dataset(model), TrainConfig(**tcfg)).run()
    out = run_with_failures(
        lambda attempt: Trainer(model, _dataset(model), TrainConfig(
            checkpoint_dir=str(tmp_path / "ck"), **tcfg)),
        injector=FailureInjector(fail_at_steps=(13,)))
    assert out["restarts"] == 1
    want = {h["step"]: h for h in whole["history"]}
    for h in out["history"]:
        assert h == want[h["step"]]


def test_failure_without_checkpoint_restarts_from_zero(tmp_path):
    model = _tiny_model()
    inj = FailureInjector(fail_at_steps=(3,))
    calls = []

    def make_trainer(attempt):
        calls.append(attempt)
        return Trainer(model, _dataset(model),
                       TrainConfig(steps=6, checkpoint_every=0, log_every=1))

    out = run_with_failures(make_trainer, injector=inj)
    assert out["step"] == 6 and len(calls) == 2
    assert [h["step"] for h in out["history"]] == list(range(1, 7))


# --------------------------------------------------------------- launcher
def test_launcher_trains_on_the_cpu(capsys, tmp_path):
    out = launch_train.main(["--arch", "internlm2-1.8b", "--smoke",
                             "--device", "cpu", "--steps", "30",
                             "--ckpt-dir", str(tmp_path / "ck"),
                             "--ckpt-every", "10"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=internlm2-1.8b smoke=True params=")
    logged = [line for line in lines if line.startswith("step ")]
    assert len(logged) == 3 and "grad_norm" in logged[0]
    hist = out["history"]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000010", "step_00000020", "step_00000030"]


def test_launcher_without_a_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "internlm2-1.8b", "--smoke",
                           "--steps", "1"])
