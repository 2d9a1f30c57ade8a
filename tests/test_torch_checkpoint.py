"""The port's checkpoints (``repro_torch.checkpoint``): twins of
``tests/test_optim_data_ckpt.py``'s checkpoint tests, bf16 leaves stored
by their bits, and the interchange with the reference: a checkpoint the
reference ``Trainer`` saved restores in the port's, which then continues
to the reference's next losses, and one the port saved restores in the
reference's ``restore`` with the same keys and arrays."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from test_torch_train_grads import one_thread  # noqa: E402,F401
from repro import checkpoint as jckpt  # noqa: E402
from repro.data import MarkovSynthetic as JMarkovSynthetic  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.runtime.steps import init_train_state as jinit_train_state  # noqa: E402,E501
from repro.runtime.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime.train import Trainer as JTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (latest_step, load_checkpoint,  # noqa: E402
                                    prune_checkpoints, restore,
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import MarkovSynthetic  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.steps import init_train_state  # noqa: E402
from repro_torch.runtime.train import TrainConfig, Trainer  # noqa: E402

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=6)
# the continued losses, as in test_torch_train.py's histories
HIST_RTOL = 1e-5


def _state():
    return {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(
        2, 3)}, "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 10, _state(), extra={"arch": "x"})
    assert latest_step(d) == 10
    target = {"params": {"w": torch.empty((2, 3), device="meta")},
              "opt": {"step": torch.empty((), dtype=torch.int32,
                                          device="meta")}}
    restored, meta = restore(d, target, device="cpu")
    assert meta["step"] == 10 and meta["extra"]["arch"] == "x"
    assert torch.equal(restored["params"]["w"], _state()["params"]["w"])
    assert restored["opt"]["step"].dtype == torch.int32
    assert int(restored["opt"]["step"]) == 7


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, _state())
    save_checkpoint(d, 2, _state())
    assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
    prune_checkpoints(d, keep=1)
    assert latest_step(d) == 2
    assert len(os.listdir(d)) == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, _state())
    bad = {"params": {"w": torch.empty((3, 3))},
           "opt": {"step": torch.empty((), dtype=torch.int32)}}
    with pytest.raises(ValueError, match="shape mismatch for params/w"):
        restore(d, bad)
    with pytest.raises(KeyError, match="checkpoint missing params/b"):
        restore(d, {"params": {"b": torch.empty(1)}})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


def test_bf16_leaves_round_trip_by_their_bits(tmp_path):
    """numpy has no bfloat16: the leaf goes as its raw 16 bits, named in
    meta.json, and comes back bitwise."""
    d = str(tmp_path / "ckpt")
    w = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    state = {"w": w.to(torch.bfloat16), "m": w}
    save_checkpoint(d, 3, state)
    flat, meta = load_checkpoint(d)
    assert meta["dtypes"] == {"w": "bfloat16"}
    assert flat["w"].dtype == np.uint16 and flat["m"].dtype == np.float32
    got, _ = restore(d, {k: torch.empty_like(v, device="meta")
                         for k, v in state.items()}, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], state["w"]) and torch.equal(got["m"], w)


# ----------------------------------------------------- interchange with JAX
def _tiny_model():
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    return LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")


def _data(vocab, cls):
    return cls(vocab_size=vocab, seq_len=32, global_batch=8, seed=1,
               noise=0.05)


def test_reference_checkpoint_restores_and_training_continues(tmp_path):
    """The reference ``Trainer`` saves at step 3 and runs on to 6; the
    port's ``Trainer`` restores that checkpoint (its step and every leaf
    bitwise) and its steps 4-6 give the reference's losses."""
    jm, _ = tiny_lm()
    d, d3 = str(tmp_path / "jax"), str(tmp_path / "at3")
    jtr = JTrainer(jm, _data(64, JMarkovSynthetic), JTrainConfig(
        steps=6, log_every=1, checkpoint_every=3, checkpoint_dir=d,
        opt=JAdamWConfig(**OPT)))
    jtr.state = jax.jit(lambda k: jinit_train_state(jm, k))(
        jax.random.PRNGKey(0))
    jtr.run(until=3)
    shutil.copytree(d, d3)
    want = {h["step"]: h for h in jtr.run()["history"]}
    flat, _ = load_checkpoint(d3)
    model = _tiny_model()
    tr = Trainer(model, _data(64, MarkovSynthetic), TrainConfig(
        steps=6, log_every=1, checkpoint_every=0, checkpoint_dir=d3,
        opt=AdamWConfig(**OPT)))
    assert tr.maybe_restore() and tr.step == 3
    assert int(tr.state["opt"]["step"]) == 3
    got = convert.train_state_to_numpy(tr.state)
    for key, arr in flat.items():
        leaf = got
        for part in key.split("/"):
            leaf = leaf[part]
        np.testing.assert_array_equal(leaf, arr, err_msg=key)
    hist = tr.run()["history"]
    assert [h["step"] for h in hist] == [4, 5, 6]
    for h in hist:
        for k, v in want[h["step"]].items():
            assert h[k] == pytest.approx(v, rel=HIST_RTOL), (k, h)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port saves a trained state; the reference's ``restore`` against
    its own ``init_train_state`` shapes finds every key, and each array
    equals the port's leaf bitwise.  Both packages write the same keys."""
    model = _tiny_model()
    d = str(tmp_path / "port")
    tr = Trainer(model, _data(64, MarkovSynthetic), TrainConfig(
        steps=2, log_every=1, checkpoint_every=2, checkpoint_dir=d,
        opt=AdamWConfig(**OPT)))
    tr.run()
    jm, _ = tiny_lm()
    target = jax.eval_shape(lambda: jinit_train_state(jm,
                                                      jax.random.PRNGKey(0)))
    state, meta = jckpt.restore(d, target)
    assert meta["step"] == 2 and meta["extra"] == {"arch": model.cfg.name}
    want = convert.train_state_to_numpy(tr.state)
    flat = dict(jax.tree_util.tree_flatten_with_path(state)[0])
    assert len(flat) == len(jax.tree.leaves(target))
    for path, arr in flat.items():
        leaf = want
        for p in path:
            leaf = leaf[p.key]
        assert arr.dtype == leaf.dtype
        np.testing.assert_array_equal(np.asarray(arr), leaf)
    jd = str(tmp_path / "jax")
    jckpt.save_checkpoint(jd, 2, state)
    keys = [json.load(open(os.path.join(x, "step_00000002", "meta.json")))[
        "keys"] for x in (d, jd)]
    assert keys[0] == keys[1]


def test_meta_target_allocates_nothing():
    """``Trainer.maybe_restore`` takes the state's shapes from a model on
    the meta device: the same structure, shapes and dtypes as a real init,
    and no data."""
    model = _tiny_model()
    real = init_train_state(model, torch.Generator().manual_seed(0))
    meta = init_train_state(LM(model.cfg, model.knobs, device="meta"),
                            torch.Generator())
    a, b = convert.train_state_to_numpy(real), meta

    def walk(x, y):
        if isinstance(x, dict):
            assert set(x) == set(y)
            for k in x:
                walk(x[k], y[k])
        else:
            assert y.device.type == "meta"
            assert tuple(x.shape) == tuple(y.shape)
            assert str(x.dtype) == str(y.dtype).removeprefix("torch.")

    walk(a, b)
