"""Sharded training in the port: the train step over a mesh of ranks
(gloo, one torch thread a rank) against the port's unsharded step and the
reference's single-device step, ZeRO-2, the ``Trainer`` over a mesh, the
elastic restore, the launcher's world and the seams' gradients.

The model is the reference's ``tiny_model`` of ``tests/test_multidevice.py``
(internlm2, d_model 64, four query heads on two KV heads of 16, two
layers, vocab 64), drawn by the port's init.  Two worlds are spawned once
per module through ``torch_worlds``: four ranks at (2, 2), then two ranks
at (1, 2) and (2, 1), which restore the (2, 2) world's checkpoint.

Tolerances.  gloo sums the batch ranks' gradients in another order than
one device sums the rows, so bitwise is not the bar: the loss within 1e-6
relative of the unsharded step's, every gradient leaf within 1e-5 of its
max abs (GRAD_TOL).  The params after two AdamW steps follow from those
gradients: an element moves by lr_t * u_t a step, u_t in [-1, 1] about,
and an element whose gradient lies within its tolerance of 0 may move
either way on either side; ``_hold_params`` states the bound."""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.steps import (init_train_state,  # noqa: E402
                                       make_train_step)
from torch_worlds import read_records, spawn_world  # noqa: E402

TINY = dict(num_layers=2, vocab_size=64, d_model=64, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B, S, STEPS = 8, 32, 2
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5


def tiny_cfg():
    return dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                               **TINY)


def knobs():
    return RuntimeKnobs(cache_dtype=torch.float32, q_chunk=16)


def batches(n=STEPS, b=B):
    rng = np.random.default_rng(3)
    return [{"tokens": torch.as_tensor(rng.integers(0, 64, size=(b, S))
                                       .astype(np.int32))} for _ in range(n)]


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


class Markov:
    """The Trainer's dataset: ``batches``' draws, one a step."""

    def __init__(self, n):
        self.data = batches(n)

    def batch(self, step):
        return {k: v.numpy() for k, v in self.data[step].items()}


WORKER = """
import test_torch_sharded_train as T
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import LM
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import init_train_state, make_train_step
from repro_torch.runtime.train import TrainConfig, Trainer
from repro_torch.sharding import (grad_shardings, make_shard_fn,
                                  train_state_shardings)
from repro_torch.sharding.rules import param_shapes
from repro_torch.sharding.zero import gather_state, state_shardings_of
from repro_torch.checkpoint import restore

cfg = T.tiny_cfg()
ckpt = os.environ["CKPT"]


def sharded(shape, layout="tp"):
    mesh = make_serve_mesh(shape)
    return mesh, LM(cfg, T.knobs().with_(
        shard_fn=make_shard_fn(mesh, cfg, layout=layout)), device="cpu")


def nbytes(tree):
    return {k: v.numel() * v.element_size() for k, v in T.flat(tree).items()}


def steps(shape, accum=1, zero2=False, layout="tp", fsdp=False):
    mesh, model = sharded(shape, layout)
    specs = train_state_shardings(mesh, cfg, param_shapes(cfg), fsdp=fsdp,
                                  layout=layout)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             shardings=specs)
    gsh = grad_shardings(mesh, cfg, param_shapes(cfg)) if zero2 else None
    step = make_train_step(model, AdamWConfig(**T.OPT), accum,
                           grad_shardings=gsh, state_shardings=specs)
    grads, _ = step.whole_grads(state, T.batches()[0])
    losses = []
    for b in T.batches():
        state, met = step(state, b)
        losses.append(float(met["loss"]))
    opt_bytes = nbytes(state["opt"]["master"])
    full = gather_state(state, specs, mesh)
    return {"losses": losses, "grads": grads, "state": full,
            "opt_bytes": opt_bytes}


def save(name, rec):
    if rank == 0:
        torch.save(rec, os.path.join(out_dir, name + ".pt"))
    write_record(out_dir, name, {"ok": True}, rank)


def trainer(shape, until, every):
    mesh, model = sharded(shape)
    tcfg = TrainConfig(steps=6, checkpoint_every=every, checkpoint_dir=ckpt,
                       log_every=1, opt=AdamWConfig(**T.OPT))
    tr = Trainer(model, T.Markov(6), tcfg, mesh=mesh)
    out = tr.run(until=until)
    return {"history": out["history"]}


if world == 4:
    save("steps_2x2", steps((2, 2)))
    save("steps_fsdp2x2", steps((2, 2), fsdp=True))
    save("zero2_2x2", steps((2, 2), accum=2, zero2=True))
    save("zero2_2x1x2", steps((2, 1, 2), accum=2, zero2=True))
    save("accum_2x2", steps((2, 2), accum=2))
    save("trainer_2x2", trainer((2, 2), until=3, every=3))
    # the seam: a rank's 3 values gathered over "model", weighted by
    # arange(6)
    from repro_torch.sharding.collectives import all_gather_cat, gather_seam
    mesh = make_serve_mesh((2, 2))
    g, m = mesh.get_group("model"), mesh.get_coordinate()[1]
    x = torch.full((3,), float(rank), requires_grad=True)
    w = torch.arange(6.0)
    (gather_seam(x, g, 0, m) * w).sum().backward()
    seam = x.grad.tolist()
    y = all_gather_cat(x, g, 0)
    plain = y.requires_grad


    class Summing(torch.autograd.Function):
        # torch.distributed.nn's all_gather backward: the incoming
        # gradient summed over the group, then the rank's slice
        @staticmethod
        def forward(ctx, x):
            return all_gather_cat(x, g, 0)

        @staticmethod
        def backward(ctx, grad):
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=g)
            return grad.narrow(0, 3 * m, 3)

    x2 = torch.full((3,), float(rank), requires_grad=True)
    (Summing.apply(x2) * w).sum().backward()
    write_record(out_dir, "seam", {"seam": seam, "plain_requires_grad": plain,
                                   "summing": x2.grad.tolist(), "m": m},
                 rank)
else:
    save("steps_1x2", steps((1, 2)))
    save("steps_2x1", steps((2, 1)))
    save("steps_dp1x2", steps((1, 2), layout="dp"))
    for shape in ((1, 2), (2, 1)):
        mesh, model = sharded(shape)
        shapes = LM(cfg, T.knobs(), device="meta")
        target = init_train_state(shapes, torch.Generator())
        specs = state_shardings_of(model)
        got, meta = restore(ckpt, target, specs, device="cpu", mesh=mesh)
        blocks = {k: list(v.shape) for k, v in T.flat(got).items()}
        save("restore_" + "x".join(map(str, shape)), {
            "state": gather_state(got, specs, mesh), "step": meta["step"],
            "blocks": blocks})
    save("resume_1x2", trainer((1, 2), until=6, every=0))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds' results, and the unsharded port's: two steps from the
    same init (grad_accum 1 and 2), the first step's gradient, and the
    uninterrupted Trainer's history."""
    from repro_torch.runtime.train import TrainConfig, Trainer

    tmp = tmp_path_factory.mktemp("sharded_train")
    torch.set_num_threads(1)
    ckpt = tmp / "ckpt"
    for n in (4, 2):
        (tmp / f"w{n}").mkdir()
        spawn_world(n, tmp / f"w{n}", WORKER, env={"CKPT": str(ckpt)},
                    name=f"train-world{n}")
    res = {}
    for n in (4, 2):
        for name in read_records(tmp / f"w{n}"):
            path = tmp / f"w{n}" / f"{name}.pt"
            if path.exists():
                res[name] = torch.load(path)
    res["seam"] = [read_records(tmp / "w4", r)["seam"] for r in range(4)]
    base = {}
    for accum in (1, 2):
        model = LM(tiny_cfg(), knobs(), device="cpu")
        state = init_train_state(model, torch.Generator().manual_seed(0))
        step = make_train_step(model, AdamWConfig(**OPT), accum)
        from repro_torch.runtime.steps import _value_and_grad, _unflatten
        if accum == 1:
            _, _, g = _value_and_grad(model, state["params"], batches()[0])
            base["grads"] = _unflatten(state["params"], g)
        losses, seen = [], []
        for b in batches():
            _, _, g = _value_and_grad(model, state["params"], b)
            seen.append(flat(_unflatten(state["params"], g)))
            state, met = step(state, b)
            losses.append(float(met["loss"]))
        base[accum] = {"losses": losses, "state": state, "grads_seen": seen}
    model = LM(tiny_cfg(), knobs(), device="cpu")
    tcfg = TrainConfig(steps=6, checkpoint_every=0, log_every=1,
                       opt=AdamWConfig(**OPT))
    base["history"] = Trainer(model, Markov(6), tcfg).run()["history"]
    return {"res": res, "base": base, "tmp": tmp, "ckpt": ckpt}


def _hold_params(got, want, grads_seen, lrs):
    """Every leaf of ``got`` against ``want`` (flat trees), element by
    element: AdamW moves an element by lr_t * u_t a step, u_t the ratio
    of its moments, which a relative error r of the element's gradient
    moves by at most about 2 r (numerator and denominator), and by 2 at
    most (a sign).  With the gradient held to d_t = GRAD_TOL * max|g_t|,
    r = max_t d_t / |g_t| and the bound is sum_t lr_t * min(2, 4 r) (a
    factor 2 of room), plus 1e-7."""
    for key, w in want.items():
        err = (got[key].float() - w.float()).abs()
        leaf = key.split("/", 2 if key.startswith("opt/") else 1)[-1]
        r = torch.zeros_like(err)
        for gs in grads_seen:
            gl = gs[leaf].abs()
            r = torch.maximum(r, GRAD_TOL * float(gl.max())
                              / gl.clamp(min=1e-30))
        bound = sum(lr * torch.clamp(4 * r, max=2.0) for lr in lrs) + 1e-7
        assert (err <= bound).all(), (key, float((err - bound).max()))


def _lrs():
    from repro_torch.optim import warmup_cosine

    sched = warmup_cosine(AdamWConfig(**OPT))
    return [float(sched(t + 1)) for t in range(STEPS)]


SHAPES = ["2x2", "1x2", "2x1", "fsdp2x2", "dp1x2"]


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_steps_equal_unsharded(worlds, shape):
    """Two train steps at (2, 2), (1, 2) and (2, 1) from the unsharded
    init, at (2, 2) with the params stored FSDP-cut (``fsdp=True``:
    gathered over "data" to compute) and at (1, 2) under ``layout="dp"``
    (no model cut: every axis a batch axis, the optimizer state still
    cut, ZeRO-1): the loss of each within 1e-6 relative, the params,
    master, mu and nu after both within the step tolerance (module
    docstring)."""
    got = worlds["res"][f"steps_{shape}"]
    want = worlds["base"][1]
    for a, b in zip(got["losses"], want["losses"]):
        assert a == pytest.approx(b, rel=LOSS_RTOL)
    gflat, wflat = flat(got["state"]), flat(want["state"])
    keys = [k for k in wflat if k.startswith(("params/", "opt/master/"))]
    _hold_params({k: gflat[k] for k in keys}, {k: wflat[k] for k in keys},
                 want["grads_seen"], _lrs())
    for part in ("mu", "nu"):
        for k in (k for k in wflat if k.startswith(f"opt/{part}/")):
            w = wflat[k]
            tol = 4 * GRAD_TOL * float(w.abs().max()) + 1e-12
            assert float((gflat[k] - w).abs().max()) <= tol, k
    assert int(gflat["opt/step"]) == STEPS


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_gradient_equals_unsharded(worlds, shape):
    """The first step's gradient, every leaf gathered in full, within
    1e-5 of the leaf's max abs of the unsharded gradient: the gather
    seams take a rank's own slice (not |model| times it), the input seams
    sum the rank's heads' and columns' terms, the replicated leaves are
    not summed over "model"."""
    got = flat(worlds["res"][f"steps_{shape}"]["grads"])
    want = flat(worlds["base"]["grads"])
    assert set(got) == set(want)
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= GRAD_TOL * float(w.abs().max()), (k, err)


def test_sharded_loss_equals_jax_step(worlds):
    """The (2, 2) step's loss within 1e-3 of the reference's jitted
    single-device step on the same params (``tests/test_multidevice.py``'s
    bar)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import LM as JLM
    from repro.models import RuntimeKnobs as JKnobs
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.runtime.steps import make_train_step as jmake_train_step
    from repro_torch import convert

    model = LM(tiny_cfg(), knobs(), device="cpu")
    state = convert.train_state_to_numpy(
        init_train_state(model, torch.Generator().manual_seed(0)))
    jm = JLM(dataclasses.replace(jget_config("internlm2-1.8b", smoke=True),
                                 **TINY),
             JKnobs(cache_dtype=jnp.float32, q_chunk=16))
    step = jax.jit(jmake_train_step(jm, JAdamWConfig(**OPT)))
    _, met = step(jax.tree.map(jnp.asarray, state),
                  {"tokens": jnp.asarray(batches()[0]["tokens"].numpy())})
    got = worlds["res"]["steps_2x2"]["losses"][0]
    assert abs(got - float(met["loss"])) < 1e-3


def test_zero2_accumulation_equals_plain_accumulation(worlds):
    """``grad_accum`` 2 with ``grad_shardings`` (each microbatch's
    gradient reduce-scattered into the rank's block) against ``grad_accum``
    2 without (accumulated whole, all-reduced once), both at (2, 2), and
    against the unsharded ``grad_accum`` 2: within the step tolerance.
    At (pod 2, data 1, model 2) the accumulator's blocks (over "data"
    only) differ from the optimizer state's (over pod and data) and are
    moved into them each step."""
    res = worlds["res"]
    want = worlds["base"][2]
    for name in ("zero2_2x2", "zero2_2x1x2", "accum_2x2"):
        got = res[name]
        for a, b in zip(got["losses"], want["losses"]):
            assert a == pytest.approx(b, rel=LOSS_RTOL)
        gflat, wflat = flat(got["state"]), flat(want["state"])
        keys = [k for k in wflat if k.startswith(("params/", "opt/master/"))]
        _hold_params({k: gflat[k] for k in keys},
                     {k: wflat[k] for k in keys}, want["grads_seen"], _lrs())
    a, b = flat(res["zero2_2x2"]["state"]), flat(res["accum_2x2"]["state"])
    keys = [k for k in a if k.startswith("params/")]
    _hold_params({k: a[k] for k in keys}, {k: b[k] for k in keys},
                 want["grads_seen"], _lrs())


def test_zero_cuts_each_ranks_opt_state(worlds):
    """A rank's master (and so mu and nu) holds 1/|data| of the unsharded
    state's bytes in every leaf that ``opt_state_shardings`` cuts over
    "data", and 1/|model| more where it also cuts over "model"."""
    from repro_torch.sharding import opt_state_shardings
    from repro_torch.sharding.rules import param_shapes

    full = {k: v.numel() * 4 for k, v in flat(param_shapes(tiny_cfg()))
            .items()}
    for shape in ("2x2", "2x1", "1x2"):
        d, m = (int(x) for x in shape.split("x"))
        specs = flat(opt_state_shardings({"data": d, "model": m}, None,
                                         param_shapes(tiny_cfg()),
                                         fsdp=False))
        got = worlds["res"][f"steps_{shape}"]["opt_bytes"]
        cut_data = 0
        for k, spec in specs.items():
            div = (d if "data" in spec else 1) * (m if "model" in spec
                                                   else 1)
            assert got[k] * div == full[k], (shape, k)
            cut_data += d > 1 and "data" in spec
        if d > 1:
            assert cut_data > 0
    assert sum(worlds["res"]["steps_2x2"]["opt_bytes"].values()) * 2 < \
        sum(full.values())


@pytest.mark.parametrize("shape", ["1x2", "2x1", "unsharded"])
def test_elastic_restore_is_bitwise(worlds, shape):
    """The Trainer's checkpoint written at (2, 2) (every leaf gathered,
    rank 0 writing the reference's layout) restored at (1, 2), (2, 1)
    and unsharded: every rank's block is its slice of the stored array,
    and the blocks gathered are the stored arrays, bit for bit."""
    from repro_torch.checkpoint import load_checkpoint, restore

    stored, meta = load_checkpoint(str(worlds["ckpt"]))
    assert meta["step"] == 3
    if shape == "unsharded":
        target = init_train_state(LM(tiny_cfg(), knobs(), device="meta"),
                                  torch.Generator())
        got, _ = restore(str(worlds["ckpt"]), target, device="cpu")
    else:
        rec = worlds["res"][f"restore_{shape}"]
        assert rec["step"] == 3
        got = rec["state"]
        d, m = (int(x) for x in shape.split("x"))
        cut = rec["blocks"]["opt/master/blocks/stack/attn/wq"]
        assert cut[-3] * d == 64 and cut[-2] * m == 4  # dm over data, heads
    got = flat(got)
    assert set(got) == set(stored)
    for k, v in stored.items():
        assert np.array_equal(got[k].numpy(), v), k


def test_trainer_resumed_on_another_mesh(worlds):
    """A Trainer at (2, 2) stopped at step 3 (its checkpoint), resumed at
    (1, 2) to step 6, against the unsharded Trainer's uninterrupted
    history: each step's loss within 1e-5 relative (the sharded sums'
    order moves the state by ulps a step) and its step number."""
    first = worlds["res"]["trainer_2x2"]["history"]
    rest = worlds["res"]["resume_1x2"]["history"]
    want = worlds["base"]["history"]
    got = first + rest
    assert [h["step"] for h in got] == [h["step"] for h in want] == \
        list(range(1, 7))
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)


def test_seam_gradient_is_the_ranks_own_slice(worlds):
    """A rank's 3 values gathered over a model group of 2 and weighted by
    arange(6): the seam's gradient is the rank's own 3 weights.  A plain
    ``all_gather_cat`` carries no gradient at all, and a summing backward
    (``torch.distributed.nn``) gives |model| times the weights; both are
    what the gradient bar above would catch."""
    for rec in worlds["res"]["seam"]:
        m = rec["m"]
        want = [float(3 * m + i) for i in range(3)]
        assert rec["seam"] == want
        assert rec["plain_requires_grad"] is False
        assert rec["summing"] == [2 * w for w in want]


def test_launcher_trains_in_a_two_rank_world(worlds):
    """``launch.train`` under a world of 2: the job mesh (1, 2), rank 0
    prints the arch line and the history, rank 1 prints nothing, and the
    history equals the single-process launcher's within the step
    tolerance."""
    from repro_torch.launch.train import main

    tmp = worlds["tmp"] / "launcher"
    tmp.mkdir()
    args = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
            "--steps", "10"]
    outs = spawn_world(2, tmp, argv=[
        sys.executable, "-m", "repro_torch.launch.train", *args,
        "--dist-init", f"file://{tmp}/launcher.rendezvous"],
        name="train-launcher")
    assert "devices=2" in outs[0] and "step    10  loss" in outs[0], outs[0]
    assert outs[1] == ""
    want = main(args)["history"][-1]
    line = outs[0].strip().splitlines()[-1].split()
    assert float(line[3]) == pytest.approx(want["loss"], abs=1e-4)


def test_sharded_training_refusals():
    """What needs a mesh says so: shardings without a model over a mesh,
    a restore's shardings without their mesh, ``sp=True``."""
    from repro_torch.checkpoint import restore
    from repro_torch.runtime.train import TrainConfig, Trainer
    from repro_torch.sharding import make_shard_fn

    model = LM(tiny_cfg(), knobs(), device="cpu")
    with pytest.raises(ValueError, match="model over a mesh"):
        make_train_step(model, AdamWConfig(), grad_shardings={})
    with pytest.raises(ValueError, match="model over a mesh"):
        init_train_state(model, torch.Generator(), shardings={})
    with pytest.raises(ValueError, match="needs the mesh"):
        Trainer(model, Markov(1), TrainConfig(), state_shardings={})
    with pytest.raises(ValueError, match="needs the mesh"):
        restore("/nonexistent", {}, {})
    with pytest.raises(NotImplementedError, match="sp=True"):
        make_shard_fn({"data": 1, "model": 1}, tiny_cfg(), sp=True)
