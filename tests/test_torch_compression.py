"""The port's int8 gradient compression against the reference's
(``tests/test_optim_data_ckpt.py``'s cases): ``quantize_int8`` and
``dequantize_int8`` bitwise in-process; ``compress_error_feedback`` over a
4-rank gloo world bitwise the reference's ``jax.vmap(...,
axis_name="dp")`` over the same four gradients, three steps of error
feedback, every rank's result bitwise every other's; and the twin of the
bias case, 50 steps over a group of one, bitwise the reference's and
converging to the true gradient.  The world is spawned once per module
through ``torch_worlds``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import CompressionState as JState  # noqa: E402
from repro.optim import compress_error_feedback as j_compress  # noqa: E402
from repro.optim.compression import dequantize_int8 as j_dequant  # noqa: E402
from repro.optim.compression import quantize_int8 as j_quant  # noqa: E402
from repro_torch.optim import dequantize_int8, quantize_int8  # noqa: E402
from torch_worlds import read_records, spawn_world  # noqa: E402

N_DEV, STEPS, BIAS_STEPS = 4, 3, 50
BIAS_G = [0.001, 1.0, -0.3]


def grads(step):
    """The four ranks' gradients at ``step``: a (4, 32) normal draw, one
    row a rank, and a (4, 5, 3) leaf of other scales."""
    rng = np.random.default_rng(step)
    return {"w": rng.normal(size=(N_DEV, 32)).astype(np.float32),
            "b": {"x": (rng.normal(size=(N_DEV, 5, 3)) * 1e-3)
                  .astype(np.float32)}}


@pytest.mark.parametrize("scale", [1.0, 1e-4, 0.0])
def test_quantize_dequantize_bitwise_reference(scale):
    x = (np.random.default_rng(0).normal(size=(7, 33)) * scale).astype(
        np.float32)
    x[0, 0] = 127.5 * scale / 127  # a code exactly half way
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = j_quant(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(dequantize_int8(q, s).numpy(),
                          np.asarray(j_dequant(jq, js)))


WORKER = """
import numpy as np
import test_torch_compression as T
from repro_torch.optim import CompressionState, compress_error_feedback

state = None
for step in range(T.STEPS):
    g = T.grads(step)
    mine = {"w": torch.from_numpy(g["w"][rank]),
            "b": {"x": torch.from_numpy(g["b"]["x"][rank])}}
    state = state or CompressionState.init(mine)
    out, state = compress_error_feedback(mine, state)
    write_record(out_dir, f"step{step}", {
        "w": out["w"].numpy().tobytes().hex(),
        "x": out["b"]["x"].numpy().tobytes().hex(),
        "ew": state.error["w"].numpy().tobytes().hex(),
        "ex": state.error["b"]["x"].numpy().tobytes().hex()}, rank)
# the bias case over a group of one rank each
groups = [dist.new_group([r]) for r in range(world)]
g = {"w": torch.tensor(T.BIAS_G)}
state = CompressionState.init(g)
outs = []
for _ in range(T.BIAS_STEPS):
    out, state = compress_error_feedback(g, state, groups[rank])
    outs.append(out["w"].numpy().tobytes().hex())
write_record(out_dir, "bias", {"outs": outs}, rank)
dist.destroy_process_group()
"""


def _arr(hexed, shape):
    return np.frombuffer(bytes.fromhex(hexed), np.float32).reshape(shape)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    spawn_world(N_DEV, tmp, WORKER, name="compression")
    return [read_records(tmp, r) for r in range(N_DEV)]


def _reference_steps():
    """The reference's vmap over the "dp" axis, error feedback carried:
    per step (outputs, residuals), each (4, ...)."""
    state = None
    out = []

    def f(gw, gx, ew, ex):
        o, ns = j_compress({"w": gw, "b": {"x": gx}},
                           JState({"w": ew, "b": {"x": ex}}), "dp")
        return o["w"], o["b"]["x"], ns.error["w"], ns.error["b"]["x"]

    for step in range(STEPS):
        g = grads(step)
        if state is None:
            state = (jnp.zeros_like(g["w"]), jnp.zeros_like(g["b"]["x"]))
        ow, ox, ew, ex = jax.vmap(f, axis_name="dp")(
            jnp.asarray(g["w"]), jnp.asarray(g["b"]["x"]), *state)
        state = (ew, ex)
        out.append(tuple(np.asarray(a) for a in (ow, ox, ew, ex)))
    return out


def test_error_feedback_bitwise_reference_vmap(world):
    """Every rank's mean gradient and residual, at each of three steps,
    bitwise the reference's lane of the same rank."""
    want = _reference_steps()
    for step, (ow, ox, ew, ex) in enumerate(want):
        for r in range(N_DEV):
            rec = world[r][f"step{step}"]
            assert np.array_equal(_arr(rec["w"], (32,)), ow[r])
            assert np.array_equal(_arr(rec["x"], (5, 3)), ox[r])
            assert np.array_equal(_arr(rec["ew"], (32,)), ew[r])
            assert np.array_equal(_arr(rec["ex"], (5, 3)), ex[r])


def test_all_ranks_agree_and_stay_close_to_exact(world):
    """Every rank's result is bitwise every other's (one scale, exact
    int32 sums), within 2% of the exact mean (the reference's bar)."""
    for step in range(STEPS):
        recs = [world[r][f"step{step}"] for r in range(N_DEV)]
        assert all(rec["w"] == recs[0]["w"] and rec["x"] == recs[0]["x"]
                   for rec in recs)
        exact = grads(step)["w"].mean(0)
        got = _arr(recs[0]["w"], (32,))
        assert np.abs(got - exact).max() / np.abs(exact).max() < 0.02


def test_error_feedback_reduces_bias_over_steps(world):
    """A constant gradient over a group of one: the time average of the
    compressed estimate converges to it (atol 1e-4), each step bitwise
    the reference's."""
    def f(gw, ew):
        o, ns = j_compress({"w": gw}, JState({"w": ew}), "dp")
        return o["w"], ns.error["w"]

    gs = jnp.asarray([BIAS_G], jnp.float32)
    err = jnp.zeros_like(gs)
    want = []
    for _ in range(BIAS_STEPS):
        out, err = jax.vmap(f, axis_name="dp")(gs, err)
        want.append(np.asarray(out[0]))
    for r in range(N_DEV):
        got = [_arr(h, (3,)) for h in world[r]["bias"]["outs"]]
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        np.testing.assert_allclose(np.mean(got, 0),
                                   np.asarray(BIAS_G, np.float32),
                                   atol=1e-4)
