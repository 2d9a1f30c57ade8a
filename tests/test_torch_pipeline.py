"""The port's GPipe pipeline, the twin of ``tests/test_pipeline.py``: 4
stages x 2 layers of ``tanh(h @ w + b)`` with 6 microbatches, over a
4-rank gloo world (one stage a rank, a "stage" mesh axis), within 1e-5 of
the sequential stack and of the reference's pipelined forward on the same
numbers; every stage holds the last stage's outputs, and every stage ran
M + S - 1 ticks of one point-to-point exchange each.  The world is
spawned once per module through ``torch_worlds``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_worlds import read_records, spawn_world  # noqa: E402

S, LPS, M, MB, D = 4, 2, 6, 3, 8  # 4 stages x 2 layers, 6 microbatches


def inputs():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(S, LPS, D, D)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(S, LPS, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(M, MB, D)).astype(np.float32)
    return w, b, x


def stage_fn(p, h):
    for wi, bi in zip(p["w"], p["b"]):
        h = torch.tanh(h @ wi + bi)
    return h


def sequential(w, b, x):
    h = torch.from_numpy(x)
    for s in range(S):
        h = stage_fn({"w": torch.from_numpy(w[s]),
                      "b": torch.from_numpy(b[s])}, h)
    return h.numpy()


WORKER = """
import numpy as np
import test_torch_pipeline as T
import repro_torch.sharding.pipeline as pp
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.sharding import make_pipelined_forward

mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("stage",))
w, b, x = T.inputs()
ticks = []
plain = pp.dist.batch_isend_irecv


def counted(ops):
    ticks.append(len(ops))
    return plain(ops)


pp.dist.batch_isend_irecv = counted
fwd = make_pipelined_forward(T.stage_fn, mesh)
out = fwd({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
          torch.from_numpy(x))
write_record(out_dir, "pipeline", {"out": out.numpy().tolist(),
                                   "ticks": ticks}, rank)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    spawn_world(S, tmp, WORKER, name="pipeline")
    return [read_records(tmp, r)["pipeline"] for r in range(S)]


def test_pipeline_matches_sequential(world):
    w, b, x = inputs()
    want = sequential(w, b, x)
    for rec in world:
        got = np.asarray(rec["out"], np.float32)
        assert np.abs(got - want).max() < 1e-5
        assert got.tolist() == world[-1]["out"]  # the last stage's, bitwise


def test_pipeline_runs_every_tick_on_every_stage(world):
    """M + S - 1 ticks, each one batched exchange: a send to the next
    stage and a receive from the previous one (the first stage only
    sends, the last only receives), drain bubble included."""
    for stage, rec in enumerate(world):
        want = (stage > 0) + (stage < S - 1)
        assert rec["ticks"] == [want] * (M + S - 1)


def test_pipeline_matches_reference_pipeline(world, tmp_path):
    """The reference's ``make_pipelined_forward`` in a subprocess with four
    host devices, on the same numbers: within 1e-5."""
    import subprocess
    import sys

    prog = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={S}"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import sys
sys.path[:0] = ["src", "tests"]
import jax, jax.numpy as jnp, numpy as np
from repro.compat import AxisType, make_mesh
from repro.sharding.pipeline import make_pipelined_forward
import test_torch_pipeline as T
w, b, x = T.inputs()

def stage_fn(p, h):
    def layer(h, wb):
        return jnp.tanh(h @ wb[0] + wb[1]), None
    return jax.lax.scan(layer, h, (p["w"], p["b"]))[0]

mesh = make_mesh((T.S,), ("stage",), axis_types=(AxisType.Explicit,))
out = jax.jit(make_pipelined_forward(stage_fn, mesh))(
    {{"w": jnp.asarray(w), "b": jnp.asarray(b)}}, jnp.asarray(x))
np.save(sys.argv[1], np.asarray(out))
"""
    path = str(tmp_path / "reference.npy")
    p = subprocess.run([sys.executable, "-c", prog, path],
                       capture_output=True, text=True, timeout=560, cwd=".")
    assert p.returncode == 0, p.stderr[-3000:]
    want = np.load(path)
    got = np.asarray(world[0]["out"], np.float32)
    assert np.abs(got - want).max() < 1e-5
