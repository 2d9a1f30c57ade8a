"""Ranks that leave their world without interpreter exit, on one- and
two-rank worlds.  A ``DeviceMesh`` alive at interpreter exit keeps gloo's
worker threads running, and one that frees a collective's tensor while
the interpreter finalizes kills the rank with SIGABRT after its work is
done.  So a worker of the spawned-world harness (``tests/torch_worlds.py``)
that ran its code to the end leaves at once, its output and records whole,
and a rank that raises still fails the world; and the launchers
(``launch.serve``, ``launch.train``) leave a world they joined the same
way (``launch.mesh.leave_world``)."""
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_worlds import WorldFailed, read_records, spawn_world  # noqa: E402

WORKER = """
import atexit
from torch.distributed.device_mesh import DeviceMesh

mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("x",))
t = torch.full((4,), float(rank + 1))
dist.all_reduce(t, group=mesh.get_group("x"))
atexit.register(lambda: open(os.path.join(out_dir, f"atexit{rank}"), "w"))
print("rank", rank, "sum", t.tolist())
write_record(out_dir, "sum", {"sum": t.tolist()}, rank)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("n", [1, 2])
def test_rank_ends_without_interpreter_exit(tmp_path, n):
    """Every rank's stdout and record arrive; no rank ran its ``atexit``
    hooks, so nothing of interpreter exit ran beside the mesh's gloo
    threads."""
    outs = spawn_world(n, tmp_path, WORKER, name="ends")
    total = float(sum(range(1, n + 1)))
    for r in range(n):
        assert outs[r] == f"rank {r} sum {[total] * 4}\n"
        assert read_records(tmp_path, r)["sum"] == {"sum": [total] * 4}
        assert not (tmp_path / f"atexit{r}").exists()


def test_rank_that_raises_fails_the_world(tmp_path):
    """A rank that raises after the mesh's collective exits 1 with its
    traceback (not SIGABRT in interpreter exit), and fails the world."""
    with pytest.raises(WorldFailed, match=r"exits \[0, 1\](.|\n)*boom"):
        spawn_world(2, tmp_path, WORKER + "\nif rank == 1:\n"
                    "    raise RuntimeError('boom')\n", name="raises")


# runs a launcher as ``python -m`` does, with an atexit hook in front
LAUNCH = """
import atexit, os, runpy, sys
sys.path.insert(0, "src")
atexit.register(lambda: open(os.path.join(os.environ["DIR"],
                                          "atexit" + os.environ["RANK"]),
                             "w"))
runpy.run_module(sys.argv.pop(1), run_name="__main__", alter_sys=True)
"""
LAUNCHERS = {
    "serve": ("repro_torch.launch.serve", "--tp", "2", "--requests", "2",
              "--cache", "paged", "--page-size", "8"),
    "train": ("repro_torch.launch.train", "--steps", "2"),
}


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_launcher_leaves_its_world_without_interpreter_exit(tmp_path, name):
    """A 2-rank world of the launcher: both ranks exit 0, rank 0 prints
    its report, and no rank ran its ``atexit`` hooks."""
    module, *args = LAUNCHERS[name]
    outs = spawn_world(2, tmp_path, argv=[
        sys.executable, "-c", LAUNCH, module, "--arch", "internlm2-1.8b",
        "--smoke", "--device", "cpu", *args, "--dist-init",
        f"file://{tmp_path}/launcher.rendezvous"], name=f"{name}-leaves")
    assert outs[0] and outs[1] == ""
    for r in range(2):
        assert not (tmp_path / f"atexit{r}").exists()
