"""Serving meshes and scheduler-driven submeshes over ``torch.distributed``.

The PyTorch counterpart of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialized process
group, with the reference's axis names: ``("data", "model")`` or
``("pod", "data", "model")``.  Every rank holds plain local tensors, so the
mesh only names which ranks exchange what: "model" carries the
gather-form tensor parallelism of ``sharding/rules.py`` and the leading
data axes carry the decode slots and the KV page sub-pools.

The mesh's device type names the backend of its collectives: "cpu" under
gloo (and the fake backend), "cuda" under NCCL.  ``make_production_mesh``
is the reference's production mesh for the dry run: 16 x 16 ("data",
"model"), or 2 x 16 x 16 ("pod", "data", "model"), over a world of 256 or
512 ranks, which ``fake_world`` provides in one process: the "fake"
backend, whose collectives return at once and move nothing.
"""
from __future__ import annotations

import contextlib
import math
import os
import sys

import torch.distributed as dist

__all__ = ["data_group", "fake_world", "leave_world", "make_job_mesh",
           "make_production_mesh", "make_serve_mesh", "mesh_device_type",
           "placement_mesh_shape", "submesh_for_placement"]


def leave_world() -> None:
    """End a launcher process that is in a process group, once its work is
    done: the group destroyed, the output flushed, then ``os._exit(0)``,
    with no interpreter exit.  A process in no group returns.

    A ``DeviceMesh`` (and whatever keeps one: a shard function, a step
    cache) keeps its process groups alive past ``destroy_process_group()``,
    and with them gloo's worker threads.  A worker thread drops its last
    reference to a finished collective after the waiting rank has moved
    on; if the interpreter is finalizing by then, releasing the tensor's
    Python object takes the GIL, which CPython 3.12 answers by ending the
    thread with ``pthread_exit``, whose unwind through a ``noexcept`` frame
    aborts the process (SIGABRT, "terminate called without an active
    exception") after its output was written.  The launchers leave the
    group they joined to this function when their work succeeded (and
    destroy it themselves when it raised)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def mesh_device_type() -> str:
    """The DeviceMesh device type of the process group's backend: "cuda"
    under NCCL, "cpu" otherwise (gloo)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _axes(n_dims: int) -> tuple:
    return ("pod", "data", "model") if n_dims == 3 else ("data", "model")


def _device_mesh(shape, axes, ranks=None):
    """A DeviceMesh of ``shape`` over ``ranks`` (default: every rank, in
    order)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(math.prod(shape))) if ranks is None else list(ranks)
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    return DeviceMesh(mesh_device_type(), grid, mesh_dim_names=axes)


def make_serve_mesh(shape):
    """Mesh for one sharded ``ServeEngine`` replica.

    ``shape`` is ``(data, model)`` or ``(pod, data, model)``.  Every rank of
    the process group is one device of the mesh, so the product of the
    shape must equal the world size: a misconfigured ``--mesh-shape``
    fails at engine construction, not at its first collective."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape must be (data, model) or "
                         f"(pod, data, model) of positive ints: {shape}")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world or not dist.is_initialized():
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"{world} visible (ranks of the initialized "
                         f"process group)")
    return _device_mesh(shape, _axes(len(shape)))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) ("data", "model") for one
    pod of 256 devices, (2, 16, 16) ("pod", "data", "model") for two.
    Its size must be the world's (``fake_world(256)`` or ``(512)`` for the
    dry run).  On H100 hosts of 8 the model axis of 16 spans two hosts:
    the dry run keeps the reference's shape so that its rows compare with
    the reference's, and shows what that costs on this card."""
    return make_serve_mesh((2, 16, 16) if multi_pod else (16, 16))


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A process group of ``n`` ranks in this one process, this process
    being ``rank``: the "fake" backend (``torch.testing``'s ``FakeStore``),
    whose collectives return at once and move nothing, for tracing a
    rank's step (``launch/dryrun.py``).  Refuses if a process group
    already exists (the default group is process-global: a test worker
    runs many tests in one process), and always destroys the group on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process "
                           "group; one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def data_group(mesh):
    """The process group over the mesh's data axes ("data", or "pod" and
    "data" flattened, row-major) that holds this rank, its members in host
    order.  The flattened group is DeviceMesh's own, made on the first
    call by the mesh's ranks and kept by the mesh."""
    if "pod" in mesh.mesh_dim_names:
        return mesh["pod", "data"]._flatten().get_group()
    return mesh.get_group("data")


def _split(per_pod: int, max_model: int) -> tuple:
    """(data, model): model is the largest power of two up to
    ``max_model`` that divides ``per_pod``."""
    model = 1
    while model * 2 <= max_model and per_pod % (model * 2) == 0:
        model *= 2
    return per_pod // model, model


def make_job_mesh(n_chips: int, *, n_pods: int = 1, max_model: int = 16):
    """Mesh for a gang of ``n_chips`` ranks (scheduler jobs, examples,
    tests): the model axis is the largest power-of-2 divisor up to
    ``max_model``, the remaining ranks are data (and pod, when the
    placement spans pods)."""
    assert n_chips % n_pods == 0
    data, model = _split(n_chips // n_pods, max_model)
    shape = (n_pods, data, model) if n_pods > 1 else (data, model)
    return make_serve_mesh(shape)


def placement_mesh_shape(placement, cluster, *, max_model: int = 16):
    """The mesh shape ``submesh_for_placement`` builds for a Scylla
    placement: pods spanned become the "pod" axis (flat when the gang
    does not divide over them), then data and model per pod."""
    pods = sorted({cluster.hosts[a].agent.pod_id
                   for a in placement.assignment})
    n_chips = sum(placement.assignment.values())
    n_pods = len(pods)
    if n_chips % n_pods != 0:
        n_pods = 1  # ragged across pods: treat as flat
    data, model = _split(n_chips // n_pods, max_model)
    return (n_pods, data, model) if n_pods > 1 else (data, model)


def submesh_for_placement(placement, cluster, ranks=None, *,
                          max_model: int = 16):
    """A mesh over the first ranks of ``ranks`` (default: the process
    group's) shaped for a Scylla placement.  Every rank of the default
    group must call it, as every DeviceMesh construction."""
    shape = placement_mesh_shape(placement, cluster, max_model=max_model)
    n = math.prod(shape)
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    assert len(ranks) >= n, "not enough ranks for the gang"
    return _device_mesh(shape, _axes(len(shape)), ranks[:n])
