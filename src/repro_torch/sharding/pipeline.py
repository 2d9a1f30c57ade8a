"""GPipe-style pipeline parallelism over a "stage" mesh axis.

The PyTorch counterpart of ``repro/sharding/pipeline.py``.  Each rank of
the stage group holds one stage's slice of the layers; microbatches flow
stage to stage over M + S - 1 ticks (the last S - 1 the drain bubble),
each stage sending its activation to the next with point-to-point
``isend``/``irecv``.  The reference's schedule is one scan whose body is a
stage compute and a collective-permute; here every tick is a stage
compute and one batched exchange, and every stage posts the same sends
and receives on every tick, bubble included, so no stage waits on a
message that is never sent.  Under gloo a card's activations travel
through host buffers (gloo's point-to-point takes host tensors).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .rules import mesh_coord, mesh_sizes

__all__ = ["make_pipelined_forward", "pipeline_apply"]


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, group,
                   *, stage: int, n_stages: int, ranks: list):
    """Run ``microbatches`` through every stage of ``group``.

    stage_fn:      (params of one stage, x) -> x (the same shape)
    stage_params:  this rank's stage slice
    microbatches:  (M, mb, ...), the same on every stage; stage 0 feeds
                   microbatch t at tick t (zeros once the feed is out)
    stage, n_stages, ranks: this rank's stage, the stage count and the
                   global ranks of the stages in order

    Returns (M, mb, ...): the last stage's outputs in microbatch order
    (valid on the last stage; zeros on the others, as the reference's)."""
    m = microbatches.shape[0]
    mb_shape = microbatches.shape[1:]
    inflight = torch.zeros(mb_shape, dtype=microbatches.dtype,
                           device=microbatches.device)
    outputs = torch.zeros_like(microbatches)
    nxt = ranks[stage + 1] if stage + 1 < n_stages else None
    prv = ranks[stage - 1] if stage > 0 else None
    # gloo sends and receives host tensors only: a card's activations
    # travel through host buffers there
    wire = ("cpu" if dist.get_backend(group) == "gloo"
            else microbatches.device)
    for t in range(m + n_stages - 1):
        if stage == 0:
            x = (microbatches[t] if t < m
                 else torch.zeros_like(microbatches[0]))
        else:
            x = inflight
        y = stage_fn(stage_params, x)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outputs[t - n_stages + 1] = y
        # every stage ships its activation rightwards for the next tick
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.to(wire).contiguous(), nxt,
                                  group))
        if prv is not None:
            recv = torch.empty(mb_shape, dtype=y.dtype, device=wire)
            ops.append(dist.P2POp(dist.irecv, recv, prv, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if prv is not None:
            inflight = recv.to(microbatches.device)
    return outputs


def make_pipelined_forward(stage_fn: Callable, mesh, *,
                           axis_name: str = "stage"):
    """``f(stacked_params, microbatches) -> (M, mb, ...)`` over ``mesh``'s
    ``axis_name`` axis: ``stacked_params``' leaves have a leading dim of
    the stage count, of which each rank runs its own slice; the last
    stage's outputs come back to every stage (the reference's masked
    psum: a sum over the stages of the last stage's outputs and the
    others' zeros)."""
    n = mesh_sizes(mesh)[axis_name]
    stage = mesh_coord(mesh)[axis_name]
    group = mesh.get_group(axis_name)
    ranks = dist.get_process_group_ranks(group)

    def slice_stage(tree):
        if isinstance(tree, dict):
            return {k: slice_stage(v) for k, v in tree.items()}
        return tree[stage]

    def fwd(params, microbatches):
        out = pipeline_apply(stage_fn, slice_stage(params), microbatches,
                             group, stage=stage, n_stages=n, ranks=ranks)
        mask = float(stage == n - 1)
        out = (out * mask).contiguous()
        dist.all_reduce(out, group=group)
        return out

    return fwd
