"""Int8 gradient compression with error feedback, over
``torch.distributed``.

The PyTorch counterpart of ``repro/optim/compression.py``: the all-reduce
of a gradient over a group (the reference's pod axis, the only traffic
across the slow network) quantized to int8, which cuts its bytes 4x; the
quantization error stays on the rank and is added to the next step's
gradient.  A standalone function, as the reference's: no train-step knob
calls it.

Every rank dequantizes with one scale, the group's largest ``amax``
(an all-reduce ``MAX``), and the int8 codes are summed exactly as int32
(an all-reduce ``SUM``), so every rank's result is the same, bit for bit,
and equals the reference's ``psum`` of the same inputs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .adamw import tree_leaves, tree_map

__all__ = ["CompressionState", "compress_error_feedback", "dequantize_int8",
           "quantize_int8"]


def quantize_int8(x):
    """Per-tensor symmetric int8 quantization: x ~ q * scale.  Returns
    (q int8, scale f32 scalar)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q, scale):
    return q.float() * scale


@dataclass
class CompressionState:
    error: dict  # a tree like the grads: f32 residuals

    @staticmethod
    def init(grads):
        return CompressionState(tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def compress_error_feedback(grads, state: CompressionState, group=None):
    """The mean of ``grads`` over ``group`` (default: the whole world),
    all-reduced as int8 codes with error feedback.  Every rank of the
    group calls it with a tree of the same structure.  Returns (mean
    grads, new state); the leaves go in sorted-key order, one ``MAX`` and
    one ``SUM`` each."""
    n = dist.get_world_size(group)

    def one(g, e):
        gf = g.float() + e
        amax = gf.abs().max().reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax[0], min=1e-30) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        new_e = gf - q * scale  # the residual stays local
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        return (summed.float() * scale / n).to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(state.error))]
    return (_rebuild(grads, iter(o[0] for o in out)),
            CompressionState(_rebuild(grads, iter(o[1] for o in out))))


def _rebuild(tree, leaves):
    """``tree``'s structure over ``leaves`` given in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)
