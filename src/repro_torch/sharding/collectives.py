"""The collectives of sharded serving, over ``torch.distributed``.

Two exchanges carry everything a sharded engine moves between ranks: the
seams' all-gather over the "model" group (``all_gather_cat``) and the
host loop's per-slot results over the data group (``all_gather_cat`` of
the rows, ``broadcast_from`` of one prefill's token, of a checkpoint's
stripe and of a page chain's K/V).  A tensor travels as it is, on the
CPU or on the card: NCCL and gloo both take CUDA tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "broadcast_from"]


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every member's ``x`` of ``group``, concatenated along ``dim`` in
    the group's rank order (the mesh order along its axis)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every member of ``group``."""
    buf = x.contiguous().clone()
    dist.broadcast(buf, src=src, group=group)
    return buf
