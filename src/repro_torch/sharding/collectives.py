"""The collectives of sharded serving and training, over
``torch.distributed``.

Serving moves everything between ranks with two exchanges: the seams'
all-gather over the "model" group (``all_gather_cat``) and the host loop's
per-slot results over the data group (``all_gather_cat`` of the rows,
``broadcast_from`` of one prefill's token, of a checkpoint's stripe and of
a page chain's K/V).  A tensor travels as it is, on the CPU or on the
card: NCCL and gloo both take CUDA tensors.

Training adds the seams with gradients (``gather_seam``, ``reduce_seam``,
``slice_seam``: autograd Functions of the port's own, whose backward is
the one the gather form needs, see each) and the block moves of ZeRO:
``axis_group`` names the group of one mesh axis or of several flattened,
``gather_block`` rebuilds a leaf from the blocks its spec cut, and
``reduce_block`` sums a gradient over the batch axes into the block a spec
gives the rank (reduce-scatter where the spec cuts a batch axis, ZeRO-2).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "axis_group", "broadcast_from", "gather_block",
           "gather_block_to_first", "gather_seam", "reduce_block",
           "reduce_scatter_cat", "reduce_seam", "slice_seam"]


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


# ----------------------------------------------------- seams with gradients
class _Gather(torch.autograd.Function):
    """Forward: ``all_gather_cat``.  Backward: the rank's own slice of the
    incoming gradient.  In the gather form every rank of the group runs
    the same computation downstream of the gather, so each holds the whole
    gradient of the gathered tensor already: summing it over the group
    (``torch.distributed.nn``'s backward) would count it once per rank."""

    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size),
                None, None, None)


class _Reduce(torch.autograd.Function):
    """Forward: the identity.  Backward: the incoming gradient summed over
    the group.  It sits where a replicated activation enters the products
    of the rank's share of heads or columns: each rank's gradient there
    holds only its share's terms."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Slice(torch.autograd.Function):
    """Forward: block ``index`` of ``n`` along ``dim``.  Backward: the
    block's gradient in place in zeros of the whole, summed over the group
    (every member's block, each from its owner)."""

    @staticmethod
    def forward(ctx, x, group, dim, index, n):
        size = x.shape[dim] // n
        ctx.group, ctx.dim, ctx.start, ctx.shape = (group, dim, index * size,
                                                    x.shape)
        return x.narrow(dim, index * size, size)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None, None


def gather_seam(x, group, dim: int, index: int) -> torch.Tensor:
    """``all_gather_cat`` whose backward takes this rank's slice (block
    ``index`` along ``dim``) of the gradient; see ``_Gather``."""
    return _Gather.apply(x, group, dim, index)


def reduce_seam(x, group) -> torch.Tensor:
    """The identity, whose backward sums the gradient over ``group``."""
    return _Reduce.apply(x, group)


def slice_seam(x, group, dim: int, index: int, n: int) -> torch.Tensor:
    """Block ``index`` of ``n`` along ``dim``, whose backward sums the
    whole's gradient over ``group``; see ``_Slice``."""
    return _Slice.apply(x, group, dim, index, n)


# ------------------------------------------------------------ ZeRO blocks
def _names(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_group(mesh, axis):
    """The process group of ``axis`` (a mesh axis name, or a tuple of
    names flattened row-major, as a spec entry names them) that holds this
    rank.  A tuple's group is the ``DeviceMesh`` flatten of those axes,
    made on first use by every rank of the mesh and kept by the mesh."""
    names = _names(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if (names == tuple(mesh.mesh_dim_names)
            and mesh.size() == dist.get_world_size()):
        return dist.group.WORLD  # the whole mesh is the whole world
    return mesh[names]._flatten().get_group()


def _size(sizes, axis) -> int:
    n = 1
    for a in _names(axis):
        n *= sizes[a]
    return n


def gather_block(x: torch.Tensor, spec, mesh, sizes: dict) -> torch.Tensor:
    """The whole leaf from this rank's block ``x`` of ``spec``: the blocks
    all-gathered over each cut dim's axis group, dim by dim (a pure copy,
    no arithmetic)."""
    for dim, axis in enumerate(spec):
        if axis is not None and _size(sizes, axis) > 1:
            x = all_gather_cat(x, axis_group(mesh, axis), dim)
    return x


def reduce_scatter_cat(x: torch.Tensor, group, dim: int,
                       index: int) -> torch.Tensor:
    """Block ``index`` (this rank's in ``group``) along ``dim`` of ``x``
    summed over the group: ``reduce_scatter`` of the blocks (gloo takes
    CUDA tensors for it too: torch 2.11, on the card)."""
    size = x.shape[dim] // dist.get_world_size(group)
    parts = [p.contiguous() for p in x.split(size, dim=dim)]
    out = torch.empty_like(parts[index])
    dist.reduce_scatter(out, parts, group=group)
    return out


def reduce_block(g: torch.Tensor, spec, mesh, sizes: dict, coord: dict,
                 batch_axes: tuple, scatter: bool = True) -> torch.Tensor:
    """This rank's block of ``spec`` of the sum of ``g`` (this rank's
    term, whole along every dim ``spec`` cuts) over the ranks of
    ``batch_axes``.  A dim cut over other axes is sliced first.  With
    ``scatter``, a dim that ``spec`` cuts over batch axes is
    reduce-scattered over their group (ZeRO-2) and the sum over the
    batch axes no dim cuts is an all-reduce; without, the sum is one
    all-reduce, sliced after."""
    def index(names):
        i = 0
        for a in names:
            i = i * sizes[a] + coord[a]
        return i

    later, used = [], set()
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        names = _names(axis)
        if not all(a in batch_axes for a in names):
            size = g.shape[dim] // _size(sizes, axis)
            g = g.narrow(dim, index(names) * size, size)
        elif not scatter:
            later.append((dim, axis))
        else:
            if _size(sizes, axis) > 1:
                g = reduce_scatter_cat(g, axis_group(mesh, axis), dim,
                                       index(names))
            used.update(names)
    rest = tuple(a for a in batch_axes if a not in used and sizes[a] > 1)
    if rest:
        g = g.contiguous().clone()
        dist.all_reduce(g, group=axis_group(mesh, rest))
    for dim, axis in later:
        size = g.shape[dim] // _size(sizes, axis)
        g = g.narrow(dim, index(_names(axis)) * size, size)
    return g.contiguous()


def gather_block_to_first(x: torch.Tensor, spec, mesh, sizes: dict):
    """The whole leaf from the blocks of ``spec``, in host memory on the
    mesh's first rank (coordinate 0 on every axis), None on the ranks
    that only sent: for each cut dim in turn, every group of its axis
    whose ranks hold whole blocks of the dims gathered before gathers to
    its first rank (a point-to-point gather: one rank receives)."""
    x = x.detach().cpu()
    for dim, axis in enumerate(spec):
        if axis is None or _size(sizes, axis) == 1:
            continue
        group = axis_group(mesh, axis)
        first = dist.get_rank(group) == 0
        parts = ([torch.empty_like(x) for _ in
                  range(dist.get_world_size(group))] if first else None)
        dist.gather(x.contiguous(), parts, dst=dist.get_global_rank(group, 0),
                    group=group)
        if not first:
            return None  # sent: the rest is the first rank's
        x = torch.cat(parts, dim=dim)
    return x
