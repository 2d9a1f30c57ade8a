"""The collectives of sharded serving and training, over
``torch.distributed``.

Serving moves everything between ranks with two exchanges: the seams'
all-gather over the "model" group (``all_gather_cat``) and the host loop's
per-slot results over the data group (``all_gather_cat`` of the rows,
``broadcast_from`` of one prefill's token, of a checkpoint's stripe and of
a page chain's K/V).  A tensor travels as it is, on the CPU or on the
card: NCCL and gloo both take CUDA tensors.

Training adds the seams with gradients (``gather_seam``, ``reduce_seam``,
``scatter_seam``: autograd Functions of the port's own, whose backward is
the one the gather form needs, see each; ``sum_seam`` for a loss term
built from the batch ranks' sums; ``gather_scatter_seam`` and
``swap_seam`` for the sequence-parallel residual) and the block moves of
ZeRO:
``axis_group`` names the group of one mesh axis or of several flattened,
``gather_block`` rebuilds a leaf from the blocks its spec cut, and
``reduce_block`` sums a gradient over the batch axes into the block a spec
gives the rank (reduce-scatter where the spec cuts a batch axis, ZeRO-2).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "all_to_all_cat", "axis_group",
           "broadcast_from", "gather_block", "gather_block_to_first",
           "gather_scatter_seam", "gather_seam", "reduce_block",
           "reduce_scatter_cat", "reduce_seam", "scatter_seam", "sum_seam",
           "swap_seam"]


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


class _Sum(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the incoming gradient
    summed over the group (``torch.distributed.nn``'s all-reduce).  For a
    loss term every rank computes alike from the group's sum: each rank's
    share of the sum then gets the gradient of every rank's copy of the
    term, and the train step's mean of the ranks' gradients gives the
    term's gradient once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherScatter(torch.autograd.Function):
    """Forward: ``all_gather_cat``.  Backward: the incoming gradient
    reduce-scattered over the group (summed, the rank's block kept): the
    sequence-parallel all-gather before the products of the rank's share
    of heads or columns, whose gradient each rank holds only its share's
    terms of."""

    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.group, ctx.dim, ctx.index = group, dim, index
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_cat(g, ctx.group, ctx.dim, ctx.index), None,
                None, None)


def all_to_all_cat(x: torch.Tensor, group, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
    """``x`` cut into the group's size of blocks along ``split_dim``, block
    j sent to member j, and the blocks received concatenated along
    ``cat_dim`` in the group's rank order (one ``all_to_all_single``)."""
    n = dist.get_world_size(group)
    parts = [p.contiguous() for p in x.chunk(n, dim=split_dim)]
    flat = torch.cat([p.reshape(-1) for p in parts])
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, group=group)
    return torch.cat(list(out.view(n, *parts[0].shape).unbind(0)),
                     dim=cat_dim)


class _Swap(torch.autograd.Function):
    """Forward: ``all_to_all_cat(x, split_dim, cat_dim)``.  Backward: the
    inverse exchange, ``all_to_all_cat(g, cat_dim, split_dim)``."""

    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.split_dim, ctx.cat_dim = group, split_dim, cat_dim
        return all_to_all_cat(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return (all_to_all_cat(g, ctx.group, ctx.cat_dim, ctx.split_dim),
                None, None, None)


class _Scatter(torch.autograd.Function):
    """Forward: block ``index`` of ``n`` along ``dim``.  Backward: the
    members' block gradients all-gathered along ``dim``: downstream of the
    cut each rank holds its own block's gradient (the products of its
    experts, or of its sequence slice), upstream every rank computes the
    whole alike."""

    @staticmethod
    def forward(ctx, x, group, dim, index, n):
        size = x.shape[dim] // n
        ctx.group, ctx.dim = group, dim
        # a copy, so that the whole is freed once nothing else holds it
        return x.narrow(dim, index * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None, None, None


def sum_seam(x, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, whose backward sums the gradient
    over the group; see ``_Sum``."""
    return _Sum.apply(x, group)


def gather_scatter_seam(x, group, dim: int, index: int) -> torch.Tensor:
    """``all_gather_cat`` whose backward reduce-scatters the gradient;
    see ``_GatherScatter``."""
    return _GatherScatter.apply(x, group, dim, index)


def swap_seam(x, group, split_dim: int, cat_dim: int) -> torch.Tensor:
    """``all_to_all_cat`` whose backward is the inverse exchange."""
    return _Swap.apply(x, group, split_dim, cat_dim)


def scatter_seam(x, group, dim: int, index: int, n: int) -> torch.Tensor:
    """Block ``index`` of ``n`` along ``dim``, whose backward all-gathers
    the blocks' gradients; see ``_Scatter``."""
    return _Scatter.apply(x, group, dim, index, n)


def gather_seam(x, group, dim: int, index: int) -> torch.Tensor:
    """``all_gather_cat`` whose backward takes this rank's slice (block
    ``index`` along ``dim``) of the gradient; see ``_Gather``."""
    return _Gather.apply(x, group, dim, index)


def reduce_seam(x, group) -> torch.Tensor:
    """The identity, whose backward sums the gradient over ``group``."""
    return _Reduce.apply(x, group)


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
