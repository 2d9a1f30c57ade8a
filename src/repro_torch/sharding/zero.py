"""Sharded training over a mesh of ranks: the gather-form train step with
ZeRO data parallelism.

``runtime.steps.make_train_step`` builds a ``ShardedTrainStep`` when the
model's ``knobs.shard_fn`` is a ``TrainShardFn`` (``make_shard_fn(mesh,
cfg)``), as the reference's step runs sharded when its model carries the
mesh's hook.  A state over a mesh holds, for every leaf, the block that
its spec gives the rank (``train_state_shardings``: the params by
``param_shardings``, the master and moments by ``opt_state_shardings``).

One step:

1. every leaf the rank computes with is rebuilt from its stored block:
   the gather form's cut (``rules.serve_cut``: heads, MLP columns and
   experts over "model", everything else whole) of the leaf gathered in
   full where its stored spec differs;
2. the rank takes its rows of each microbatch (``batch_shardings``, the
   reference's "microbatch" seam: microbatch i is rows [i n, (i + 1) n)
   of the global batch, cut over the batch axes) and runs the loss and
   its backward through the seams of ``TrainShardFn``;
3. each gradient leaf is made whole over "model" (gathered where the
   gather form cut it), then summed over the batch axes: with
   ``grad_shardings`` (ZeRO-2) reduce-scattered into the rank's block of
   its spec each microbatch and accumulated there, else accumulated whole
   and all-reduced once; divided by the batch ranks and by
   ``grad_accum``;
4. AdamW updates the rank's blocks of the master and moments, clipped by
   the global norm summed over the ranks that own each block;
5. the new master is gathered and cut back into the stored params.

Each rank's loss is the mean over its rows; every row has the same number
of target tokens, so the mean over the batch ranks is the global batch's.
An MoE's load-balance loss is a product of batch means: its two means are
the global batch's on every rank (``TrainShardFn``'s "moe_batch_mean"),
as the reference's GSPMD step takes them.

With the sequence-parallel residual (``make_shard_fn(sp=True)``) the
norms, ``wo`` and ``w_down`` run on the rank's sequence slice, so their
gradients (``rules.sp_partial``) are also summed over "model" in step 3.
"""
from __future__ import annotations

import torch

from ..optim.adamw import adamw_update
from .collectives import (axis_group, gather_block, gather_block_to_first,
                          reduce_block)
from .rules import (TrainShardFn, _param_spec,
                    batch_axes, batch_shardings, head_layout, kv_narrowed,
                    local_cfg, mesh_coord, mesh_sizes, param_shapes,
                    serve_cut, shard_block, sp_partial,
                    train_state_shardings)

__all__ = ["ShardedTrainStep", "gather_state", "is_sharded", "shard_state",
           "state_shardings_of"]


def is_sharded(model) -> bool:
    """Whether ``model`` trains over a mesh (its seams' hook is a
    ``TrainShardFn``)."""
    return isinstance(model.knobs.shard_fn, TrainShardFn)


def state_shardings_of(model, state_shardings=None):
    """``state_shardings``, or the default layout of ``model``'s mesh:
    ``train_state_shardings(mesh, cfg, params, fsdp=False, layout)``."""
    if state_shardings is not None:
        return state_shardings
    fn = model.knobs.shard_fn
    return train_state_shardings(fn.mesh, model.cfg, param_shapes(model.cfg),
                                 layout=fn.layout)


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts, paths as the rules write them, in
    sorted-key order (``tree_leaves``'s)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def shard_state(full, shardings, mesh):
    """This rank's blocks of a whole state (or any tree) under
    ``shardings`` (a spec tree of the same structure): contiguous copies,
    or the leaf itself where its spec cuts nothing."""
    sizes, coord = mesh_sizes(mesh), mesh_coord(mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        out = shard_block(tree, spec, sizes, coord)
        return out.contiguous() if out is not tree else tree

    return walk(full, shardings)


def gather_state(state, shardings, mesh, *, first_only: bool = False):
    """The whole tree from every rank's blocks (every rank of the mesh
    calls it: the gathers are collectives).  ``first_only``: the whole
    leaves in host memory on the mesh's first rank alone (None leaves on
    the others), each rank sending its blocks once (a checkpoint's
    save)."""
    sizes = mesh_sizes(mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if first_only:
            return gather_block_to_first(tree, spec, mesh, sizes)
        return gather_block(tree, spec, mesh, sizes)

    return walk(state, shardings)


class ShardedTrainStep:
    """``train_step(state, batch) -> (state, metrics)`` over the mesh of
    ``model.knobs.shard_fn`` (see the module docstring).  ``batch`` is the
    global batch, the same on every rank; the metrics are the batch
    ranks' means, the same on every rank."""

    def __init__(self, model, opt_cfg, grad_accum, accum_dtype, schedule,
                 grad_shardings=None, state_shardings=None,
                 batch_shardings=None):
        fn = model.knobs.shard_fn
        self.mesh, self.layout = fn.mesh, fn.layout
        self.sizes, self.coord = mesh_sizes(self.mesh), mesh_coord(self.mesh)
        self.opt_cfg, self.grad_accum = opt_cfg, grad_accum
        self.accum_dtype, self.schedule = accum_dtype, schedule
        self.batch_specs = batch_shardings
        self.batch_axes = batch_axes(self.mesh, self.layout)
        self.n_batch = 1
        for a in self.batch_axes:
            self.n_batch *= self.sizes[a]
        cfg = model.cfg
        shapes = _flat(param_shapes(cfg))
        specs = state_shardings_of(model, state_shardings)
        self.pspec = _flat(specs["params"])
        self.ospec = _flat(specs["opt"]["master"])
        self.gspec = (None if grad_shardings is None
                      else _flat(grad_shardings))
        tp = self.layout != "dp" and self.sizes.get("model", 1) > 1
        self.tp, self.full_kv = tp, cfg.num_kv_heads
        # the axes each leaf's gradient is summed over (step 3)
        self.sum_axes = {k: self.batch_axes + (("model",) if fn.sp
                                               and sp_partial(k) else ())
                         for k in shapes}
        self.kv_range = (head_layout(cfg, self.sizes, self.coord["model"],
                                     fn.cuts)[1] if tp else None)
        # the gather form's spec of each leaf (None: kv-narrowed, no spec)
        self.cspec = {}
        for k, leaf in shapes.items():
            spec = (_param_spec(self.sizes, k, leaf.shape) if tp
                    else (None,) * leaf.ndim)
            narrowed = kv_narrowed(k, spec, self.kv_range, leaf.shape)
            self.cspec[k] = None if narrowed else spec
        self.local = type(model)(
            local_cfg(cfg, self.sizes, self.coord.get("model", 0), fn.cuts)
            if tp else cfg, model.knobs, model.device)
        self._world = axis_group(self.mesh, tuple(self.mesh.mesh_dim_names))

    # ------------------------------------------------------------ blocks
    def _whole(self, x, spec):
        return gather_block(x, spec, self.mesh, self.sizes)

    def _reblock(self, x, src, dst):
        """Block ``x`` of spec ``src`` as the rank's block of ``dst``: a
        dim both cut alike stays as it is, a dim ``src`` cuts otherwise is
        gathered over its axis, then cut as ``dst`` cuts it."""
        if tuple(src) == tuple(dst):
            return x
        for dim, (a, b) in enumerate(zip(src, dst)):
            if a is not None and a != b:
                x = gather_block(x, (None,) * dim + (a,), self.mesh,
                                 self.sizes)
        cut = tuple(b if b != a else None for a, b in zip(src, dst))
        return shard_block(x, cut, self.sizes, self.coord).contiguous()

    def _compute_params(self, params):
        """The leaves the rank computes with (the gather form's cut)."""
        out = {}
        for k, x in _flat(params).items():
            c = self.cspec[k]
            if c is not None:
                out[k] = self._reblock(x, self.pspec[k], c)
            else:  # kv-narrowed
                out[k] = serve_cut(k, self._whole(x, self.pspec[k]),
                                   self.sizes, self.coord, self.kv_range)
        return out

    def _to_block(self, k, g, spec, scatter=True):
        """This rank's block of ``spec`` of the batch ranks' sum of ``g``
        (this rank's gradient of leaf ``k`` in the gather form's cut).  A
        dim the gather form cuts over "model" as ``spec`` does stays as
        it is; one it cuts otherwise is gathered whole first."""
        c = self.cspec[k]
        if c is None:
            g, c = self._model_whole(k, g), (None,) * g.ndim
        spec = list(spec)
        for dim, a in enumerate(c):
            if a is None:
                continue
            if spec[dim] == a:
                spec[dim] = None  # already this rank's block
            else:
                g = gather_block(g, (None,) * dim + (a,), self.mesh,
                                 self.sizes)
        return reduce_block(g, tuple(spec), self.mesh, self.sizes,
                            self.coord, self.sum_axes[k], scatter)

    def _model_whole(self, k, g):
        """A kv-narrowed gradient leaf whole over the KV heads: several
        ranks read each KV head, so their terms are summed over "model"
        (still this rank's term of the batch sum)."""
        k0, k1 = self.kv_range
        dim = g.ndim - 2
        shape = list(g.shape)
        shape[dim] = self.full_kv
        full = g.new_zeros(shape)
        full.narrow(dim, k0, k1 - k0).copy_(g)
        torch.distributed.all_reduce(full, group=self.mesh.get_group("model"))
        return full

    # -------------------------------------------------------------- step
    def _rows(self, batch, lo, hi):
        """The rank's rows of global rows [lo, hi) of ``batch``."""
        mb = {k: torch.as_tensor(v)[lo:hi] for k, v in batch.items()}
        specs = self.batch_specs or batch_shardings(self.mesh, mb,
                                                    self.layout)
        return {k: shard_block(v, specs[k], self.sizes, self.coord).to(
            self.local.device) for k, v in mb.items()}

    def grads(self, state, batch):
        """(this rank's blocks of the step's gradient under
        ``opt_state_shardings``, keyed by path; the metrics): steps 1-3 of
        the module docstring."""
        from ..runtime.steps import _value_and_grad

        compute = self._compute_params(state["params"])
        tree = _unflatten_paths(list(compute), list(compute.values()))
        keys = list(_flat(tree))  # the order of its leaves' gradients
        b = next(iter(batch.values())).shape[0]
        n = b // self.grad_accum
        zero2 = self.gspec is not None
        acc, ms = None, []
        for i in range(self.grad_accum):
            mb = self._rows(batch, i * n, (i + 1) * n)
            _, m, grads = _value_and_grad(self.local, tree, mb)
            if zero2:  # reduce-scatter each microbatch into the shard
                grads = [self._to_block(k, g.to(self.accum_dtype),
                                        self.gspec[k])
                         for k, g in zip(keys, grads)]
            else:
                grads = [g.to(self.accum_dtype) for g in grads]
            if acc is None:
                acc = grads
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
            ms.append(m)
        scale = self.n_batch * self.grad_accum
        grads = {}
        for k, g in zip(keys, acc):
            if zero2:
                g = self._reblock(g, self.gspec[k], self.ospec[k])
            else:  # one all-reduce of the accumulated gradient
                g = self._to_block(k, g, self.ospec[k], scatter=False)
            grads[k] = g.div_(scale)
        return grads, self._mean_metrics(ms)

    def whole_grads(self, state, batch):
        """(the step's whole gradient tree, the same on every rank; the
        metrics), without updating the state."""
        grads, metrics = self.grads(state, batch)
        keys = sorted(grads)
        return _unflatten_paths(keys, [self._whole(grads[k], self.ospec[k])
                                       for k in keys]), metrics

    def __call__(self, state, batch):
        params = state["params"]
        grads, metrics = self.grads(state, batch)
        keys = sorted(grads)
        norm = self._global_norm(grads)
        master = _unflatten_paths(keys, [grads[k] for k in keys])
        new_master, opt, om = adamw_update(master, state["opt"],
                                           self.opt_cfg, self.schedule,
                                           norm=norm)
        with torch.no_grad():
            flat_p, flat_m = _flat(params), _flat(new_master)
            for k in keys:
                p = flat_p[k]
                p.copy_(self._reblock(flat_m[k], self.ospec[k],
                                      self.pspec[k]).to(p.dtype))
        metrics.update(om)
        return {"params": params, "opt": opt}, metrics

    def _mean_metrics(self, ms):
        """The microbatches' means of each metric (``loss``: their summed
        loss over ``grad_accum``), averaged over the batch ranks."""
        names = sorted(ms[0])
        vals = torch.stack([torch.stack([m[k].float() for k in names])
                            for m in ms])
        local = vals.sum(0) / len(ms)
        if self.n_batch > 1:
            local = local.contiguous().clone()
            torch.distributed.all_reduce(
                local, group=axis_group(self.mesh, self.batch_axes))
            local = local / self.n_batch
        return {k: local[i] for i, k in enumerate(names)}

    def _global_norm(self, grads):
        """sqrt of the sum of squares of every leaf over the ranks that own
        its blocks (coordinate 0 on each axis the leaf's spec does not
        cut), summed leaf by leaf in sorted-key order on every rank."""
        parts = []
        for k in sorted(grads):
            named = {a for e in self.ospec[k] if e is not None
                     for a in (e if isinstance(e, tuple) else (e,))}
            owner = all(self.coord[a] == 0 for a in self.sizes
                        if a not in named)
            g = grads[k].float()
            parts.append(torch.sum(g * g) if owner
                         else torch.zeros((), device=g.device))
        sq = torch.stack(parts).contiguous()
        torch.distributed.all_reduce(sq, group=self._world)
        total = 0
        for s in sq:
            total = total + s
        return torch.sqrt(torch.as_tensor(total))


def _unflatten_paths(keys, leaves):
    """A tree of dicts from ``keys`` (paths) and ``leaves`` in that
    order."""
    out: dict = {}
    for k, v in zip(keys, leaves):
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out
