"""Serving sharding rules (gather-form tensor parallelism) over a mesh.

The PyTorch counterpart of the serving half of ``repro/sharding/rules.py``.
A spec is a tuple with one entry per dim: ``None`` (replicated), an axis
name, or a tuple of axis names, as the entries of the reference's
``PartitionSpec``.  Specs are computed from the mesh's axis sizes (a
``DeviceMesh`` or a plain ``{axis: size}`` mapping), so that they can be
held to the reference's on an abstract mesh without devices.

The layout (the reference's block comment): serving promises bitwise the
unsharded engine's output on any mesh, so every product whose contraction
dim would be sharded keeps that operand replicated and its activation is
all-gathered first (the ``attn_out`` / ``mlp_up`` / ``moe_expert_out``
seams of ``models/``).  Sharded: the QKV projections and per-head
attention over the KV cache (heads over "model"), the MLP up/gate columns
(ff over "model"), the per-expert MoE products (experts over "model"), and
the decode slots and the paged pool's pages over the data axes.
Replicated, in single-device order: ``wo``, ``w_down``, the MoE combine,
the norms and the unembedding.

In ``torch.distributed`` each rank holds plain local tensors:
``shard_params`` cuts a rank's shard from the full parameter tree, and
``ServeShardFn`` is the seams' hook, which gathers over the mesh's
"model" group.

The training half (the reference's ``param_shardings``,
``opt_state_shardings``, ``grad_shardings``, ``batch_shardings``,
``cache_shardings`` and ``make_shard_fn``'s seam specs) gives the same
spec tuples as the reference's.  A sharded train step
(``runtime.steps.make_train_step``) stores each leaf of its state as the
block its spec gives the rank, and computes in the gather form above
(``TrainShardFn``): the specs say where a leaf lives between steps, the
gather form how the forward and backward run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .collectives import all_gather_cat, gather_seam, reduce_seam, slice_seam

__all__ = ["ServeShardFn", "TrainShardFn", "batch_shardings",
           "block_index", "cache_shardings", "grad_shardings", "head_layout",
           "local_caches", "local_cfg", "make_shard_fn", "mesh_coord",
           "mesh_sizes", "model_cuts", "opt_state_shardings",
           "param_shardings", "serve_batch_sharding",
           "serve_cache_shardings", "serve_param_shardings", "shard_block",
           "shard_params", "train_seam_spec", "train_state_shardings"]


# --------------------------------------------------------------- utilities
def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (or of a mapping, as given)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coord(mesh) -> dict:
    """``{axis: index}`` of this rank on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _axis_size(mesh, axis) -> int:
    sizes = mesh_sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _fits(mesh, shape, spec) -> bool:
    for dim, axis in zip(shape, spec):
        if axis is not None and dim % _axis_size(mesh, axis) != 0:
            return False
    return True


def _choose(mesh, shape, *candidates) -> tuple:
    """First candidate whose named axes all divide evenly; else drop axes."""
    for spec in candidates:
        if len(spec) == len(shape) and _fits(mesh, shape, spec):
            return tuple(spec)
    # last resort: keep only the axes that fit, dim by dim
    spec = candidates[0] if candidates else (None,) * len(shape)
    return tuple(a if (a is not None and dim % _axis_size(mesh, a) == 0)
                 else None for dim, a in zip(shape, spec))


def _dp_axes(mesh):
    axes = [a for a in ("pod", "data") if a in mesh_sizes(mesh)]
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


_SEMANTIC_RANK = {
    "table": 2, "head": 2, "wq": 3, "wk": 3, "wv": 3, "wo": 3,
    "bq": 2, "bk": 2, "bv": 2, "router": 2, "in_proj": 2, "out_proj": 2,
    "w_gate": 2, "w_up": 2, "w_down": 2,  # dense MLP (moe overrides to 3)
    "conv_w": 2, "conv_b": 1, "A_log": 1, "dt_bias": 1, "D": 1,
    "norm_scale": 1, "scale": 1,
}


def _map_with_path(fn, tree, path=""):
    """``fn(path, leaf)`` over a tree of dicts (and lists), the path the
    reference's ``_path_str`` gives ("blocks/stack/attn/wq")."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return fn(path, tree)


# ------------------------------------------------- serving (gather-form TP)
def _serve_trailing_spec(pstr: str, key: str, shape, mesh) -> tuple:
    def c(*cands):
        return _choose(mesh, shape, *cands)

    if key == "wq":  # (dm, H, hd): shard heads
        return c((None, "model", None), (None, None, None))
    if key in ("wk", "wv"):  # (dm, KV, hd)
        return c((None, "model", None), (None, None, None))
    if key in ("bq", "bk", "bv"):  # (H|KV, hd)
        return c(("model", None), (None, None))
    if "moe" in pstr and key in ("w_gate", "w_up", "w_down"):
        # (E, dm, dff) / (E, dff, dm): the expert is a batch dim of the
        # per-expert products, so sharding E is reduction-free
        return c(("model", None, None), (None, None, None))
    if key in ("w_gate", "w_up"):  # mlp (dm, ff): columns independent
        return c((None, "model"), (None, None))
    # wo, w_down, router, embed table/head, norms, ssm leaves: replicated,
    # these feed (or are) the contractions that must keep reduction order
    return (None,) * len(shape)


def _param_spec(mesh, pstr: str, shape) -> tuple:
    key = pstr.rsplit("/", 1)[-1]
    if "moe" in pstr and key in ("w_gate", "w_up", "w_down"):
        rank = 3
    else:
        rank = _SEMANTIC_RANK.get(key, len(shape))
    lead = len(shape) - rank  # stacked layer dims, never sharded
    tail = _serve_trailing_spec(pstr, key, tuple(shape[lead:]), mesh)
    return (None,) * lead + tuple(tail)


def serve_param_shardings(mesh, cfg, params):
    """The gather-form parameter layout: a spec per leaf of ``params``
    (tensors, or anything with a ``.shape``)."""
    return _map_with_path(lambda p, leaf: _param_spec(mesh, p, leaf.shape),
                          params)


def serve_cache_shardings(mesh, caches, *, paged: bool = False):
    """Serving-cache layout: slots (dense) or pages (paged) over the data
    axes, KV heads over "model", never the sequence dim.  Dense attention
    leaves are (L..., B, S, KV, hd), paged pools (L..., P, page_size, KV,
    hd) with their scales (hd == 1) laid out with their pages; SSM state
    and conv leaves shard the batch dim only."""
    dp = _dp_axes(mesh)

    def spec_for(pstr, leaf):
        key = pstr.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        if key in ("k", "v", "k_scale", "v_scale"):
            lead = len(shape) - 4  # (B|P, S|page_size, KV, hd|1)
            base = (None,) * lead
            cands = []
            if dp:
                cands.append(base + (dp, None, "model", None))
                cands.append(base + (dp, None, None, None))
            cands.append(base + (None, None, "model", None))
            cands.append((None,) * len(shape))
            return _choose(mesh, shape, *cands)
        if key in ("state", "conv") and dp:
            lead = len(shape) - (4 if key == "state" else 3)
            spec = [None] * len(shape)
            spec[lead] = dp
            return _choose(mesh, shape, tuple(spec), (None,) * len(shape))
        return (None,) * len(shape)

    return _map_with_path(spec_for, caches)


def serve_batch_sharding(mesh, batch: int):
    """The spec of the engine's per-slot arrays: the slot dim over the data
    axes when divisible (``(dp,)``), else None (every rank holds every
    slot)."""
    dp = _dp_axes(mesh)
    if dp is None or batch % _axis_size(mesh, dp) != 0:
        return None
    return (dp,)


# ------------------------------------------------------- local shards
_CUT_KINDS = ("heads", "kv_heads", "ff", "experts")


def _cut_kind(pstr: str) -> Optional[str]:
    """Which model-axis cut a leaf's spec decides: the query heads (wq),
    the KV heads (wk, wv), the dense MLP's columns (w_gate, w_up) or the
    experts (the MoE's w_gate, w_up, w_down); None for any other leaf."""
    key = pstr.rsplit("/", 1)[-1]
    if "moe" in pstr and key in ("w_gate", "w_up", "w_down"):
        return "experts"
    return {"wq": "heads", "wk": "kv_heads", "wv": "kv_heads",
            "w_gate": "ff", "w_up": "ff"}.get(key)


def model_cuts(mesh, params) -> dict:
    """``{kind: bool}`` over ``_CUT_KINDS``: whether the rules' spec of
    ``params``' leaves of that kind cuts them over "model", read from
    ``serve_param_shardings``.  What a rank holds (``head_layout``,
    ``shard_params``) and where the seams gather (``ServeShardFn``) both
    follow it.  Every leaf of a kind must agree: one seam serves them
    all."""
    cuts: dict = {}

    def visit(pstr, leaf):
        kind = _cut_kind(pstr)
        if kind is not None:
            cut = "model" in _param_spec(mesh, pstr, leaf.shape)
            if cuts.setdefault(kind, cut) != cut:
                raise ValueError(f"the rules cut some {kind} leaves over "
                                 f"'model' and not others ({pstr})")
        return leaf

    _map_with_path(visit, params)
    return {k: cuts.get(k, False) for k in _CUT_KINDS}


def block_index(sizes, coord, axis) -> tuple:
    """(index, count) of this rank's block along ``axis`` (a name or a
    tuple of names, row-major over them)."""
    names = axis if isinstance(axis, (tuple, list)) else (axis,)
    idx, n = 0, 1
    for a in names:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def head_layout(cfg, sizes, model_index: int, cuts: dict) -> tuple:
    """This rank's attention heads: ``((h0, h1), (kv0, kv1))``, the query
    heads and the KV heads they read, from ``cuts`` (``model_cuts``: the
    rules' specs of ``wq`` and ``wk``).  Where ``wq``'s heads shard and
    ``wk``'s do not (KV does not divide the model axis, granite's KV =
    1), the rank keeps only the KV heads its query heads read, so that
    its local grouping H_local / KV_local maps each query head to its own
    KV head."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    m = sizes.get("model", 1)
    if not h:  # an SSM plan: no attention heads
        return (0, 0), (0, 0)
    if not cuts["heads"]:
        return (0, h), (0, kv)
    hl = h // m
    h0 = model_index * hl
    if cuts["kv_heads"]:
        kl = kv // m
        return (h0, h0 + hl), (model_index * kl, (model_index + 1) * kl)
    g = h // kv
    if hl % g == 0:  # whole KV groups per rank
        return (h0, h0 + hl), (h0 // g, (h0 + hl) // g)
    if g % hl == 0:  # several ranks read one KV head
        return (h0, h0 + hl), (h0 // g, h0 // g + 1)
    raise ValueError(f"{h} query heads on {kv} KV heads do not split over "
                     f"a model axis of {m}: a rank's heads would read a "
                     f"ragged share of the KV heads")


def local_cfg(cfg, sizes, model_index: int, cuts: dict):
    """The arch config a rank's local model runs: its query and KV head
    counts (``head_layout``); every other field as given."""
    (h0, h1), (k0, k1) = head_layout(cfg, sizes, model_index, cuts)
    return dataclasses.replace(cfg, num_heads=h1 - h0, num_kv_heads=k1 - k0)


def local_caches(mesh, caches, *, paged: bool, kv_heads: int,
                 sink: bool = False, device="cpu"):
    """A rank's zeroed caches, sized from ``serve_cache_shardings`` of the
    full ``caches`` (any device; only shapes and dtypes are read): every
    dim a spec cuts divided by its axis size.  The KV dim of a K/V or
    scale leaf is ``kv_heads`` where the spec keeps it whole and the rank
    reads fewer KV heads (``head_layout``); ``sink`` adds one page to a
    paged leaf's page dim, the rank's null page."""
    sizes = mesh_sizes(mesh)
    specs = serve_cache_shardings(mesh, caches, paged=paged)

    def make(path, leaf, spec):
        shape = [d // _axis_size(sizes, a) for d, a in zip(leaf.shape, spec)]
        if path.rsplit("/", 1)[-1] in ("k", "v", "k_scale", "v_scale"):
            if spec[-2] is None:
                shape[-2] = kv_heads
            if paged and sink:
                shape[-4] += 1
        return torch.zeros(shape, dtype=leaf.dtype, device=device)

    def walk(tree, spec_tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, spec_tree[k], f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        return make(path, tree, spec_tree)

    return walk(caches, specs)


def shard_params(params, mesh, cfg=None, *, coord: Optional[dict] = None):
    """This rank's local parameter tree: each leaf cut contiguously along
    every dim its spec shards, at the rank's block (``coord``, default
    the mesh coordinate).  The cut is the order the seams' all-gather
    restores: block i of a dim is rank i's along its axis.  With ``cfg``,
    ``wk``/``wv``/``bk``/``bv`` that the rules keep replicated while
    ``wq`` shards are cut to the KV heads the rank's query heads read
    (``head_layout``).  Leaves are contiguous copies (or the full leaf
    where nothing is cut)."""
    sizes = mesh_sizes(mesh)
    coord = mesh_coord(mesh) if coord is None else coord
    kv_range = None
    if cfg is not None and "model" in sizes:
        kv_range = head_layout(cfg, sizes, coord["model"],
                               model_cuts(sizes, params))[1]
    return _map_with_path(
        lambda pstr, leaf: serve_cut(pstr, leaf, sizes, coord, kv_range),
        params)


def kv_narrowed(pstr: str, spec, kv_range, shape) -> bool:
    """Whether ``shard_params`` cuts leaf ``pstr`` (of ``spec`` and
    ``shape``) to the rank's ``kv_range`` although the rules keep it
    replicated: ``wk``/``wv``/``bk``/``bv`` when the query heads shard and
    the KV heads do not divide the model axis."""
    return (kv_range is not None
            and pstr.rsplit("/", 1)[-1] in ("wk", "wv", "bk", "bv")
            and all(a is None for a in spec)
            and kv_range[1] - kv_range[0] != shape[-2])


def serve_cut(pstr: str, leaf, sizes: dict, coord: dict, kv_range=None):
    """One leaf of ``shard_params``: the block of the serving spec, and
    the rank's KV heads where ``kv_narrowed``."""
    spec = _param_spec(sizes, pstr, leaf.shape)
    out = shard_block(leaf, spec, sizes, coord)
    if kv_narrowed(pstr, spec, kv_range, leaf.shape):
        # replicated by the rules; the KV dim of (..., dm, KV, hd) and of
        # (..., KV, hd)
        k0, k1 = kv_range
        out = out.narrow(leaf.ndim - 2, k0, k1 - k0)
    return out.contiguous() if out is not leaf else leaf


# ------------------------------------------------------------ seam hook
class ServeShardFn:
    """The seams' hook of the gather-form serving layout, passed through
    ``RuntimeKnobs.shard_fn``.

    The gather seams ("attn_out", "mlp_up", "moe_expert_out") all-gather
    the activation over the mesh's "model" group immediately before a
    contraction over the sharded dim, so that the contraction runs in the
    single-device order on every rank: the constraint that keeps sharded
    decode bitwise the unsharded engine's.  "moe_expert_in" cuts the
    dispatch buffer to the rank's experts (the buffer holds every
    expert's rows).  The sharding seams ("attn_q", "attn_kv") and
    "hidden" are no-ops: the local parameters already give local shards,
    and a rank holds only its data row's slots.  A seam gathers only
    where ``cuts`` (``model_cuts`` of the parameters ``shard_params``
    cut) says its dim is cut.

    Hashable on (mesh, cuts), so that engines over one mesh share steps
    in the ``runtime.steps`` cache."""

    def __init__(self, mesh, cuts: dict):
        self.mesh = mesh
        self.cuts = dict(cuts)
        self._m = mesh_sizes(mesh).get("model", 1)
        self._group = mesh.get_group("model") if self._m > 1 else None
        self._index = mesh_coord(mesh)["model"] if self._m > 1 else 0
        self._heads = self._m > 1 and cuts["heads"]
        self._ff = self._m > 1 and cuts["ff"]
        self._experts = self._m > 1 and cuts["experts"]

    def __eq__(self, other):
        return (isinstance(other, ServeShardFn) and self.mesh is other.mesh
                and self.cuts == other.cuts)

    def __hash__(self):
        return hash((type(self).__name__, id(self.mesh),
                     tuple(sorted(self.cuts.items()))))

    def __call__(self, name: str, x):
        if name == "attn_out" and self._heads:  # (B, S, H_local, hd)
            return all_gather_cat(x, self._group, dim=-2)
        if name == "mlp_up" and self._ff:  # (B, S, ff_local)
            return all_gather_cat(x, self._group, dim=-1)
        if name == "moe_expert_in" and self._experts:  # (E, rows, d)
            el = x.shape[0] // self._m
            return x[self._index * el:(self._index + 1) * el]
        if name == "moe_expert_out" and self._experts:  # (E_local, rows, d)
            return all_gather_cat(x, self._group, dim=0)
        return x


# ------------------------------------------------------ training rules
def _trailing_spec(pstr: str, key: str, shape, mesh, fsdp: bool,
                   zero_axis) -> tuple:
    """The training spec of one param's semantic (trailing) dims: the
    reference's, candidate by candidate ("model" for heads, MLP columns,
    experts and vocab; ``fsdp`` or ``zero_axis`` for a weight dim)."""
    fs = zero_axis if zero_axis is not None else ("data" if fsdp else None)
    rank = len(shape)

    def c(*cands):
        return _choose(mesh, shape, *cands)

    if key in ("table", "head"):  # (V, dm); vocab may not divide (mamba2)
        # never FSDP-cut the embedding's dm (the reference's H1 finding:
        # the token gather would repartition it every microbatch)
        if zero_axis is None:
            fs = None
        return c(("model", fs), ("model", None), (fs, "model"),
                 (None, "model"), (None, None))
    if key == "wq":  # (dm, H, hd)
        return c((fs, "model", None), (None, "model", None),
                 ("model", None, None), (None, None, None))
    if key in ("wk", "wv"):  # (dm, KV, hd)
        return c((fs, "model", None), ("model", None, None),
                 (None, None, None))
    if key == "wo":  # (H, hd, dm)
        return c(("model", None, fs), ("model", None, None),
                 (None, None, "model"), (None, None, None))
    if key in ("bq", "bk", "bv"):  # (H, hd)
        return c(("model", None), (None, None))
    if "moe" in pstr:
        if key == "router":  # (dm, E)
            return (None,) * rank
        if key in ("w_gate", "w_up"):  # (E, dm, dff)
            return c(("model", fs, None), ("model", None, None),
                     (None, fs, "model"), (None, None, "model"),
                     (None, None, None))
        if key == "w_down":  # (E, dff, dm)
            return c(("model", None, fs), ("model", None, None),
                     (None, "model", fs), (None, "model", None),
                     (None, None, None))
    if key in ("w_gate", "w_up"):  # mlp (dm, ff)
        return c((fs, "model"), (None, "model"), (None, None))
    if key == "w_down":  # (ff, dm)
        return c(("model", fs), ("model", None), (None, None))
    if key == "in_proj":  # (dm, d_in)
        return c((fs, "model"), (None, "model"), (None, None))
    if key == "out_proj":  # (di, dm)
        return c(("model", fs), ("model", None), (None, None))
    # conv_w, conv_b, A_log, dt_bias, D, norm scales, biases: replicated
    return (None,) * rank


def _train_param_spec(mesh, pstr: str, shape, fsdp: bool,
                      zero_axis=None) -> tuple:
    key = pstr.rsplit("/", 1)[-1]
    if "moe" in pstr and key in ("w_gate", "w_up", "w_down"):
        rank = 3
    else:
        rank = _SEMANTIC_RANK.get(key, len(shape))
    lead = len(shape) - rank  # stacked layer dims, never sharded
    return (None,) * lead + _trailing_spec(pstr, key, tuple(shape[lead:]),
                                           mesh, fsdp, zero_axis)


def param_shardings(mesh, cfg, params, *, fsdp: bool, layout: str = "tp"):
    """The training parameter layout, a spec per leaf of ``params``.
    ``layout="dp"``: every weight replicated, every mesh axis a batch axis
    (the reference's layout for small models on big meshes)."""
    if layout == "dp":
        return _map_with_path(lambda p, leaf: (None,) * len(leaf.shape),
                              params)
    return _map_with_path(
        lambda p, leaf: _train_param_spec(mesh, p, leaf.shape, fsdp), params)


def opt_state_shardings(mesh, cfg, params, *, fsdp: bool,
                        layout: str = "tp"):
    """The optimizer state's layout (master, mu, nu): ZeRO, the FSDP dim
    extended over ("pod", "data") where both exist.  Under ``layout="dp"``
    the state still shards (ZeRO-1)."""
    zero = _dp_axes(mesh)
    return _map_with_path(
        lambda p, leaf: _train_param_spec(mesh, p, leaf.shape, True, zero),
        params)


def grad_shardings(mesh, cfg, params):
    """The gradient accumulator's layout (ZeRO-2), over "data" only: a
    pod-cut accumulator would reduce every microbatch over the pods
    (the reference's H1 finding); the pod sum runs once a step."""
    return _map_with_path(
        lambda p, leaf: _train_param_spec(mesh, p, leaf.shape, True, "data"),
        params)


def train_state_shardings(mesh, cfg, params, *, fsdp: bool = False,
                          layout: str = "tp"):
    """The specs of a train state ``{"params", "opt": {"master", "mu",
    "nu", "step"}}``: ``param_shardings`` for the params,
    ``opt_state_shardings`` for the master and moments, the step
    replicated (as the reference's tests assemble them)."""
    o = opt_state_shardings(mesh, cfg, params, fsdp=fsdp, layout=layout)
    return {"params": param_shardings(mesh, cfg, params, fsdp=fsdp,
                                      layout=layout),
            "opt": {"master": o, "mu": o, "nu": o, "step": ()}}


def _all_axes(mesh):
    axes = tuple(mesh_sizes(mesh))
    return axes if len(axes) > 1 else axes[0]


def batch_axes(mesh, layout: str = "tp") -> tuple:
    """The axes a batch is cut over, as a tuple of names: (pod, data), or
    every axis under ``layout="dp"``."""
    axis = _all_axes(mesh) if layout == "dp" else _dp_axes(mesh)
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def batch_shardings(mesh, specs, layout: str = "tp"):
    """Inputs: the batch dim over (pod, data) where it divides; under
    ``layout="dp"`` over every mesh axis.  ``specs`` is a tree of leaves
    with a ``.shape``."""
    dp = _all_axes(mesh) if layout == "dp" else _dp_axes(mesh)

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        cands = [(dp,) + (None,) * (len(shape) - 1)] if dp else []
        cands.append((None,) * len(shape))
        return _choose(mesh, shape, *cands)

    return _map_with_path(lambda p, leaf: spec_for(leaf), specs)


def cache_shardings(mesh, caches):
    """KV and SSM caches, the reference's training-side rules: attention
    k/v (L..., B, S, KV, hd) with the batch over (pod, data) where it
    divides, else the sequence over "data" (sequence-parallel KV for
    batch-1 long context); head-like dims over "model"; SSM state (L...,
    B, nh, hp, ds) and conv (L..., B, w, ch) likewise."""
    dp = _dp_axes(mesh)

    def spec_for(pstr, leaf):
        key = pstr.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        if key in ("k", "v"):
            base = (None,) * (len(shape) - 4)
            cands = []
            if dp:
                cands += [base + (dp, "model", None, None),
                          base + (dp, None, "model", None),
                          base + (dp, None, None, "model"),
                          base + (dp, None, None, None)]
            cands += [base + (None, ("data", "model"), None, None),
                      base + (None, "data", "model", None),
                      base + (None, "data", None, None),
                      base + (None, None, "model", None),
                      (None,) * len(shape)]
            return _choose(mesh, shape, *cands)
        if key == "state":
            base = (None,) * (len(shape) - 4)
            cands = ([base + (dp, "model", None, None),
                      base + (dp, None, None, None)] if dp else [])
            cands += [base + (None, "model", None, None),
                      (None,) * len(shape)]
            return _choose(mesh, shape, *cands)
        if key == "conv":
            base = (None,) * (len(shape) - 3)
            cands = ([base + (dp, None, "model"), base + (dp, None, None)]
                     if dp else [])
            cands += [base + (None, None, "model"), (None,) * len(shape)]
            return _choose(mesh, shape, *cands)
        return (None,) * len(shape)

    return _map_with_path(spec_for, caches)


def train_seam_spec(mesh, name: str, shape, *, sp: bool = False,
                    layout: str = "tp"):
    """The spec the reference's ``make_shard_fn`` constrains seam ``name``
    of an activation of ``shape`` to, or None where it leaves the
    activation as it is (an unknown seam, a rank it does not match, or a
    spec with no axis)."""
    dp = _all_axes(mesh) if layout == "dp" else _dp_axes(mesh)
    tp = None if layout == "dp" else "model"
    shape = tuple(shape)
    if name == "hidden" and len(shape) == 3:  # (B, S, dm)
        if sp and tp:
            spec = _choose(mesh, shape, (dp, tp, None), (dp, None, None),
                           (None,) * 3)
        else:
            spec = _choose(mesh, shape, (dp, None, None), (None,) * 3)
    elif name == "microbatch":  # (accum, B / accum, ...)
        spec = _choose(mesh, shape, (None, dp) + (None,) * (len(shape) - 2),
                       (None,) * len(shape))
    elif name in ("moe_expert_in", "moe_expert_out") and len(shape) == 5:
        tokens = shape[0] * shape[1] * shape[3]  # (B, n, E, C, d)
        if tokens <= 4096 and tp:
            # the serving regime: weight-stationary, dm over "data"
            spec = _choose(mesh, shape, (None, None, tp, None, "data"),
                           (None, None, tp, None, None), (None,) * 5)
        else:
            spec = _choose(mesh, shape, (dp, None, tp, None, None),
                           (None, None, tp, None, None),
                           (dp, None, None, None, None), (None,) * 5)
    elif name == "attn_q" and len(shape) == 4:  # (B, S, H, hd)
        spec = _choose(mesh, shape, (dp, None, tp, None), (None,) * 4)
    elif name == "attn_kv" and len(shape) == 4:
        spec = _choose(mesh, shape, (dp, None, tp, None),
                       (dp, None, None, None), (None,) * 4)
    else:
        return None
    if all(a is None for a in spec):
        return None
    return spec


def shard_block(full, spec, sizes: dict, coord: dict):
    """The block of ``full`` that ``spec`` gives the rank at ``coord``:
    each cut dim narrowed to the rank's block along its axis (row-major
    over a tuple of axes), the order ``gather_block`` restores."""
    out = full
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        i, n = block_index(sizes, coord, axis)
        size = full.shape[dim] // n
        out = out.narrow(dim, i * size, size)
    return out


class TrainShardFn(ServeShardFn):
    """The seams' hook of a sharded train step: the gather form of
    ``ServeShardFn``, with the backward each seam needs.

    - "attn_out", "mlp_up", "moe_expert_out" gather over "model"
      (``gather_seam``): the backward keeps the rank's slice of the
      gradient, which every rank holds whole.
    - "attn_in", "mlp_in" (the normed activation entering the rank's
      heads or MLP columns) are the identity whose backward sums over
      "model" (``reduce_seam``): each rank's input gradient there holds
      only its heads' or columns' terms.
    - "moe_expert_in" cuts the dispatch buffer to the rank's experts
      (``slice_seam``): the backward sums the buffer's gradient over
      "model".

    Every other seam, and every seam under ``layout="dp"`` (no model
    cut), is the identity.  ``spec(name, shape)`` is the reference's
    constraint at that seam (``train_seam_spec``)."""

    def __init__(self, mesh, cuts: dict, *, layout: str = "tp"):
        if layout == "dp":
            cuts = {k: False for k in cuts}
        super().__init__(mesh, cuts)
        self.layout = layout

    def __eq__(self, other):
        return (isinstance(other, TrainShardFn) and super().__eq__(other)
                and self.layout == other.layout)

    def __hash__(self):
        return hash((super().__hash__(), self.layout))

    def __call__(self, name: str, x):
        g = self._group
        if name == "attn_in" and self._heads:
            return reduce_seam(x, g)
        if name == "mlp_in" and self._ff:
            return reduce_seam(x, g)
        if name == "attn_out" and self._heads:  # (B, S, H_local, hd)
            return gather_seam(x, g, -2, self._index)
        if name == "mlp_up" and self._ff:  # (B, S, ff_local)
            return gather_seam(x, g, -1, self._index)
        if name == "moe_expert_in" and self._experts:  # (E, rows, d)
            return slice_seam(x, g, 0, self._index, self._m)
        if name == "moe_expert_out" and self._experts:  # (E_local, rows, d)
            return gather_seam(x, g, 0, self._index)
        return x


def param_shapes(cfg):
    """The parameter tree of ``cfg`` on the meta device: shapes and
    dtypes, nothing allocated."""
    from ..models import LM

    return LM(cfg, device="meta").init(torch.Generator())


def make_shard_fn(mesh, cfg, *, sp: bool = False, layout: str = "tp"):
    """The seams' hook of a sharded train step over ``mesh`` (the
    reference's ``make_shard_fn``): a ``TrainShardFn`` whose model cuts
    follow the serving rules' specs of ``cfg``'s parameters.  The gather
    form keeps each rank's residual stream whole, so ``sp=True`` (the
    reference's sequence-parallel residual) is not ported and raises;
    ``train_seam_spec`` gives its specs."""
    if sp:
        raise NotImplementedError(
            "sp=True (a sequence-parallel residual) is not ported: the "
            "gather form keeps every rank's residual whole")
    cuts = model_cuts(mesh_sizes(mesh), param_shapes(cfg))
    return TrainShardFn(mesh, cuts, layout=layout)
