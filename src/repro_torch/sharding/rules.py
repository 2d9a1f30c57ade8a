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
"model" group.  The training rules come with the training collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .collectives import all_gather_cat

__all__ = ["ServeShardFn", "block_index", "head_layout", "local_caches",
           "local_cfg", "mesh_coord", "mesh_sizes", "model_cuts",
           "serve_batch_sharding", "serve_cache_shardings",
           "serve_param_shardings", "shard_params"]


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

    def cut(pstr, leaf):
        spec = _param_spec(sizes, pstr, leaf.shape)
        out = leaf
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            i, n = block_index(sizes, coord, axis)
            size = leaf.shape[dim] // n
            out = out.narrow(dim, i * size, size)
        key = pstr.rsplit("/", 1)[-1]
        if (kv_range is not None and key in ("wk", "wv", "bk", "bv")
                and all(a is None for a in spec)
                and kv_range[1] - kv_range[0] != leaf.shape[-2]):
            # replicated by the rules; the KV dim of (..., dm, KV, hd) and
            # of (..., KV, hd)
            k0, k1 = kv_range
            out = out.narrow(leaf.ndim - 2, k0, k1 - k0)
        return out.contiguous() if out is not leaf else leaf

    return _map_with_path(cut, params)


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
