"""Transformer assembly: the uniform, grouped and hybrid plans.

The PyTorch counterpart of ``repro/models/transformer.py``.  Layer
parameters and caches keep the reference's stacked layer axes, so
converted JAX pytrees load as they are: a uniform plan is
``{"stack": {...}}`` with (L, ...) leaves; a grouped plan (gemma3's
local/global layers) is ``{"inner": (G, P-1, ...), "outer": (G, ...),
"rem": (R, ...)}`` for the blocks and ``{"groups": {"inner", "outer"},
"rem"}`` for the caches.  The hybrid plan (zamba2) is a grouped plan of
mamba2 inner layers, (G, P, ...), whose outer block is *shared*: one
unstacked attention block with an MLP FFN in the blocks, and one K/V
cache per group, (G, ...), in the caches.  The reference's ``lax.scan``
over those axes becomes a Python loop over the layers in the order they
run (``_layers``), each with its kind and its own parameter and cache
index.  Caches are written in place.

Ported: attention plans (dense, SWA and GQA archs, gemma3's grouped
local/global plan) with dense or MoE FFNs, the uniform SSM plan (mamba2)
and the hybrid plan (zamba2).  The whole-sequence forward
(``apply_blocks``) has the reference's two routes.  Mode "prefill" runs
attention through ``ops.flash_attention`` and the SSD intra-chunk through
``ops.ssd_chunk`` (the CUDA kernels on the card, forward only).  Mode
"train" is the reference's ``use_pallas=False`` route, differentiable and
reaching no kernel: ``attn.flash_attention_xla`` at ``knobs.q_chunk`` and
the SSD einsums, under the reference's remat (each layer and, in a grouped
plan, each group, with ``knobs.remat``; each attention query chunk and
each CE chunk always).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from . import attention as attn
from .layers import mlp, mlp_init, remat, rmsnorm, rmsnorm_init
from .moe import moe_ffn, moe_init
from .ssm import ssm_decode_step, ssm_forward, ssm_init, ssm_init_cache
from ..kernels import ops

MOE_AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


@dataclasses.dataclass(frozen=True)
class Plan:
    kind: str  # "uniform" | "grouped"
    n_layers: int
    inner_kind: str  # "attn" | "ssm"
    inner_window: int = 0
    period: int = 0
    n_groups: int = 0
    inner_per_group: int = 0
    remainder: int = 0
    outer_kind: Optional[str] = None
    outer_window: int = 0
    outer_shared: bool = False


def build_plan(cfg) -> Plan:
    if cfg.family == "hybrid":
        p = cfg.shared_attn_period
        return Plan(
            kind="grouped", n_layers=cfg.num_layers, inner_kind="ssm",
            period=p, n_groups=cfg.num_layers // p, inner_per_group=p,
            remainder=cfg.num_layers % p, outer_kind="attn", outer_window=0,
            outer_shared=True,
        )
    if cfg.local_global_period:
        p = cfg.local_global_period
        return Plan(
            kind="grouped", n_layers=cfg.num_layers, inner_kind="attn",
            inner_window=cfg.local_window, period=p,
            n_groups=cfg.num_layers // p, inner_per_group=p - 1,
            remainder=cfg.num_layers % p, outer_kind="attn", outer_window=0,
        )
    if cfg.family == "ssm":
        return Plan(kind="uniform", n_layers=cfg.num_layers, inner_kind="ssm")
    return Plan(kind="uniform", n_layers=cfg.num_layers, inner_kind="attn",
                inner_window=cfg.window)


def _ffn_kind(cfg) -> str:
    return "moe" if cfg.moe is not None else ("mlp" if cfg.d_ff else "none")


class Layer(NamedTuple):
    """One layer of a plan, in run order.  ``stack`` names the tree that
    holds it ("stack" for a uniform plan; "inner", "outer" or "rem" for a
    grouped one); ``index`` is its index into the parameters' leading axes
    and ``cache_index`` into the caches' (they differ for the hybrid
    plan's shared block: parameters ``()``, cache ``(g,)``).  ``kind`` is
    "attn" or "ssm"; an attention layer runs under ``window`` with the
    ``ffn`` tail ("mlp" for the shared block, as the reference's)."""

    stack: str
    index: tuple
    cache_index: tuple
    kind: str
    window: int
    ffn: str


def _layers(plan, cfg):
    """The plan's layers in the order they run (``Layer``s).  Inner and
    remainder layers take ``plan.inner_kind`` and ``plan.inner_window``,
    an outer layer is attention under ``plan.outer_window``."""
    ffn = _ffn_kind(cfg)

    def inner(stack, idx):
        return Layer(stack, idx, idx, plan.inner_kind, plan.inner_window,
                     ffn)

    if plan.kind == "uniform":
        return [inner("stack", (i,)) for i in range(plan.n_layers)]
    out = []
    for g in range(plan.n_groups):
        out += [inner("inner", (g, i)) for i in range(plan.inner_per_group)]
        out.append(Layer("outer", () if plan.outer_shared else (g,), (g,),
                         "attn", plan.outer_window,
                         "mlp" if plan.outer_shared else ffn))
    return out + [inner("rem", (i,)) for i in range(plan.remainder)]


def _plan_tree(plan, per_layer, groups_key=None):
    """Stack ``per_layer`` (one tree per layer, in ``_layers`` order) into
    the plan's tree: {"stack": (L, ...)}, or {"inner": (G, P-1, ...),
    "outer": (G, ...), "rem": (R, ...)} with inner and outer under
    ``groups_key`` when given (the caches' {"groups": ...}).  The hybrid
    plan's shared block appears once per group in ``per_layer``; its
    parameters (no ``groups_key``) are that one unstacked tree, its
    caches stack per group."""
    if plan.kind == "uniform":
        return {"stack": _stack_trees(per_layer)}
    it = iter(per_layer)
    inner, outer = [], []
    for _ in range(plan.n_groups):
        inner.append(_stack_trees([next(it)
                                   for _ in range(plan.inner_per_group)]))
        outer.append(next(it))
    shared = plan.outer_shared and groups_key is None
    groups = {"inner": _stack_trees(inner),
              "outer": outer[0] if shared else _stack_trees(outer)}
    tree = {groups_key: groups} if groups_key else dict(groups)
    if plan.remainder:
        tree["rem"] = _stack_trees(list(it))
    return tree


def _layer_cache(caches, stack, index):
    """Layer ``index`` of ``stack`` in a cache tree: views of its leaves,
    so writes land in the caches."""
    tree = caches["groups"][stack] if stack in ("inner", "outer") \
        else caches[stack]
    return _index_tree(tree, index)


def tree_leaves(tree):
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


# ===================================================================== init
def _init_attn_block(gen, cfg, dtype, ffn, device):
    p = {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn.attention_init(
            gen, d_model=cfg.d_model, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dtype, device=device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if ffn == "moe":
        p["moe"] = moe_init(gen, cfg.d_model, cfg.moe, dtype, device)
    elif ffn == "mlp":
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype,
                            device)
    return p


def _init_ssm_block(gen, cfg, dtype, device):
    return {"ln": rmsnorm_init(cfg.d_model, dtype, device),
            "ssm": ssm_init(gen, cfg.d_model, cfg.ssm, dtype, device)}


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def init_blocks(gen, cfg, dtype, device="cpu"):
    plan = build_plan(cfg)
    shared = None
    layers = []
    for layer in _layers(plan, cfg):
        if layer.kind == "ssm":
            layers.append(_init_ssm_block(gen, cfg, dtype, device))
        elif plan.outer_shared and layer.stack == "outer":
            # one set of weights, drawn once, for every group
            if shared is None:
                shared = _init_attn_block(gen, cfg, dtype, layer.ffn, device)
            layers.append(shared)
        else:
            layers.append(_init_attn_block(gen, cfg, dtype, layer.ffn,
                                           device))
    return _plan_tree(plan, layers)


def _zero_aux(cfg, device):
    if cfg.moe is not None:
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in MOE_AUX_KEYS}
    return {}


def _acc_aux(aux, new):
    if not aux:
        return aux
    return {k: aux[k] + new.get(k, 0.0) for k in aux}


def _ffn(p, h2, ffn, *, cfg, train, shard_fn):
    """The FFN tail: (out, aux); aux holds the MoE losses of an MoE FFN.
    The MoE runs between the seams "moe_in" and "moe_out" (the identity
    but under sequence parallelism)."""
    if ffn == "moe":
        out, aux = moe_ffn(p["moe"], shard_fn("moe_in", h2), cfg.moe,
                           train=train, shard_fn=shard_fn)
        return shard_fn("moe_out", out), aux
    if ffn == "mlp":
        return mlp(p["mlp"], h2, cfg.gated_mlp, shard_fn=shard_fn), {}
    return torch.zeros_like(h2), {}


def _ffn_out(p, h2, ffn, *, cfg, shard_fn):
    """The inference FFN tail of the cached block bodies (eval capacity,
    aux dropped)."""
    return _ffn(p, h2, ffn, cfg=cfg, train=False, shard_fn=shard_fn)[0]


# ============================================================ block bodies
def _pool(cache):
    """A layer's paged pools: (k, v, k_scale, v_scale); the scales are None
    unless the pools are quantized (they carry scale leaves)."""
    return cache["k"], cache["v"], cache.get("k_scale"), cache.get("v_scale")


def _apply_attn_block(p, x, positions, *, cfg, window, knobs, collect_cache,
                      ffn):
    """Whole-sequence attention block: x (B,S,dm) at ``positions``
    (B,S).  With ``collect_cache`` (prefill) attention runs through
    ``ops.flash_attention`` (the CUDA kernel on the card, its plain version
    on the CPU) and the block returns its K/V in ``knobs.cache_dtype``;
    without (training) through ``attn.flash_attention_xla`` at
    ``knobs.q_chunk``, which autograd can differentiate.  An MoE FFN runs
    at the training capacity unless ``collect_cache`` (as the
    reference's).  Returns (x, aux, cache)."""
    shard_fn = knobs.shard_fn
    h = shard_fn("attn_in", rmsnorm(p["ln1"], x))
    q, k, v = attn.qkv_project(p["attn"], h, positions, cfg.rope_theta)
    q = shard_fn("attn_q", q)
    k = shard_fn("attn_kv", k)
    v = shard_fn("attn_kv", v)
    if collect_cache:
        ctx = ops.flash_attention(q, k, v, causal=True, window=window)
    else:
        ctx = attn.flash_attention_xla(q, k, v, causal=True, window=window,
                                       q_chunk=knobs.q_chunk,
                                       causal_skip=knobs.causal_skip)
    ctx = shard_fn("attn_out", ctx)
    x = x + attn.attn_output(p["attn"], ctx)
    h2 = rmsnorm(p["ln2"], x)
    out, aux = _ffn(p, h2, ffn, cfg=cfg, train=not collect_cache,
                    shard_fn=shard_fn)
    cache = ({"k": k.to(knobs.cache_dtype), "v": v.to(knobs.cache_dtype)}
             if collect_cache else None)
    return shard_fn("hidden", x + out), aux, cache


def _apply_ssm_block(p, x, *, cfg, collect_cache, shard_fn):
    """Whole-sequence SSM block: the SSD intra-chunk through the kernel
    when ``collect_cache`` (prefill), through the einsums otherwise
    (training).  Returns (x, cache)."""
    h = shard_fn("ssm_in", rmsnorm(p["ln"], x))
    if collect_cache:
        y, state = ssm_forward(p["ssm"], h, cfg.d_model, cfg.ssm,
                               return_state=True)
    else:
        y = ssm_forward(p["ssm"], h, cfg.d_model, cfg.ssm, kernel=False)
        state = None
    return shard_fn("hidden", x + shard_fn("ssm_out", y)), state


def _apply_ssm_block_decode(p, x, cache, *, cfg):
    h = rmsnorm(p["ln"], x)
    y, _ = ssm_decode_step(p["ssm"], cache, h, cfg.d_model, cfg.ssm)
    return x + y


def _cat_rows(rows):
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


def _row(x, t):
    """Row ``t`` of a (B,T,...) block as a contiguous (B,1,...) tensor, the
    layout of the one-token tick's; the block itself when T = 1."""
    return x if x.shape[1] == 1 else x[:, t:t + 1].contiguous()


def _apply_attn_block_decode(p, xs, cache, pos, active, index, *, cfg,
                             window, knobs, ffn, paged=None):
    """``xs``: the T rows of the block, each (B,1,dm); row ``t`` of slot
    ``b`` sits at position ``pos[b] + t`` (pos a (B,) int32 tensor).
    Returns the T rows after the block.

    Each row runs the block's norms, projections and FFN on its own, in
    the one-token tick's shape (B,1,.), so that its result does not depend
    on T: matmuls and reductions choose their kernels and their summation
    order by the row count, and a T-row verify block must give, row by
    row, the bits of T one-token ticks.  Only the cache write and the
    attention take the T rows at once: all T K/V rows are written in
    place at ``index`` (``attn.cache_write_index``, or
    ``attn.paged_write_index`` when paged) before attention, which is
    causal within the block, and whose rows are each the one-token
    attention at their position.

    ``paged = (page_idx, page_size)`` switches the cache from a dense
    per-slot stripe to the shared page pool addressed through each slot's
    page-table row (an int32 tensor on the model's device); the masking is
    the same either way."""
    qkv = [attn.qkv_project(p["attn"], rmsnorm(p["ln1"], x),
                            pos[:, None] + t, cfg.rope_theta)
           for t, x in enumerate(xs)]
    q, k_new, v_new = (_cat_rows(rows) for rows in zip(*qkv))
    if paged is not None:
        page_idx, _ = paged
        kc, vc, ksc, vsc = _pool(cache)
        if ksc is not None:
            attn.write_paged_rows_quant(kc, vc, ksc, vsc, k_new, v_new,
                                        index)
        else:
            attn.write_paged_rows(kc, vc, k_new, v_new, index)
        ctx = ops.paged_decode_attention(q, kc, vc, page_idx, pos,
                                         active=active, window=window,
                                         num_splits=knobs.decode_splits,
                                         k_scale=ksc, v_scale=vsc)
    else:
        attn.write_cache_rows(cache["k"], cache["v"], k_new, v_new, index)
        ctx = ops.decode_attention(q, cache["k"], cache["v"], pos,
                                   active=active, window=window,
                                   num_splits=knobs.decode_splits)
    ctx = knobs.shard_fn("attn_out", ctx)
    out = []
    for t, x in enumerate(xs):
        x = x + attn.attn_output(p["attn"], _row(ctx, t))
        h2 = rmsnorm(p["ln2"], x)
        out.append(x + _ffn_out(p, h2, ffn, cfg=cfg,
                                shard_fn=knobs.shard_fn))
    return out


def _apply_attn_block_prefill_chunk(p, x, cache, slot, offset, *, cfg,
                                    window, knobs, ffn, paged=None):
    """One slot's prompt chunk x (1,C,dm) at positions offset..offset+C-1:
    write its K/V into cache[slot] in place, then attend the chunk against
    the slot's whole stripe (rows past offset+C-1 are causally masked).

    ``paged = (page_idx, page_size)``: the chunk (C a page multiple,
    offset page-aligned) lands in the pages the slot's table row maps, and
    the fused paged prefill reads the prefix back through the same row --
    the kernel on the card, its plain version on the CPU.  No dense
    per-slot copy of the prefix is made."""
    c = x.shape[1]
    h = rmsnorm(p["ln1"], x)
    positions = offset + torch.arange(c, device=x.device)[None, :]
    q, k_new, v_new = attn.qkv_project(p["attn"], h, positions,
                                       cfg.rope_theta)
    if paged is not None:
        page_idx, page_size = paged
        kc, vc, ksc, vsc = _pool(cache)
        if ksc is not None:
            attn.paged_prefill_chunk_update_quant(kc, vc, ksc, vsc, k_new,
                                                  v_new, slot, offset,
                                                  page_idx, page_size)
        else:
            attn.paged_prefill_chunk_update(kc, vc, k_new, v_new, slot,
                                            offset, page_idx, page_size)
        ctx = ops.paged_prefill_attention(q, kc, vc, page_idx, slot, offset,
                                          window=window, k_scale=ksc,
                                          v_scale=vsc)
    else:
        attn.prefill_chunk_update(cache["k"], cache["v"], k_new, v_new,
                                  slot, offset)
        ctx = attn.flash_attention_xla(
            q, cache["k"][slot:slot + 1], cache["v"][slot:slot + 1],
            causal=True, window=window, q_chunk=min(knobs.q_chunk, c),
            q_offset=offset)
    ctx = knobs.shard_fn("attn_out", ctx)
    x = x + attn.attn_output(p["attn"], ctx)
    h2 = rmsnorm(p["ln2"], x)
    return x + _ffn_out(p, h2, ffn, cfg=cfg, shard_fn=knobs.shard_fn)


# ========================================================== sequence apply
def unstack_layers(blocks, layers):
    """Each layer's parameter tree, in ``layers`` order: every stacked leaf
    taken apart once (``unbind`` of its layer axes, views), the hybrid
    plan's shared block the same tree at each use.  Under autograd a
    stacked leaf's gradient is then one stack of its layers' gradients;
    indexing ``leaf[i]`` per layer would make each layer's backward write
    a zero tensor of the whole stack's size."""
    parts = {}

    def split(tree, depth):
        if isinstance(tree, dict):
            return {k: split(v, depth) for k, v in tree.items()}
        if depth == 0:
            return tree
        return [split(t, depth - 1) for t in tree.unbind(0)]

    def pick(tree, index):
        if isinstance(tree, dict):
            return {k: pick(v, index) for k, v in tree.items()}
        for i in index:
            tree = tree[i]
        return tree

    out = []
    for layer in layers:
        if layer.stack not in parts:
            parts[layer.stack] = split(blocks[layer.stack], len(layer.index))
        out.append(pick(parts[layer.stack], layer.index))
    return out


def _units(layers):
    """The plan's layers as remat units, lists of indices into ``layers``:
    a grouped plan's group (its inner layers and the outer one) is one
    unit, every other layer one of its own (the reference checkpoints the
    scan body of each stack and the group body)."""
    units, group = [], []
    for i, layer in enumerate(layers):
        if layer.stack == "inner":
            group.append(i)
        elif layer.stack == "outer":
            units.append(group + [i])
            group = []
        else:
            units.append([i])
    return units


def apply_blocks(blocks, x, positions, *, cfg, knobs, mode: str):
    """The whole-sequence forward.  mode: "train" (no caches; the
    differentiable route, see the module docstring) or "prefill" (emit each
    layer's cache, in the plan's tree: attention K/V (..., B, S, KV, D),
    SSM conv and state).  Returns (x, aux, caches or None); aux sums the
    MoE losses over the layers (empty without MoE).

    Training with ``knobs.remat`` recomputes in the backward pass what the
    reference's ``jax.checkpoint`` recomputes: each layer's body, and in a
    grouped plan each group (its inner layers, each checkpointed again
    inside it, and its outer block)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    plan = build_plan(cfg)
    layers = _layers(plan, cfg)
    ps = unstack_layers(blocks, layers)
    collect = mode == "prefill"

    def layer_fn(p, x, aux, layer):
        if layer.kind == "attn":
            x, a, cache = _apply_attn_block(
                p, x, positions, cfg=cfg, window=layer.window, knobs=knobs,
                collect_cache=collect, ffn=layer.ffn)
            aux = _acc_aux(aux, a)
        else:
            x, cache = _apply_ssm_block(p, x, cfg=cfg,
                                        collect_cache=collect,
                                        shard_fn=knobs.shard_fn)
        return x, aux, cache

    aux = _zero_aux(cfg, x.device)
    if collect:
        caches = []
        for p, layer in zip(ps, layers):
            x, aux, cache = layer_fn(p, x, aux, layer)
            caches.append(cache)
        return x, aux, _plan_tree(plan, caches, "groups")

    def run(i, x, aux, *, ckpt):
        body = lambda p, x, aux: layer_fn(p, x, aux, layers[i])[:2]
        if ckpt:
            return remat(body, ps[i], x, aux)
        return body(ps[i], x, aux)

    def group_fn(unit, unit_ps, x, aux):
        # unit_ps is ps over ``unit``: passed so that remat sees the params
        for i in unit:
            x, aux = run(i, x, aux, ckpt=knobs.remat
                         and layers[i].stack == "inner")
        return x, aux

    for unit in _units(layers):
        if len(unit) == 1:
            x, aux = run(unit[0], x, aux, ckpt=knobs.remat)
        elif knobs.remat:
            # bound now: the backward's recompute runs after the loop
            x, aux = remat(functools.partial(group_fn, unit),
                           [ps[i] for i in unit], x, aux)
        else:
            x, aux = group_fn(unit, None, x, aux)
    return x, aux, None


# ============================================================ decode apply
def _kv_len(caches):
    """S of a dense cache tree's attention caches: axis -3 of the first
    "k" leaf (..., B, S, KV, D), whatever leading layer axes the plan
    stacks and wherever the tree keeps it (the hybrid plan's SSM leaves
    come first); None for a tree without one."""
    if "k" in caches:
        return caches["k"].shape[-3]
    for sub in caches.values():
        if isinstance(sub, dict):
            s = _kv_len(sub)
            if s is not None:
                return s
    return None


def apply_blocks_decode(blocks, x, caches, pos, *, cfg, knobs, paged=None):
    """Decode every layer; ``pos`` scalar or (B,).  x (B,T,dm): T = 1 is
    the one-token tick, T > 1 a verify block (attention plans only), whose
    rows each go through the layers in the one-token tick's shape
    (``_apply_attn_block_decode``).  Each layer attends under its plan
    window.  Caches are updated in place.  Returns (x (B,T,dm), caches);
    ``paged = (page_idx, page_size)`` takes the page pools (one table
    serves every layer).  SSM layers advance one token at a time and
    ignore ``pos``; the hybrid plan's shared attention blocks take it, at
    T = 1."""
    plan = build_plan(cfg)
    layers = _layers(plan, cfg)
    if plan.inner_kind == "ssm":
        if paged is not None:
            raise NotImplementedError(
                f"paged KV cache unsupported for family={cfg.family!r}")
        if x.shape[1] > 1:
            raise NotImplementedError(
                f"multi-token decode unsupported for family={cfg.family!r} "
                f"-- SSM state advances one token at a time")
    b, t = x.shape[0], x.shape[1]
    if any(layer.kind == "attn" for layer in layers):
        # where this step's K/V rows land: the same in every attention
        # layer (from the positions as given, so that host positions
        # decide a drop on the host)
        if paged is not None:
            index = attn.paged_write_index(pos, paged[0], paged[1], t)
        else:
            index = attn.cache_write_index(pos, b, _kv_len(caches), t,
                                           x.device)
        pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(b)
        pos = pos.to(torch.int32).contiguous()
        active = (pos >= 0).to(torch.int32)
    xs = [_row(x, i) for i in range(t)]
    for layer in layers:
        p = _index_tree(blocks[layer.stack], layer.index)
        cache = _layer_cache(caches, layer.stack, layer.cache_index)
        if layer.kind == "ssm":  # T = 1 (checked above)
            xs = [_apply_ssm_block_decode(p, xs[0], cache, cfg=cfg)]
            continue
        xs = _apply_attn_block_decode(
            p, xs, cache, pos, active, index, cfg=cfg, window=layer.window,
            knobs=knobs, ffn=layer.ffn, paged=paged)
    return _cat_rows(xs), caches


def supports_chunked_prefill(cfg) -> bool:
    """Chunked prefill needs every layer's prefix state in the KV cache;
    SSM plans carry conv and SSD state across chunks and are token-fed."""
    return build_plan(cfg).inner_kind == "attn"


def supports_paged_cache(cfg) -> bool:
    """Paged KV needs every cached layer to be a KV cache; SSM/hybrid
    recurrent state is per-slot and position-free, so it cannot be paged."""
    return build_plan(cfg).inner_kind == "attn"


def supports_speculative(cfg) -> bool:
    """Multi-token verify needs position-indexed caches only; SSM state
    advances strictly one token at a time."""
    return build_plan(cfg).inner_kind == "attn"


def apply_blocks_prefill_chunk(blocks, x, caches, slot, offset, *, cfg,
                               knobs, paged=None):
    """Run one slot's chunk x (1,C,dm) through all layers, writing K/V at
    (slot, offset) in place (``paged``: into the pages the slot's table
    row maps).  Returns (hidden (1,C,dm), caches).  Attention plans only."""
    plan = build_plan(cfg)
    if plan.inner_kind != "attn":
        raise NotImplementedError(
            f"chunked prefill unsupported for family={cfg.family!r}")
    slot, offset = int(slot), int(offset)
    for layer in _layers(plan, cfg):
        x = _apply_attn_block_prefill_chunk(
            _index_tree(blocks[layer.stack], layer.index), x,
            _layer_cache(caches, layer.stack, layer.cache_index), slot,
            offset, cfg=cfg, window=layer.window, knobs=knobs,
            ffn=layer.ffn, paged=paged)
    return x, caches


# ============================================================== cache init
def _cache_tree(plan, leaves):
    """The plan's cache tree of zero leaves: ``leaves(prefix, kind)`` makes
    one layer stack's leaves with the leading layer axes ``prefix`` for
    layers of ``kind`` ("attn" or "ssm"; outer layers are attention)."""
    if plan.kind == "uniform":
        return {"stack": leaves((plan.n_layers,), plan.inner_kind)}
    tree = {"groups": {
        "inner": leaves((plan.n_groups, plan.inner_per_group),
                        plan.inner_kind),
        "outer": leaves((plan.n_groups,), "attn")}}
    if plan.remainder:
        tree["rem"] = leaves((plan.remainder,), plan.inner_kind)
    return tree


def init_cache(cfg, knobs, batch: int, max_len: int, device="cpu"):
    """Dense caches in the plan's tree ({"stack": ...} or {"groups":
    {"inner", "outer"}, "rem"}) with stacked layer axes: "k" and "v"
    (..., B, S, KV, D) for attention layers; "conv" (..., B, conv_width -
    1, conv_dim) in ``knobs.cache_dtype`` and "state" (..., B, NH, hp, ds)
    f32 for SSM layers (the hybrid plan: SSM leaves inside the groups and
    the remainder, one K/V cache per group for the shared block)."""
    plan = build_plan(cfg)
    kv_shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)

    def leaves(pre, kind):
        if kind == "ssm":
            shapes = ssm_init_cache(batch, cfg.d_model, cfg.ssm,
                                    knobs.cache_dtype, "meta")
            return {k: torch.zeros(pre + v.shape, dtype=v.dtype,
                                   device=device)
                    for k, v in shapes.items()}
        return {name: torch.zeros(pre + kv_shape, dtype=knobs.cache_dtype,
                                  device=device) for name in ("k", "v")}

    return _cache_tree(plan, leaves)


def cache_batch_axes(cfg, knobs, max_len: int):
    """Per-leaf batch-axis index of the dense cache tree, found by comparing
    the shapes for batch 1 and 2 (on the meta device: nothing is
    allocated).  Drives the engine's slot reset without hardcoding any
    layout."""
    s1 = init_cache(cfg, knobs, 1, max_len, device="meta")
    s2 = init_cache(cfg, knobs, 2, max_len, device="meta")

    def axis(a, b):
        return next(i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                    if x != y)

    def walk(a, b):
        if isinstance(a, dict):
            return {k: walk(a[k], b[k]) for k in a}
        return axis(a, b)

    return walk(s1, s2)


def copy_cache_out(caches, slot, axes, device=None):
    """A copy of slot ``slot``'s stripe of every dense cache leaf (the
    size-1 batch dim kept) on ``device`` (default: the caches'): a
    preemption checkpoint.  ``axes`` is the ``cache_batch_axes`` tree."""
    if isinstance(caches, dict):
        return {k: copy_cache_out(caches[k], slot, axes[k], device)
                for k in caches}
    return caches.narrow(axes, int(slot), 1).to(device or caches.device,
                                                copy=True)


def copy_cache_in(caches, snapshot, slot, axes):
    """Write a ``copy_cache_out`` snapshot (on any device) back into slot
    ``slot`` of every leaf, in place.  The whole stripe is rewritten, so
    the slot's previous occupant leaves nothing behind."""
    if isinstance(caches, dict):
        for k in caches:
            copy_cache_in(caches[k], snapshot[k], slot, axes[k])
    else:
        caches.narrow(axes, int(slot), 1).copy_(snapshot)
    return caches


def copy_cache_pages(caches, src, dst):
    """Copy physical page ``src`` -> ``dst`` in every paged leaf, in place
    (the device half of copy-on-write).  The page axis of every paged leaf,
    the scale pools of a quantized pool included, sits at ndim - 4."""
    for leaf in tree_leaves(caches):
        ax = leaf.ndim - 4
        leaf.select(ax, int(dst)).copy_(leaf.select(ax, int(src)))
    return caches


def copy_cache_pages_across(src_caches, dst_caches, src_idx, dst_idx):
    """Gather pages ``src_idx`` from one engine's paged pools and write
    them at ``dst_idx`` in another's, in place: the device half of a
    cross-engine page-chain transfer (the disaggregated handoff).  Both
    trees share the plan and page size (pool sizes may differ); every leaf
    moves along its page axis at ndim - 4, so a quantized pool's scales
    travel with their pages.  ``src_idx``/``dst_idx`` are equal-length
    int64 tensors on the pools' device; ``dst_idx`` holds distinct pages
    (padding both with 0 would copy the null page onto the null page,
    which no reader depends on)."""
    for s_leaf, d_leaf in zip(tree_leaves(src_caches),
                              tree_leaves(dst_caches)):
        ax = s_leaf.ndim - 4
        d_leaf.index_copy_(ax, dst_idx, s_leaf.index_select(ax, src_idx))
    return dst_caches


def init_cache_paged(cfg, knobs, num_pages: int, page_size: int,
                     device="cpu"):
    """Paged KV pools in the plan's tree (``init_cache``'s), "k" and "v"
    (..., P, page_size, KV, D) leaves, one global pool per layer shared by
    every slot.  One page table
    addresses every layer: a (page, offset) coordinate is valid in each.
    Physical page 0 is the null page.  Attention plans only.

    ``knobs.kv_quant`` ("int8"/"fp8") stores the pools at that dtype and
    adds per-token, per-head f32 scale leaves "k_scale"/"v_scale"
    (..., P, page_size, KV, 1), the reference's layout: the page axis stays
    where the pools keep it, so a page's scales go wherever its values
    go."""
    if not supports_paged_cache(cfg):
        raise NotImplementedError(
            f"paged KV cache unsupported for family={cfg.family!r}")
    plan = build_plan(cfg)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    dt = attn.kv_quant_dtype(knobs.kv_quant) or knobs.cache_dtype

    def pools(pre, _kind):
        out = {name: torch.zeros(pre + shape, dtype=dt, device=device)
               for name in ("k", "v")}
        if knobs.kv_quant:
            for name in ("k_scale", "v_scale"):
                out[name] = torch.zeros(pre + shape[:-1] + (1,),
                                        dtype=torch.float32, device=device)
        return out

    return _cache_tree(plan, pools)
