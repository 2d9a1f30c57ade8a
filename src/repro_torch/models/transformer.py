"""Transformer assembly, uniform attention plan.

The PyTorch counterpart of ``repro/models/transformer.py``.  Layer
parameters and caches keep the reference's stacked leading layer axis
(``{"stack": {...}}`` with (L, ...) leaves), so converted JAX pytrees load
as they are; the reference's ``lax.scan`` over that axis becomes a Python
loop over the layer index.  Caches are written in place.

Only the uniform attention plan (dense, SWA and GQA archs) is ported.  The
grouped plans (gemma3 local/global, zamba2 shared block), SSM blocks and
MoE FFNs raise ``NotImplementedError``; ROADMAP.md lists them under the
port's "grouped / MoE / SSM plans" item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import attention as attn
from .layers import mlp, mlp_init, rmsnorm, rmsnorm_init
from ..kernels import ops

_UNPORTED = ("not ported yet: the port runs the uniform attention plan with "
             "dense FFNs only (see ROADMAP.md, 'grouped / MoE / SSM plans')")


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


def _ported_plan(cfg) -> Plan:
    plan = build_plan(cfg)
    if plan.kind != "uniform" or plan.inner_kind != "attn" \
            or _ffn_kind(cfg) == "moe":
        raise NotImplementedError(f"{cfg.name} (family={cfg.family!r}): "
                                  f"{_UNPORTED}")
    return plan


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
    if ffn == "mlp":
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype,
                            device)
    return p


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
    plan = _ported_plan(cfg)
    ffn = _ffn_kind(cfg)
    layers = [_init_attn_block(gen, cfg, dtype, ffn, device)
              for _ in range(plan.n_layers)]
    return {"stack": _stack_trees(layers)}


def _ffn_out(p, h2, ffn, *, cfg):
    if ffn == "mlp":
        return mlp(p["mlp"], h2, cfg.gated_mlp)
    return torch.zeros_like(h2)


# ============================================================ block bodies
_QUANT_UNPORTED = ("quantized (int8/fp8) paged pools are not ported yet "
                   "(see ROADMAP.md, 'int8/fp8 paged pools')")


def _pool(cache):
    if "k_scale" in cache:
        raise NotImplementedError(_QUANT_UNPORTED)
    return cache["k"], cache["v"]


def _apply_attn_block_decode(p, x, cache, pos, active, *, cfg, window, knobs,
                             ffn, paged=None):
    """x (B,T,dm): token ``t`` of slot ``b`` sits at ``pos[b] + t`` (pos a
    (B,) int32 tensor).  All T K/V rows are written to the cache in place
    before attention, which is causal within the block as well.

    ``paged = (page_idx, page_size)`` switches the cache from a dense
    per-slot stripe to the shared page pool addressed through each slot's
    page-table row (an int32 tensor on the model's device); the masking is
    the same either way."""
    b, t = x.shape[0], x.shape[1]
    h = rmsnorm(p["ln1"], x)
    positions = pos[:, None] + torch.arange(t, device=x.device)[None, :]
    q, k_new, v_new = attn.qkv_project(p["attn"], h, positions,
                                       cfg.rope_theta)
    if paged is not None:
        page_idx, page_size = paged
        kc, vc = _pool(cache)
        upd = (attn.paged_cache_update_multi if t > 1
               else attn.paged_cache_update)
        upd(kc, vc, k_new, v_new, pos, page_idx, page_size)
        ctx = ops.paged_decode_attention(q, kc, vc, page_idx, pos,
                                         active=active, window=window,
                                         num_splits=knobs.decode_splits)
    else:
        upd = attn.cache_update_multi if t > 1 else attn.cache_update
        upd(cache["k"], cache["v"], k_new, v_new, pos)
        ctx = ops.decode_attention(q, cache["k"], cache["v"], pos,
                                   active=active, window=window,
                                   num_splits=knobs.decode_splits)
    x = x + attn.attn_output(p["attn"], ctx)
    h2 = rmsnorm(p["ln2"], x)
    return x + _ffn_out(p, h2, ffn, cfg=cfg)


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
        kc, vc = _pool(cache)
        attn.paged_prefill_chunk_update(kc, vc, k_new, v_new, slot, offset,
                                        page_idx, page_size)
        ctx = ops.paged_prefill_attention(q, kc, vc, page_idx, slot, offset,
                                          window=window)
    else:
        attn.prefill_chunk_update(cache["k"], cache["v"], k_new, v_new,
                                  slot, offset)
        ctx = attn.flash_attention_xla(
            q, cache["k"][slot:slot + 1], cache["v"][slot:slot + 1],
            causal=True, window=window, q_chunk=min(knobs.q_chunk, c),
            q_offset=offset)
    x = x + attn.attn_output(p["attn"], ctx)
    h2 = rmsnorm(p["ln2"], x)
    return x + _ffn_out(p, h2, ffn, cfg=cfg)


# ============================================================= stack apply
def apply_blocks_decode(blocks, x, caches, pos, *, cfg, knobs, paged=None):
    """Decode every layer; ``pos`` scalar or (B,).  Caches are updated in
    place and returned.  ``paged = (page_idx, page_size)`` takes the page
    pools (one table serves every layer)."""
    plan = _ported_plan(cfg)
    ffn = _ffn_kind(cfg)
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(b)
    pos = pos.to(torch.int32).contiguous()
    active = (pos >= 0).to(torch.int32)
    stack, cstack = blocks["stack"], caches["stack"]
    for i in range(plan.n_layers):
        x = _apply_attn_block_decode(
            _index_tree(stack, i), x, _index_tree(cstack, i), pos, active,
            cfg=cfg, window=plan.inner_window, knobs=knobs, ffn=ffn,
            paged=paged)
    return x, caches


def supports_chunked_prefill(cfg) -> bool:
    """Chunked prefill needs every layer's prefix state in the KV cache."""
    return build_plan(cfg).inner_kind == "attn"


def supports_paged_cache(cfg) -> bool:
    """Paged KV needs every cached layer to be a KV cache; SSM/hybrid
    recurrent state is per-slot and position-free, so it cannot be paged."""
    return build_plan(cfg).inner_kind == "attn"


def apply_blocks_prefill_chunk(blocks, x, caches, slot, offset, *, cfg,
                               knobs, paged=None):
    """Run one slot's chunk x (1,C,dm) through all layers, writing K/V at
    (slot, offset) in place (``paged``: into the pages the slot's table
    row maps).  Returns (hidden (1,C,dm), caches)."""
    plan = _ported_plan(cfg)
    ffn = _ffn_kind(cfg)
    slot, offset = int(slot), int(offset)
    stack, cstack = blocks["stack"], caches["stack"]
    for i in range(plan.n_layers):
        x = _apply_attn_block_prefill_chunk(
            _index_tree(stack, i), x, _index_tree(cstack, i), slot, offset,
            cfg=cfg, window=plan.inner_window, knobs=knobs, ffn=ffn,
            paged=paged)
    return x, caches


# ============================================================== cache init
def init_cache(cfg, knobs, batch: int, max_len: int, device="cpu"):
    """Dense caches: {"stack": {"k", "v"}} with (L, B, S, KV, D) leaves."""
    plan = _ported_plan(cfg)
    shape = (plan.n_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"stack": {
        "k": torch.zeros(shape, dtype=knobs.cache_dtype, device=device),
        "v": torch.zeros(shape, dtype=knobs.cache_dtype, device=device),
    }}


def init_cache_paged(cfg, knobs, num_pages: int, page_size: int,
                     device="cpu"):
    """Paged KV pools: {"stack": {"k", "v"}} with (L, P, page_size, KV, D)
    leaves, one global pool per layer shared by every slot.  One page table
    addresses every layer: a (page, offset) coordinate is valid in each.
    Physical page 0 is the null page."""
    plan = _ported_plan(cfg)
    shape = (plan.n_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"stack": {
        "k": torch.zeros(shape, dtype=knobs.cache_dtype, device=device),
        "v": torch.zeros(shape, dtype=knobs.cache_dtype, device=device),
    }}
