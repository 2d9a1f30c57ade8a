"""Step functions: the train step (grad-accum microbatching and AdamW),
the serving steps and the step cache (dense and paged, greedy and sampled,
the speculative verify step), and the batched whole-prompt prefill step.

The PyTorch counterpart of ``repro/runtime/steps.py``.  There is no jit:
a step is a plain callable that runs eagerly and updates the caches in
place.  ``compiled_step`` keeps the reference's shape and keying so the
engine code reads the same; it memoizes the built callables.

A sampled step grows its signature by the per-slot sampling arrays
(``temp[B]``, ``top_k[B]``, ``top_p[B]``, ``keys[B, 2]``; a prefill chunk
by one request's scalars and key) and draws through
``runtime.sampling``; rows with ``temp <= 0`` stay the bitwise-greedy
argmax.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable

import torch

from ..optim import adamw_init, adamw_update, warmup_cosine
from ..optim.adamw import AdamWConfig, tree_leaves, tree_map
from ..sharding.zero import (ShardedTrainStep, is_sharded, shard_state,
                             state_shardings_of)
from .sampling import sample_tokens, sample_tokens_multi


def _unflatten(tree, leaves):
    """``tree``'s structure over ``leaves``, given in ``tree_leaves``
    (sorted-key) order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def init_train_state(model, generator: torch.Generator,
                     moments_dtype=torch.float32, shardings=None) -> dict:
    """{"params", "opt"}: params drawn by ``model.init(generator)`` (f32
    leaves cast to ``knobs.param_dtype``), the AdamW state built from the
    drawn values.  A model over a mesh (``sharding.make_shard_fn``) keeps
    the rank's blocks of each leaf under ``shardings`` (default: the
    mesh's ``train_state_shardings``), drawn whole as unsharded."""
    if shardings is not None and not is_sharded(model):
        raise ValueError("shardings need a model over a mesh "
                         "(knobs.shard_fn = sharding.make_shard_fn(...))")
    params_f32 = model.init(generator)
    params = tree_map(lambda p: p.to(model.knobs.param_dtype)
                      if p.dtype == torch.float32 else p, params_f32)
    if is_sharded(model):
        specs, mesh = (state_shardings_of(model, shardings),
                       model.knobs.shard_fn.mesh)
        params = shard_state(params, specs["params"], mesh)
        params_f32 = shard_state(params_f32, specs["opt"]["master"], mesh)
    return {"params": params, "opt": adamw_init(params_f32, moments_dtype)}


def _value_and_grad(model, params, batch):
    """(loss, metrics, grads in ``tree_leaves`` order) of ``model.loss`` at
    ``params``; a leaf the loss does not read gets a zero gradient, as
    under ``jax.grad``."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = model.loss(_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, opt_cfg: AdamWConfig, grad_accum: int = 1,
                    accum_dtype=torch.float32, grad_shardings=None, *,
                    state_shardings=None, batch_shardings=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``.  With
    ``grad_accum > 1`` the batch's B rows go as ``grad_accum`` microbatches
    of B / grad_accum consecutive rows, their gradients summed in
    ``accum_dtype`` (bf16 halves the accumulator) and divided by
    ``grad_accum``; the metrics are the microbatches' means and ``loss``
    their summed loss over ``grad_accum``.  Then AdamW: the new params are
    the new master cast to each param's dtype.  The state's tensors are
    updated in place (the reference donates the state) and returned; the
    metrics add ``grad_norm`` and ``lr``.

    A model over a mesh (``knobs.shard_fn = sharding.make_shard_fn(mesh,
    cfg)``) gets a ``sharding.zero.ShardedTrainStep``: the state holds the
    rank's blocks under ``state_shardings`` (default the mesh's
    ``train_state_shardings``), ``batch`` is the global batch, cut by
    ``batch_shardings`` (default ``sharding.batch_shardings``), and
    ``grad_shardings`` (``sharding.grad_shardings``) reduce-scatters each
    microbatch's gradients into the rank's block (ZeRO-2)."""
    schedule = warmup_cosine(opt_cfg)
    if is_sharded(model):
        return ShardedTrainStep(model, opt_cfg, grad_accum, accum_dtype,
                                schedule, grad_shardings, state_shardings,
                                batch_shardings)
    if (grad_shardings, state_shardings, batch_shardings) != (None,) * 3:
        raise ValueError("shardings need a model over a mesh "
                         "(knobs.shard_fn = sharding.make_shard_fn(...))")

    def train_step(state, batch):
        params = state["params"]
        if grad_accum == 1:
            _, metrics, grads = _value_and_grad(model, params, batch)
            grads = [g.to(accum_dtype) for g in grads]
        else:
            n = next(iter(batch.values())).shape[0] // grad_accum
            grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                     for p in tree_leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            ms = []
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss, m, g = _value_and_grad(model, params, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(accum_dtype))
                lsum = lsum + loss
                ms.append(m)
            for acc in grads:
                acc.div_(grad_accum)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
            metrics["loss"] = lsum / grad_accum
        new_master, new_opt, om = adamw_update(
            _unflatten(params, grads), state["opt"], opt_cfg, schedule)
        with torch.no_grad():
            for p, m in zip(tree_leaves(params), tree_leaves(new_master)):
                p.copy_(m)
        metrics.update(om)
        return {"params": params, "opt": new_opt}, metrics

    return train_step


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_serve_step(model, sampled: bool = False) -> Callable:
    """Decode step: ``pos`` scalar (lockstep wave) or (B,) (ragged
    continuous batching, free slots parked at -1).  Returns (next tokens
    (B,1) int32, caches)."""
    def serve_step(params, caches, tokens, pos):
        logits, caches = model.decode_step(params, caches, tokens, pos)
        return _greedy(logits)[:, None], caches

    def sampled_serve_step(params, caches, tokens, pos, temp, top_k, top_p,
                           keys):
        logits, caches = model.decode_step(params, caches, tokens, pos)
        return sample_tokens(logits, pos, temp, top_k, top_p,
                             keys)[:, None], caches

    return sampled_serve_step if sampled else serve_step


def make_prefill_step(model) -> Callable:
    """Batched whole-prompt prefill: batch {"tokens": (B,S)} -> (greedy
    first tokens (B,1) int32, caches)."""
    def prefill_step(params, batch):
        logits, caches = model.prefill(params, batch)
        return _greedy(logits)[:, None], caches

    return prefill_step


def _sample_row(logits, offset, last_row, temp, top_k, top_p, key):
    """One request's draw from chunk row ``last_row`` (the last real
    prompt token), folded at its absolute position ``offset + last_row``,
    one below the first decode step's fold.  Returns a () int32 tensor."""
    row = logits[int(last_row)][None]
    return sample_tokens(row, [int(offset) + int(last_row)], [temp],
                         [top_k], [top_p], [key])[0]


def make_prefill_chunk_step(model, sampled: bool = False) -> Callable:
    """Chunked prefill step: ONE slot's (1, C) chunk at absolute ``offset``.
    Returns (greedy next token per chunk row (C,) int32, caches), or
    (``sampled=True``) the token drawn from row ``last_row`` (pass 0 for
    the chunks before the last) under the request's sampling params."""
    def prefill_chunk_step(params, caches, tokens, slot, offset):
        logits, caches = model.prefill_chunk_step(params, caches, tokens,
                                                  slot, offset)
        return _greedy(logits), caches

    def sampled_chunk_step(params, caches, tokens, slot, offset, last_row,
                           temp, top_k, top_p, key):
        logits, caches = model.prefill_chunk_step(params, caches, tokens,
                                                  slot, offset)
        return _sample_row(logits, offset, last_row, temp, top_k, top_p,
                           key), caches

    return sampled_chunk_step if sampled else prefill_chunk_step


def decode_one(model) -> Callable:
    """The wave engine's step: raw logits (B,V) f32 and caches."""
    return model.decode_step


def make_paged_serve_step(model, page_size: int,
                          sampled: bool = False) -> Callable:
    """Decode step over the paged pools: ``make_serve_step`` plus the
    page table ``page_idx`` (B, max_pages) int32."""
    def serve_step(params, caches, tokens, pos, page_idx):
        logits, caches = model.decode_step_paged(params, caches, tokens, pos,
                                                 page_idx,
                                                 page_size=page_size)
        return _greedy(logits)[:, None], caches

    def sampled_serve_step(params, caches, tokens, pos, page_idx, temp,
                           top_k, top_p, keys):
        logits, caches = model.decode_step_paged(params, caches, tokens, pos,
                                                 page_idx,
                                                 page_size=page_size)
        return sample_tokens(logits, pos, temp, top_k, top_p,
                             keys)[:, None], caches

    return sampled_serve_step if sampled else serve_step


def make_paged_prefill_chunk_step(model, page_size: int,
                                  sampled: bool = False) -> Callable:
    """Paged chunked prefill: the (1, C) chunk lands in the pages the
    slot's table row maps (C a page multiple, offset page-aligned);
    ``sampled=True`` as in ``make_prefill_chunk_step``."""
    def prefill_chunk_step(params, caches, tokens, slot, offset, page_idx):
        logits, caches = model.prefill_chunk_step_paged(
            params, caches, tokens, slot, offset, page_idx,
            page_size=page_size)
        return _greedy(logits), caches

    def sampled_chunk_step(params, caches, tokens, slot, offset, page_idx,
                           last_row, temp, top_k, top_p, key):
        logits, caches = model.prefill_chunk_step_paged(
            params, caches, tokens, slot, offset, page_idx,
            page_size=page_size)
        return _sample_row(logits, offset, last_row, temp, top_k, top_p,
                           key), caches

    return sampled_chunk_step if sampled else prefill_chunk_step


def make_spec_serve_step(model, draft_len: int,
                         sampled: bool = False) -> Callable:
    """Speculative verify step: tokens (B, T = draft_len + 1), the feed
    token and the drafts at positions ``pos[b] .. pos[b] + T - 1``, in one
    forward pass.  Returns (target (B, T) int32, caches): ``target[b, t]``
    is the token the model emits after feed + drafts[:t], the greedy
    argmax or (``sampled=True``) ``sample_tokens_multi``'s draw, each row
    folding its own absolute position."""
    def spec_step(params, caches, tokens, pos):
        logits, caches = model.decode_step_spec(params, caches, tokens, pos)
        return _greedy(logits), caches

    def sampled_spec_step(params, caches, tokens, pos, temp, top_k, top_p,
                          keys):
        logits, caches = model.decode_step_spec(params, caches, tokens, pos)
        return sample_tokens_multi(logits, pos, temp, top_k, top_p,
                                   keys), caches

    return sampled_spec_step if sampled else spec_step


def make_paged_spec_serve_step(model, page_size: int, draft_len: int,
                               sampled: bool = False) -> Callable:
    """Paged ``make_spec_serve_step`` (the page table after ``pos``; the
    block's K/V land in the slot's mapped pages)."""
    def spec_step(params, caches, tokens, pos, page_idx):
        logits, caches = model.decode_step_spec_paged(
            params, caches, tokens, pos, page_idx, page_size=page_size)
        return _greedy(logits), caches

    def sampled_spec_step(params, caches, tokens, pos, page_idx, temp,
                          top_k, top_p, keys):
        logits, caches = model.decode_step_spec_paged(
            params, caches, tokens, pos, page_idx, page_size=page_size)
        return sample_tokens_multi(logits, pos, temp, top_k, top_p,
                                   keys), caches

    return sampled_spec_step if sampled else spec_step


# kind -> make(model, page_size, sampled, draft_len); the paged kinds need
# page_size > 0, the others page_size == 0; the spec kinds draft_len > 0,
# the others draft_len == 0
_STEP_KINDS = {
    "serve": lambda m, ps, s, dl: make_serve_step(m, sampled=s),
    "prefill_chunk":
        lambda m, ps, s, dl: make_prefill_chunk_step(m, sampled=s),
    "decode_one": lambda m, ps, s, dl: decode_one(m),
    "paged_serve":
        lambda m, ps, s, dl: make_paged_serve_step(m, ps, sampled=s),
    "paged_prefill_chunk":
        lambda m, ps, s, dl: make_paged_prefill_chunk_step(m, ps, sampled=s),
    "spec_serve": lambda m, ps, s, dl: make_spec_serve_step(m, dl, sampled=s),
    "paged_spec_serve":
        lambda m, ps, s, dl: make_paged_spec_serve_step(m, ps, dl, sampled=s),
}
_STEP_CACHE: OrderedDict = OrderedDict()
_STEP_CACHE_MAX = 64
_step_cache_hits = 0
_step_cache_misses = 0
_step_build_s = 0.0


def step_cache_stats() -> dict:
    return {"hits": _step_cache_hits, "misses": _step_cache_misses,
            "size": len(_STEP_CACHE), "build_s": _step_build_s}


def compiled_step(model, kind: str, *, sampled: bool = False,
                  page_size: int = 0, decode_splits=None,
                  draft_len: int = 0) -> Callable:
    """Serving step for ``model``, memoized on (cfg, knobs, device, kind,
    sampled, page_size, draft_len) like the reference's jit cache.
    ``decode_splits`` overrides the knob (the split-K autotuner's per
    fan-out steps).  The paged kinds take ``page_size > 0``, the spec
    kinds ``draft_len > 0`` (each draft depth is its own step), and
    ``decode_one`` has no sampled variant (the wave engine samples from
    its logits)."""
    global _step_cache_hits, _step_cache_misses, _step_build_s
    if (kind not in _STEP_KINDS
            or (page_size > 0) != kind.startswith("paged_")
            or (draft_len > 0) != kind.endswith("spec_serve")
            or (sampled and kind == "decode_one")):
        raise ValueError(f"no step kind={kind!r} sampled={sampled} "
                         f"page_size={page_size} draft_len={draft_len}")
    knobs = (model.knobs if decode_splits is None
             else model.knobs.with_(decode_splits=decode_splits))
    key = (model.cfg, knobs, str(model.device), kind, sampled, page_size,
           draft_len)
    fn = _STEP_CACHE.get(key)
    if fn is not None:
        _step_cache_hits += 1
        _STEP_CACHE.move_to_end(key)
        return fn
    _step_cache_misses += 1
    t0 = time.perf_counter()
    mdl = (model if knobs is model.knobs
           else type(model)(model.cfg, knobs, model.device))
    fn = _STEP_KINDS[kind](mdl, page_size, sampled, draft_len)
    _step_build_s += time.perf_counter() - t0
    _STEP_CACHE[key] = fn
    while len(_STEP_CACHE) > _STEP_CACHE_MAX:
        _STEP_CACHE.popitem(last=False)
    return fn


# -------------------------------------------------------- split-K autotune
def pick_decode_splits(max_pos: int, batch: int, *, max_len: int,
                       page_size: int = 0, override: int = 0) -> int:
    """Choose the split-K fan-out for this decode tick.

    Split-K buys concurrency on the KV HBM stream: with few live slots
    and a long prefix, one sequential stream under-subscribes the memory
    system, so we split it.  With many live slots the batch axis already
    provides the parallelism and extra splits only pay combine overhead.

    Heuristic: double the splits while (a) each split still covers >= 2k
    tokens of live prefix, (b) total concurrent streams (batch * splits)
    stay <= 32, and (c) the split count divides the kernel's partition
    axis.  The dense kernel partitions the padded cache axis
    (``max_len``); the paged kernel tiles by whole pages, so with
    ``page_size > 0`` the splits must divide ``max_len // page_size``
    (the per-slot page count) — dividing ``max_len`` alone is not
    enough (e.g. max_len=96, page_size=16: 4 divides 96 but not the
    6 pages).  ``override >= 1`` (the ``RuntimeKnobs.decode_splits``
    static knob) bypasses the heuristic but is still clamped down to a
    divisor of the partition axis so a misconfigured knob cannot hand
    the kernel a ragged tiling.
    """
    units = max_len // page_size if page_size > 0 else max_len
    if override >= 1:
        splits = override
        while splits > 1 and units % splits:
            splits -= 1
        return splits
    if max_pos < 2048:
        return 1
    splits = 1
    while (splits < 8
           and max_pos // (2 * splits) >= 2048
           and 2 * splits * max(batch, 1) <= 32
           and units % (2 * splits) == 0):
        splits *= 2
    return splits
