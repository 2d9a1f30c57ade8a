"""Serving step functions and the step cache (dense, greedy subset).

The PyTorch counterpart of ``repro/runtime/steps.py``.  There is no jit:
a step is a plain callable that runs eagerly and updates the caches in
place.  ``compiled_step`` keeps the reference's shape and keying so the
engine code reads the same; it memoizes the built callables.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable

import torch


def make_serve_step(model) -> Callable:
    """Decode step: ``pos`` scalar (lockstep wave) or (B,) (ragged
    continuous batching, free slots parked at -1).  Returns (next tokens
    (B,1) int32, caches)."""
    def serve_step(params, caches, tokens, pos):
        logits, caches = model.decode_step(params, caches, tokens, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], caches

    return serve_step


def make_prefill_chunk_step(model) -> Callable:
    """Chunked prefill step: ONE slot's (1, C) chunk at absolute ``offset``.
    Returns (greedy next token per chunk row (C,) int32, caches)."""
    def prefill_chunk_step(params, caches, tokens, slot, offset):
        logits, caches = model.prefill_chunk_step(params, caches, tokens,
                                                  slot, offset)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return prefill_chunk_step


def decode_one(model) -> Callable:
    """The wave engine's step: raw logits (B,V) f32 and caches."""
    return model.decode_step


_STEP_KINDS = {
    "serve": make_serve_step,
    "prefill_chunk": make_prefill_chunk_step,
    "decode_one": decode_one,
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
    fan-out steps).  Sampled, paged and speculative steps come in later
    slices."""
    global _step_cache_hits, _step_cache_misses, _step_build_s
    if sampled or page_size or draft_len or kind not in _STEP_KINDS:
        raise NotImplementedError(
            f"step kind={kind!r} sampled={sampled} page_size={page_size} "
            f"draft_len={draft_len} is not ported yet (see ROADMAP.md)")
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
    fn = _STEP_KINDS[kind](mdl)
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
