"""LM: the model wrapper the serving engine drives.

The PyTorch counterpart of ``repro/models/model.py``, dense serving
subset.  ``LM`` holds the arch config, the runtime knobs and the device;
its methods are functions of explicit params and caches.  Caches are
updated in place (the reference donates its buffers instead).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .layers import embed, embedding_init, rmsnorm, rmsnorm_init, unembed
from .transformer import (apply_blocks_decode, apply_blocks_prefill_chunk,
                          init_blocks, init_cache, supports_chunked_prefill)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device that is not there is
    an error: nothing falls back to the CPU unless the caller asks."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class RuntimeKnobs:
    """Execution knobs.  There is no ``use_pallas``: the device decides
    whether attention runs the CUDA kernels (CUDA tensors) or their plain
    versions (CPU tensors)."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    cache_dtype: Any = torch.bfloat16
    q_chunk: int = 512  # chunked-prefill query block
    # 0 = auto (the serving engine picks per tick from (max(pos), batch)
    # via runtime.steps.pick_decode_splits); >= 1 is a static override.
    # Both 0 and 1 take the single-pass kernel outside the engine.
    decode_splits: int = 0

    def with_(self, **kw) -> "RuntimeKnobs":
        return dataclasses.replace(self, **kw)


class LM:
    def __init__(self, cfg, knobs: Optional[RuntimeKnobs] = None,
                 device="cuda"):
        self.cfg = cfg
        self.knobs = knobs or RuntimeKnobs()
        self.device = resolve_device(device)

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> dict:
        """Random weights drawn from ``generator`` (its device is where the
        draws happen; the params land on ``self.device``)."""
        cfg, dt, dev = self.cfg, self.knobs.param_dtype, self.device
        return {
            "embed": embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings, dt, dev),
            "blocks": init_blocks(generator, cfg, dt, dev),
            "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
        }

    def _tokens(self, tokens):
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens, np.int64))
        return tokens.to(self.device)

    def _pos(self, pos):
        if not isinstance(pos, torch.Tensor):
            pos = torch.as_tensor(np.asarray(pos, np.int32))
        return pos.to(self.device, torch.int32)

    # ------------------------------------------------------------- decode
    def decode_step(self, params, caches, tokens, pos):
        """tokens (B,1) -> (logits (B,V) f32, caches updated in place).

        ``pos`` is a scalar (all slots in lockstep) or a (B,) vector of
        per-slot positions; slots parked at pos = -1 are inactive and give
        don't-care logits.
        """
        x = embed(params["embed"], self._tokens(tokens))
        x = x.to(self.knobs.compute_dtype)
        x, caches = apply_blocks_decode(params["blocks"], x, caches,
                                        self._pos(pos), cfg=self.cfg,
                                        knobs=self.knobs)
        x = rmsnorm(params["final_norm"], x)
        logits = unembed(params["embed"], x)[:, 0, :]
        return logits.float(), caches

    def prefill_chunk_step(self, params, caches, tokens, slot, offset):
        """One slot's prompt chunk: tokens (1,C) at positions
        offset..offset+C-1.  Writes the chunk's K/V at (slot, offset) in
        place; returns (chunk logits (C,V) f32, caches)."""
        x = embed(params["embed"], self._tokens(tokens))
        x = x.to(self.knobs.compute_dtype)
        x, caches = apply_blocks_prefill_chunk(
            params["blocks"], x, caches, slot, offset, cfg=self.cfg,
            knobs=self.knobs)
        x = rmsnorm(params["final_norm"], x)
        logits = unembed(params["embed"], x)[0]
        return logits.float(), caches

    def supports_chunked_prefill(self) -> bool:
        return supports_chunked_prefill(self.cfg)

    # -------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int):
        return init_cache(self.cfg, self.knobs, batch, max_len, self.device)

