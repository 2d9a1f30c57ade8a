"""LM: the model wrapper that training, the serving engine and the prefill
step drive.

The PyTorch counterpart of ``repro/models/model.py``: the whole-sequence
forward (``hidden``, ``prefill``, and ``loss``, which autograd
differentiates on the training route), decode, the
speculative verify block and chunked prefill over dense caches and paged
pools, the dense checkpoint copies of preemption and the page copies of
copy-on-write and the disaggregated handoff.  ``LM`` holds the arch
config, the runtime knobs and the device; its methods are functions of
explicit params and caches.  Caches are updated in place (the reference
donates its buffers instead).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .layers import (_identity_shard, chunked_ce_loss, embed,
                     embedding_init, rmsnorm, rmsnorm_init, unembed)
from .transformer import (_cat_rows, _row, apply_blocks, apply_blocks_decode,
                          apply_blocks_prefill_chunk, cache_batch_axes,
                          copy_cache_in, copy_cache_out, copy_cache_pages,
                          copy_cache_pages_across, init_blocks,
                          init_cache, init_cache_paged,
                          supports_chunked_prefill, supports_paged_cache,
                          supports_speculative)

MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3


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
    q_chunk: int = 512  # query block of chunked prefill and training
    ce_chunk: int = 1024  # chunked cross-entropy block
    # training: recompute each layer (and group) in the backward pass
    remat: bool = True
    # 0 = auto (the serving engine picks per tick from (max(pos), batch)
    # via runtime.steps.pick_decode_splits); >= 1 is a static override.
    # Both 0 and 1 take the single-pass kernel outside the engine.
    decode_splits: int = 0
    # training route: causal attention as the reference's recursive
    # triangle (``attention._flash_causal_recursive``): the upper half of
    # the queries attends the whole prefix, the lower half recurses on a
    # prefix half as long, so most fully masked blocks are never computed
    causal_skip: bool = False
    # quantized paged KV: "" (pools at cache_dtype), "int8" or "fp8"
    # (float8_e4m3fn); set by ServeEngine from ServeConfig.kv_dtype
    kv_quant: str = ""
    # the seams' hook of sharded serving (``sharding.rules.ServeShardFn``):
    # shard_fn(name, x) at the reference's seams; the identity unsharded
    shard_fn: Callable = _identity_shard

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
        """Tokens on the model's device.  Host tokens go without waiting
        for the work queued on the card (a blocking copy would stall the
        host at every prefill chunk); the port pins no host memory, so
        the copy is staged or done at the call and the caller may reuse
        its array at once."""
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens, np.int64))
        return tokens.to(self.device, non_blocking=True)

    def _page_idx(self, page_idx):
        """int32 on the model's device, no copy if already so."""
        if not isinstance(page_idx, torch.Tensor):
            page_idx = torch.as_tensor(np.asarray(page_idx, np.int32))
        return page_idx.to(self.device, torch.int32)

    # ------------------------------------------------------------ forward
    def _embed_inputs(self, params, batch):
        """The input rows of the whole-sequence forward: ``batch["embeds"]``
        (B,S,dm) for an arch whose ``input_mode`` is "embeddings" (the VLM
        stub front end), else the embedded ``batch["tokens"]``; in
        ``knobs.compute_dtype``."""
        if self.cfg.input_mode == "embeddings":
            x = batch["embeds"]
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            x = x.to(self.device)
        else:
            x = embed(params["embed"], self._tokens(batch["tokens"]))
        return x.to(self.knobs.compute_dtype)

    def hidden(self, params, batch, mode: str):
        """The whole-sequence forward: batch {"tokens": (B,S)} (and
        "embeds" (B,S,dm) for an embeddings-input arch) -> (final-norm
        hidden (B,S,dm), aux, caches or None).  ``mode`` is "train" (no
        caches) or "prefill" (every layer's cache)."""
        x = self._embed_inputs(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = self.knobs.shard_fn("hidden", x)
        # a sequence-parallel hook (``sharding.rules.SequenceShardFn``)
        # takes the layers over the rank's sequence slice; the final norm
        # and what follows see the whole sequence again
        seq = getattr(self.knobs.shard_fn, "sequence", None)
        knobs = self.knobs if seq is None else self.knobs.with_(shard_fn=seq)
        x = knobs.shard_fn("seq_in", x)
        x, aux, caches = apply_blocks(params["blocks"], x, positions,
                                      cfg=self.cfg, knobs=knobs, mode=mode)
        x = knobs.shard_fn("seq_out", x)
        x = rmsnorm(params["final_norm"], x)
        return x, aux, caches

    def loss(self, params, batch):
        """Next-token CE over batch {"tokens": (B,S)} (and "embeds"), plus
        the MoE auxiliary losses: (loss, {"ce_loss", "loss"} and, with MoE
        FFNs, "moe_lb_loss", "moe_z_loss", "moe_drop_frac", each the mean
        over the MoE layers).  It runs the training route (``apply_blocks``
        mode "train": no kernel, remat per ``knobs.remat``), so autograd
        differentiates it with respect to the params."""
        x, aux, _ = self.hidden(params, batch, mode="train")
        tokens = self._tokens(batch["tokens"])
        targets = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
        mask = torch.nn.functional.pad(
            torch.ones_like(tokens[:, 1:], dtype=torch.float32), (0, 1))
        ce = chunked_ce_loss(params["embed"], x, targets, mask,
                             chunk=self.knobs.ce_chunk)
        loss, metrics = ce, {"ce_loss": ce}
        if aux:
            n_moe = max(1, self.cfg.layer_kinds().count("moe"))
            lb = aux["moe_lb_loss"] / n_moe
            zl = aux["moe_z_loss"] / n_moe
            loss = loss + MOE_LB_COEF * lb + MOE_Z_COEF * zl
            metrics.update(moe_lb_loss=lb, moe_z_loss=zl,
                           moe_drop_frac=aux["moe_drop_frac"] / n_moe)
        metrics["loss"] = loss
        return loss, metrics

    def prefill(self, params, batch):
        """The batched whole-prompt prefill: (last-position logits (B,V)
        f32, caches).  Attention caches are (..., B, S, KV, D) leaves of
        the plan's tree in ``knobs.cache_dtype``; SSM caches hold the final
        conv window and state."""
        x, _, caches = self.hidden(params, batch, mode="prefill")
        logits = unembed(params["embed"], x[:, -1:, :])[:, 0, :]
        return logits.float(), caches

    # ------------------------------------------------------------- decode
    def _decode(self, params, caches, tokens, pos, paged=None):
        """tokens (B,T) at positions pos[b] + t -> (logits (B,T,V) f32,
        caches).  A verify block (T > 1) takes the final norm and the
        unembedding row by row, in the one-token tick's shape, as its
        layers do (``transformer._apply_attn_block_decode``)."""
        x = embed(params["embed"], self._tokens(tokens))
        x = x.to(self.knobs.compute_dtype)
        x, caches = apply_blocks_decode(params["blocks"], x, caches, pos,
                                        cfg=self.cfg, knobs=self.knobs,
                                        paged=paged)
        logits = _cat_rows([unembed(params["embed"],
                                    rmsnorm(params["final_norm"], _row(x, t)))
                            for t in range(x.shape[1])])
        return logits.float(), caches

    def decode_step(self, params, caches, tokens, pos):
        """tokens (B,1) -> (logits (B,V) f32, caches updated in place).

        ``pos`` is a scalar (all slots in lockstep) or a (B,) vector of
        per-slot positions; slots parked at pos = -1 are inactive and give
        don't-care logits.
        """
        logits, caches = self._decode(params, caches, tokens, pos)
        return logits[:, 0, :], caches

    def decode_step_spec(self, params, caches, tokens, pos):
        """The speculative verify block: tokens (B,T), the feed token and
        up to T-1 drafted continuations at positions ``pos[b] ..
        pos[b] + T-1`` -> (logits (B,T,V) f32, caches).

        All T K/V rows are written before attention, which is causal
        within the block, so logits row ``t`` is the next-token
        distribution given tokens[:, :t+1]: bitwise the logits of the
        one-token ``decode_step`` at ``pos + t`` after the rows before it.
        Rejected drafts roll back by position: stale K/V past the accepted
        position is masked until a later write overwrites it."""
        return self._decode(params, caches, tokens, pos)

    def decode_step_spec_paged(self, params, caches, tokens, pos, page_idx,
                               *, page_size: int):
        """Paged ``decode_step_spec``: the block's K/V land in the pages
        the slot's table row maps; rows past the table's span write the
        null page (``attention.paged_cache_update_multi``)."""
        return self._decode(params, caches, tokens, pos,
                            (self._page_idx(page_idx), page_size))

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

    def supports_speculative(self) -> bool:
        return supports_speculative(self.cfg)

    # -------------------------------------------------------- paged cache
    def supports_paged_cache(self) -> bool:
        return supports_paged_cache(self.cfg)

    def decode_step_paged(self, params, caches, tokens, pos, page_idx, *,
                          page_size: int):
        """Paged ``decode_step``: caches are global page pools and slot
        ``b``'s KV prefix lives in pages ``page_idx[b]`` (0 = null page).
        Pass ``page_idx`` as an int32 tensor on the model's device (the
        engine copies its table once per tick); every layer reads it."""
        logits, caches = self._decode(params, caches, tokens, pos,
                                      (self._page_idx(page_idx), page_size))
        return logits[:, 0, :], caches

    def prefill_chunk_step_paged(self, params, caches, tokens, slot, offset,
                                 page_idx, *, page_size: int):
        """Paged ``prefill_chunk_step``: the chunk (C a multiple of
        ``page_size``, ``offset`` page-aligned) writes the pages the slot's
        page-table row maps, and attention reads the prefix through it."""
        x = embed(params["embed"], self._tokens(tokens))
        x = x.to(self.knobs.compute_dtype)
        x, caches = apply_blocks_prefill_chunk(
            params["blocks"], x, caches, slot, offset, cfg=self.cfg,
            knobs=self.knobs, paged=(self._page_idx(page_idx), page_size))
        x = rmsnorm(params["final_norm"], x)
        logits = unembed(params["embed"], x)[0]
        return logits.float(), caches

    # -------------------------------------------------------------- cache
    def cache_batch_axes(self, max_len: int):
        """Per-leaf batch-axis tree of the dense cache (host-side)."""
        return cache_batch_axes(self.cfg, self.knobs, max_len)

    def copy_cache_out(self, caches, slot, axes, device=None):
        """A copy of slot ``slot``'s stripe of every dense cache leaf (KV,
        or SSM state) on ``device`` (default: the caches'): a preemption
        checkpoint."""
        return copy_cache_out(caches, slot, axes, device)

    def copy_cache_in(self, caches, snapshot, slot, axes):
        """Restore a ``copy_cache_out`` snapshot into slot ``slot``, in
        place."""
        return copy_cache_in(caches, snapshot, slot, axes)

    def copy_cache_pages(self, caches, src, dst):
        """Device half of copy-on-write: duplicate physical page ``src``
        -> ``dst`` in every layer's pool, in place."""
        return copy_cache_pages(caches, src, dst)

    def copy_cache_pages_across(self, src_caches, dst_caches, src_idx,
                                dst_idx):
        """Cross-engine page transfer (the disaggregated handoff): gather
        the ``src_idx`` pages of one engine's pools and write them at
        ``dst_idx`` in another's, in place (the reference donates the
        destination instead)."""
        return copy_cache_pages_across(src_caches, dst_caches, src_idx,
                                       dst_idx)

    def init_cache(self, batch: int, max_len: int):
        return init_cache(self.cfg, self.knobs, batch, max_len, self.device)

    def init_cache_paged(self, num_pages: int, page_size: int):
        return init_cache_paged(self.cfg, self.knobs, num_pages, page_size,
                                self.device)

