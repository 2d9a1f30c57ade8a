"""Architecture / shape configuration schema.

Every assigned architecture is expressed as an ``ArchConfig``.  The four
assigned input shapes are global (same for every arch) and are expressed as
``ShapeSpec``.  ``input_specs`` describes every model input as a plain
``(shape, torch.dtype)`` pair (no device allocation).

Pure-python module: importing it must never touch device state.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The assigned shape set (identical across the 10 LM-family archs).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff: int  # per-expert hidden dim
    capacity_factor: float = 1.25
    # inference (prefill/decode) capacity: higher to keep drops negligible
    eval_capacity_factor: float = 2.0
    # dispatch is chunked along the sequence to keep the one-hot dispatch
    # einsum linear in seq_len (see DESIGN.md / models/moe.py).
    dispatch_chunk: int = 512
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    """A single assigned architecture."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int  # query heads (0 for attention-free archs)
    num_kv_heads: int
    d_ff: int  # dense FFN hidden dim (0 when every FFN is MoE / SSM)
    vocab_size: int
    head_dim: int = 0  # 0 -> derived d_model // num_heads
    # --- attention pattern ---
    window: int = 0  # global sliding-window (mixtral SWA); 0 = full causal
    local_window: int = 0  # window of the *local* layers (gemma3)
    local_global_period: int = 0  # gemma3: every Nth layer is global
    qkv_bias: bool = False
    gated_mlp: bool = True  # SwiGLU; False -> 2-matrix GELU MLP (granite)
    rope_theta: float = 10_000.0
    # --- mixture of experts ---
    moe: Optional[MoEConfig] = None
    # --- state-space (mamba2 / hybrid) ---
    ssm: Optional[SSMConfig] = None
    # zamba2-style shared attention block applied every N ssm layers
    shared_attn_period: int = 0
    # --- input modality ---
    input_mode: str = "tokens"  # "tokens" | "embeddings" (vlm stub frontend)
    tie_embeddings: bool = True
    # long_500k applicability (sub-quadratic attention available?)
    supports_long_context: bool = False
    notes: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.num_heads == 0

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind: 'attn' | 'ssm' | 'moe' | 'local' | 'global'.

        The transformer assembles blocks from this list; identical kinds are
        stacked and scanned.
        """
        kinds = []
        for i in range(self.num_layers):
            if self.family in ("ssm",):
                kinds.append("ssm")
            elif self.family == "hybrid":
                kinds.append("ssm")  # shared attention handled separately
            elif self.moe is not None:
                kinds.append("moe")
            elif self.local_global_period:
                # layer i is global iff (i+1) % period == 0 (gemma3 5:1)
                kinds.append(
                    "global" if (i + 1) % self.local_global_period == 0 else "local"
                )
            else:
                kinds.append("attn")
        return kinds

    # --- parameter counting (for roofline MODEL_FLOPS = 6*N*D) -----------
    def param_count(self, active_only: bool = False) -> int:
        dm, L = self.d_model, self.num_layers
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * dm * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind == "ssm":
                assert self.ssm is not None
                di = self.ssm.d_inner(dm)
                nh = self.ssm.n_heads(dm)
                g, s = self.ssm.n_groups, self.ssm.d_state
                # in_proj: x,z branches + B,C,dt ; out_proj
                n += dm * (2 * di + 2 * g * s + nh)
                n += di * dm
                n += self.ssm.conv_width * (di + 2 * g * s)  # conv1d
                n += 2 * nh  # A_log, D
            else:  # attention sublayer
                hd = self.head_dim
                n += dm * self.num_heads * hd  # wq
                n += 2 * dm * self.num_kv_heads * hd  # wk, wv
                n += self.num_heads * hd * dm  # wo
            # ffn sublayer
            if kind == "moe":
                assert self.moe is not None
                e = self.experts_counted(active_only)
                n += dm * self.moe.num_experts  # router (always full)
                n += e * 3 * dm * self.moe.d_ff
            elif kind != "ssm":
                n += (3 if self.gated_mlp else 2) * dm * self.d_ff
            n += 2 * dm  # two rmsnorm scales
        if self.shared_attn_period:
            # one shared transformer block (zamba-style), weights reused
            hd = self.head_dim
            n += dm * self.num_heads * hd + 2 * dm * self.num_kv_heads * hd
            n += self.num_heads * hd * dm + 3 * dm * self.d_ff + 2 * dm
        n += dm  # final norm
        return n

    def experts_counted(self, active_only: bool) -> int:
        assert self.moe is not None
        return self.moe.experts_per_token if active_only else self.moe.num_experts

    def model_flops_per_token(self) -> float:
        """6 * N (active) — the standard training-FLOPs estimate per token."""
        return 6.0 * self.param_count(active_only=True)


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced config of the same family for CPU smoke tests."""
    changes: dict = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16 if cfg.num_heads else 0,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_heads else 0,
        window=64 if cfg.window else 0,
        local_window=32 if cfg.local_window else 0,
        local_global_period=2 if cfg.local_global_period else 0,
        shared_attn_period=2 if cfg.shared_attn_period else 0,
    )
    if cfg.moe is not None:
        changes["moe"] = replace(
            cfg.moe, num_experts=4, experts_per_token=2, d_ff=32, dispatch_chunk=16
        )
    if cfg.ssm is not None:
        changes["ssm"] = replace(cfg.ssm, d_state=8, head_dim=16, chunk_size=8)
    if cfg.family == "hybrid":
        changes["num_layers"] = 4
    return replace(cfg, **changes)


def input_specs(cfg: ArchConfig, shape: ShapeSpec):
    """``(shape, torch.dtype)`` stand-ins for every model input of this
    (arch, shape).

    Decode shapes additionally need the KV cache shapes, which depend on
    model internals — those come from ``LM.init_cache``.
    """
    import torch

    b, s = shape.global_batch, shape.seq_len
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeddings":
            specs["embeds"] = ((b, s, cfg.d_model), torch.bfloat16)
            specs["tokens"] = ((b, s), torch.int32)  # labels
        else:
            specs["tokens"] = ((b, s), torch.int32)
    else:  # decode: one new token against a cache of seq_len
        specs["tokens"] = ((b, 1), torch.int32)
        specs["pos"] = ((), torch.int32)
    return specs
