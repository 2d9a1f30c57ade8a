"""qwen3-moe-235b-a22b — MoE 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B; hf]  94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128e top-8.  head_dim=128 (public value).
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,  # every FFN is MoE
    vocab_size=151936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_ff=1536),
    tie_embeddings=False,
    supports_long_context=False,
    notes="128 experts top-8; expert-parallel over the model axis",
)
