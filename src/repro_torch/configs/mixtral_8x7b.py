"""mixtral-8x7b — MoE 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA window 4096.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=0,  # every FFN is MoE
    vocab_size=32000,
    window=4096,  # SWA
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff=14336),
    tie_embeddings=False,
    supports_long_context=True,  # SWA bounds the KV window
    notes="8 experts top-2, SWA 4096",
)
