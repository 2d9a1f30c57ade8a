"""qwen2.5-32b — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf]  64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    supports_long_context=False,
    notes="GQA, QKV bias",
)
