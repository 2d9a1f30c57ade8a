"""granite-20b — dense, MQA (kv=1), code model.

[arXiv:2405.04324; hf]  52L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,  # MQA
    d_ff=24576,
    vocab_size=49152,
    gated_mlp=False,  # GPT-BigCode style 2-matrix MLP (matches ~20B count)
    supports_long_context=False,
    notes="llama-arch, MQA, code",
)
