"""internlm2-1.8b — dense GQA.

[arXiv:2403.17297; hf]  24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    supports_long_context=False,
    notes="GQA",
)
