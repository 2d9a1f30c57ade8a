"""gemma3-27b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]  62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144.  Every 6th layer is global attention; the other five
use a 1024-token sliding window.  head_dim=128 (public value).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    local_window=1024,
    local_global_period=6,  # 5 local : 1 global
    rope_theta=1_000_000.0,
    supports_long_context=True,  # 52/62 layers windowed; decode attn is O(seq)
    notes="5:1 local:global; local layers window=1024",
)
