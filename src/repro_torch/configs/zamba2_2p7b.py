"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]  54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  The attention block is *shared* (Zamba-style: one
set of transformer-block weights applied periodically along the depth).
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,  # MHA in the shared block
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1),
    shared_attn_period=6,  # shared transformer block every 6 mamba layers
    supports_long_context=True,  # SSM state is O(1); shared attn windowed at decode
    notes="Mamba2 + shared attn blocks [arXiv:2411.15242]",
)
