"""mamba2-1.3b — attention-free SSM (state-space duality / SSD).

[arXiv:2405.21060; unverified]  48L d_model=2048 (attn-free) d_ff=0
vocab=50280, ssm_state=128.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,  # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    supports_long_context=True,  # O(1) state: the long_500k showcase
    notes="SSD (state-space duality)",
)
