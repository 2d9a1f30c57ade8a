"""llava-next-mistral-7b — VLM; mistral-7b backbone, anyres tiling frontend.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000.  The vision frontend (CLIP + anyres tiling
+ projector) is a STUB: ``input_specs()`` provides precomputed patch
embeddings of shape (batch, seq, d_model).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    input_mode="embeddings",
    tie_embeddings=False,
    supports_long_context=False,  # full attention -> skip long_500k
    notes="anyres tiling frontend stubbed; backbone only",
)
