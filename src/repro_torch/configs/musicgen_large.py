"""musicgen-large — audio; decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048.  The EnCodec tokenizer frontend is a STUB — inputs are
precomputed audio-token ids (single interleaved stream).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,  # MHA
    d_ff=8192,
    vocab_size=2048,
    tie_embeddings=False,
    supports_long_context=False,
    notes="decoder-only over EnCodec tokens; frontend stubbed",
)
