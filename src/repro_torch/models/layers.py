"""Shared layers: RMSNorm, RoPE, gated / GELU MLP, embeddings.

The PyTorch counterpart of ``repro/models/layers.py``.  Parameters are
plain dicts of tensors; weight init draws from an explicit
``torch.Generator``.  Compute happens in the dtype of the activations.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _init(gen: torch.Generator, shape, scale=0.02, dtype=torch.float32,
          device="cpu"):
    # drawn where the generator lives (a CUDA generator draws on the card)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (scale * w).to(device=device, dtype=dtype)


# ---------------------------------------------------------------- rmsnorm
def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """f32 upcast, eps 1e-6, scale applied in f32 (as the reference)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(dt)


# ------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """float64 numpy frequencies, cast to f32 at use (as the reference)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    two halves of the head (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- mlp
def mlp_init(gen, d_model: int, d_ff: int, gated: bool, dtype=torch.float32,
             device="cpu"):
    p = {}
    if gated:
        p["w_gate"] = _init(gen, (d_model, d_ff), dtype=dtype, device=device)
    p["w_up"] = _init(gen, (d_model, d_ff), dtype=dtype, device=device)
    p["w_down"] = _init(gen, (d_ff, d_model), dtype=dtype, device=device)
    return p


def mlp(params, x, gated: bool):
    if gated:
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


# ------------------------------------------------------------- embeddings
def embedding_init(gen, vocab: int, d_model: int, tied: bool,
                   dtype=torch.float32, device="cpu"):
    p = {"table": _init(gen, (vocab, d_model), dtype=dtype, device=device)}
    if not tied:
        p["head"] = _init(gen, (vocab, d_model), dtype=dtype, device=device)
    return p


def embed(params, tokens):
    return params["table"][tokens.long()]


def unembed(params, x):
    head = params.get("head", params["table"])
    return x @ head.T
