"""Shared layers: RMSNorm, RoPE, gated / GELU MLP, embeddings, chunked
next-token cross-entropy, and ``remat``.

The PyTorch counterpart of ``repro/models/layers.py``.  Parameters are
plain dicts of tensors; weight init draws from an explicit
``torch.Generator``.  Compute happens in the dtype of the activations.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _init(gen: torch.Generator, shape, scale=0.02, dtype=torch.float32,
          device="cpu"):
    # drawn where the generator lives (a CUDA generator draws on the card);
    # a tensor on the meta device is only a shape, and draws nothing
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (scale * w).to(device=device, dtype=dtype)


def _requires_grad(args) -> bool:
    """Whether autograd records a call on ``args``: grad mode on and a
    tensor among them (in nested dicts, lists and tuples too) requiring
    grad."""
    if not torch.is_grad_enabled():
        return False
    todo = list(args)
    while todo:
        a = todo.pop()
        if isinstance(a, torch.Tensor):
            if a.requires_grad:
                return True
        elif isinstance(a, dict):
            todo.extend(a.values())
        elif isinstance(a, (list, tuple)):
            todo.extend(a)
    return False


def remat(fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward pass
    instead of kept (``torch.utils.checkpoint``, non-reentrant: the
    counterpart of ``jax.checkpoint``) when autograd records the call;
    a plain call otherwise, so serving pays nothing for it.  ``fn`` must be
    deterministic: the recompute has to give the tensors the forward
    gave."""
    if _requires_grad(args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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


def _identity_shard(name, x):
    return x


def mlp(params, x, gated: bool, shard_fn=_identity_shard):
    """``shard_fn("mlp_up", ...)`` is the seam of the gather-form serving
    layout (``sharding.rules.ServeShardFn``): it all-gathers the
    ff-sharded up/gate products, so that the activation and the down
    product run replicated, in the single-device order.  The seam sits on
    the products, before the activation, as the reference's does."""
    if gated:
        g = shard_fn("mlp_up", x @ params["w_gate"])
        u = shard_fn("mlp_up", x @ params["w_up"])
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(shard_fn("mlp_up", x @ params["w_up"]),
                   approximate="tanh")
    return h @ params["w_down"]


# ------------------------------------------------------------- embeddings
def embedding_init(gen, vocab: int, d_model: int, tied: bool,
                   dtype=torch.float32, device="cpu"):
    p = {"table": _init(gen, (vocab, d_model), dtype=dtype, device=device)}
    if not tied:
        p["head"] = _init(gen, (vocab, d_model), dtype=dtype, device=device)
    return p


def embed(params, tokens):
    """The table's rows at ``tokens``: ``F.embedding``, whose backward sums
    a repeated token's rows in a fixed order; indexing ``table[tokens]``
    gives the same rows, but its backward accumulates with atomics, so its
    gradient changes from run to run (measured on the CPU)."""
    return F.embedding(tokens.long(), params["table"])


def unembed(params, x):
    head = params.get("head", params["table"])
    return x @ head.T


# --------------------------------------------------- chunked CE next-token
def chunked_ce_loss(emb_params, x, targets, mask, chunk: int = 1024):
    """Next-token cross-entropy without materializing (B, S, V) logits.

    x: (B, S, d) final hidden states; targets/mask: (B, S).  A loop over
    sequence chunks: each chunk's (B, chunk, V) f32 logits exist only
    transiently, against the tied head when there is no separate one.
    Under autograd each chunk is rematerialized (``remat``, as the
    reference's nested ``jax.checkpoint``): without it the backward would
    keep every chunk's logits, the whole (B, S, V) tensor.
    """
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by CE chunk {chunk}")
    head = emb_params.get("head", emb_params["table"])

    def body(xc, tc, mc, head):
        logits = (xc @ head.T).float()  # (B, chunk, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
        return ((logz - gold) * mc).sum(), mc.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        nll, n = remat(body, x[:, i:i + chunk], targets[:, i:i + chunk],
                       mask[:, i:i + chunk].float(), head)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
