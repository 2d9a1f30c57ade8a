"""Mixture-of-Experts FFN with chunked capacity-based dispatch.

The PyTorch counterpart of ``repro/models/moe.py``, with its semantics: the
router runs in f32 (its weight stays f32 whatever the param dtype), each
token picks ``top_k`` experts by logit and weighs them by the softmax over
the chosen logits; the sequence is dispatched in chunks of
``min(dispatch_chunk, S)`` tokens, and inside a chunk each choice's
position in its expert comes from a cumsum in k-major order (every top-1
choice of the chunk before any top-2 choice).  A choice at or past the
expert's capacity ``max(k, int(chunk * k * cf / E))`` is dropped with its
weight; nothing is renormalised.

The reference computes dispatch and combine as one-hot einsums.  Here each
kept choice is copied by index into an (E, B * n * C, d) buffer, the three
expert products are batched matmuls over the expert axis, and each token
gathers its k outputs back with their weights.  The products' shapes
depend only on (B, n, E, C), never on the routing: a token's bits do not
depend on what the other tokens (another slot's, in a decode tick) chose.
Every expert's weights are read whether or not a token chose it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _identity_shard, _init


def moe_init(gen, d_model: int, moe_cfg, dtype=torch.float32, device="cpu"):
    e, dff = moe_cfg.num_experts, moe_cfg.d_ff
    return {
        "router": _init(gen, (d_model, e), dtype=torch.float32,
                        device=device),
        "w_gate": _init(gen, (e, d_model, dff), dtype=dtype, device=device),
        "w_up": _init(gen, (e, d_model, dff), dtype=dtype, device=device),
        "w_down": _init(gen, (e, dff, d_model), dtype=dtype, device=device),
    }


def _capacity(chunk: int, moe_cfg, train: bool) -> int:
    cf = moe_cfg.capacity_factor if train else moe_cfg.eval_capacity_factor
    c = int(chunk * moe_cfg.experts_per_token * cf / moe_cfg.num_experts)
    # never fewer slots than one token's k choices (decode must not drop)
    return max(moe_cfg.experts_per_token, c)


def moe_ffn(params, x, moe_cfg, *, train=True, shard_fn=_identity_shard):
    """x (B, S, d) -> (out (B, S, d), aux losses {"moe_lb_loss",
    "moe_z_loss", "moe_drop_frac"} as f32 scalars)."""
    b, s, d = x.shape
    e, k = moe_cfg.num_experts, moe_cfg.experts_per_token
    chunk = min(moe_cfg.dispatch_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the dispatch "
                         f"chunk {chunk}")
    n = s // chunk
    cap = _capacity(chunk, moe_cfg, train)
    # router in f32 (a bf16-stored router upcast, as the reference's einsum
    # promotes it); combine weights: softmax over the chosen logits
    logits = x.reshape(b, n, chunk, d).float() @ params["router"].float()
    top_vals, top_idx = torch.topk(logits, k, dim=-1)  # (b,n,c,k)
    top_w = torch.softmax(top_vals, dim=-1)
    # position in expert: cumsum over (k-major, then token) choices
    idx_flat = top_idx.transpose(2, 3).reshape(b, n, k * chunk)
    oh = F.one_hot(idx_flat, e)  # (b,n,k*c,E)
    pos_flat = (torch.cumsum(oh, dim=2) * oh).sum(-1) - 1
    pos = pos_flat.reshape(b, n, k, chunk).transpose(2, 3)  # (b,n,c,k)
    keep = (pos >= 0) & (pos < cap)
    m = b * n * cap  # rows per expert
    # the row of each choice in the (E * m + 1, d) buffer; a dropped choice
    # goes to the spare last row, which no product reads
    bn = torch.arange(b * n, device=x.device).reshape(b, n, 1, 1)
    row = top_idx * m + bn * cap + pos.clamp(0, cap - 1)
    row = torch.where(keep, row, e * m)
    buf = x.new_zeros((e * m + 1, d))
    xs = x.reshape(b, n, chunk, 1, d).expand(b, n, chunk, k, d)
    buf.index_copy_(0, row.reshape(-1), xs.reshape(-1, d))
    # the seams of the gather-form serving layout: a rank's experts' rows
    # in, every expert's rows back before the combine
    expert_in = shard_fn("moe_expert_in", buf[:e * m].view(e, m, d))
    h = F.silu(torch.bmm(expert_in, params["w_gate"]))
    h = h * torch.bmm(expert_in, params["w_up"])
    expert_out = shard_fn("moe_expert_out", torch.bmm(h, params["w_down"]))
    expert_out = expert_out.reshape(e * m, d)
    w = torch.where(keep, top_w, 0.0).to(x.dtype)
    got = expert_out[torch.where(keep, row, 0).reshape(-1)]
    out = (got.reshape(b, n, chunk, k, d) * w[..., None]).sum(3)

    # aux losses: load balance (kept choices per expert against the mean
    # router probability), z-loss, and the dropped share of the choices.
    # The load balance is a product of batch means: in training under
    # data parallelism both means are the global batch's
    # ("moe_batch_mean": the batch ranks' mean, the identity unsharded)
    probs = torch.softmax(logits, dim=-1)
    kept = (F.one_hot(top_idx, e) * keep[..., None]).float().sum(3)
    batch_mean = shard_fn if train else _identity_shard
    frac = batch_mean("moe_batch_mean", kept.mean(dim=(0, 1, 2))) / k
    mean_prob = batch_mean("moe_batch_mean", probs.mean(dim=(0, 1, 2)))
    aux = {"moe_lb_loss": e * (frac * mean_prob).sum(),
           "moe_z_loss": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return out.reshape(b, s, d), aux


def moe_ffn_ref(params, x, moe_cfg):
    """Dense oracle: every expert computes every token, no capacity (for
    tests only)."""
    e, k = moe_cfg.num_experts, moe_cfg.experts_per_token
    logits = x.float() @ params["router"]
    top_vals, top_idx = torch.topk(logits, k, dim=-1)
    top_w = torch.softmax(top_vals, dim=-1)
    gates = (F.one_hot(top_idx, e).to(x.dtype)
             * top_w[..., None].to(x.dtype)).sum(2)  # (b,s,E)
    h_gate = torch.einsum("bsd,edf->bsef", x, params["w_gate"])
    h_up = torch.einsum("bsd,edf->bsef", x, params["w_up"])
    y = torch.einsum("bsef,efd->bsed", F.silu(h_gate) * h_up,
                     params["w_down"])
    return torch.einsum("bse,bsed->bsd", gates, y)
