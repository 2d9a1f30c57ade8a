"""Mamba2 (SSD, state-space duality) block.

The PyTorch counterpart of ``repro/models/ssm.py``.  Within a chunk of Q
tokens the token mixing is a masked, decay-weighted "attention" product
(``kernels.ops.ssd_chunk``: the hand-written CUDA kernel on the card, its
plain version on the CPU); across chunks a (heads, head_dim, d_state)
state is carried by a Python loop over the S / Q chunks (the reference's
``lax.scan``).  Per-token decode is the O(1) linear recurrence:

    S_t = exp(dt_t * a) * S_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . S_t + D * x_t

``jax.nn.softplus`` becomes ``F.softplus``, which returns x itself above
20; the exact value differs from x there by log1p(exp(-x)) < 2.1e-9, below
f32's resolution at 20 (1.9e-6), so the two agree to the bit in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import _init, rmsnorm


def _dims(d_model: int, cfg):
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    conv_dim = di + 2 * cfg.n_groups * cfg.d_state
    return di, nh, conv_dim


def _uniform(gen, n, lo, hi):
    u = torch.rand((n,), generator=gen, dtype=torch.float32,
                   device=gen.device)
    return lo + (hi - lo) * u


def ssm_init(gen, d_model: int, cfg, dtype=torch.float32, device="cpu"):
    """The reference's distributions: ``A_log = log U[1, 16]``, ``dt_bias``
    the inverse softplus of ``exp(U[log 1e-3, log 1e-1])`` (so that
    ``softplus(dt_bias)`` lies in [1e-3, 1e-1]), ``D = 1``, ``conv_w``
    at scale 0.2.  ``A_log``, ``dt_bias`` and ``D`` are f32 whatever
    ``dtype`` is."""
    di, nh, conv_dim = _dims(d_model, cfg)
    g, ds = cfg.n_groups, cfg.d_state
    d_in = 2 * di + 2 * g * ds + nh  # z, x, B, C, dt
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    dt0 = torch.exp(_uniform(gen, nh, math.log(1e-3), math.log(1e-1)))
    return {
        "in_proj": _init(gen, (d_model, d_in), **kw),
        "conv_w": _init(gen, (cfg.conv_width, conv_dim), scale=0.2, **kw),
        "conv_b": torch.zeros((conv_dim,), **kw),
        "A_log": torch.log(_uniform(gen, nh, 1.0, 16.0)).to(**f32),
        "dt_bias": (dt0 + torch.log(-torch.expm1(-dt0))).to(**f32),
        "D": torch.ones((nh,), **f32),
        "norm_scale": torch.ones((di,), **kw),
        "out_proj": _init(gen, (di, d_model), **kw),
    }


def _split_proj(zxbcdt, d_model, cfg):
    """(z, x, B, C, dt) views of the input projection's last dim."""
    di, nh, _ = _dims(d_model, cfg)
    gds = cfg.n_groups * cfg.d_state
    return torch.split(zxbcdt, [di, di, gds, gds, nh], dim=-1)


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv1d, xbc (B,S,ch), conv_w (w,ch): out[t] =
    sum_k conv_w[k] * xbc[t + k - (w-1)] (zeros before the start) + conv_b,
    written as w shifted multiply-adds in plain tensor ops -- not
    ``F.conv1d``, which on the card goes through cuDNN in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is off."""
    w, s = conv_w.shape[0], xbc.shape[1]
    wt = conv_w.to(xbc.dtype)
    xp = F.pad(xbc, (0, 0, w - 1, 0))
    out = xp[:, 0:s] * wt[0]
    for k in range(1, w):
        out = out + xp[:, k:k + s] * wt[k]
    return out + conv_b.to(xbc.dtype)


def ssm_forward(params, x, d_model: int, cfg, *, initial_state=None,
                return_state=False):
    """Full-sequence chunked SSD.  x (B,S,dm) -> y (B,S,dm) [+ cache].

    ``S % min(chunk_size, S) == 0``.  ``return_state`` adds the decode
    cache: ``conv``, the last ``conv_width - 1`` raw (pre-conv) xBC rows,
    left-padded with zeros when S is shorter, in x's dtype; ``state``, the
    final (B, NH, hp, ds) f32 state."""
    b, s, _ = x.shape
    di, nh, conv_dim = _dims(d_model, cfg)
    g, ds, hp = cfg.n_groups, cfg.d_state, cfg.head_dim
    q = min(cfg.chunk_size, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {q}")
    nc = s // q

    zxbcdt = x @ params["in_proj"]
    z, _, _, _, dt_raw = _split_proj(zxbcdt, d_model, cfg)
    xbc = zxbcdt[..., di:di + conv_dim]  # (x, B, C), contiguous in the proj
    conv_tail = xbc[:, max(s - (cfg.conv_width - 1), 0):, :]
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xs, bs, cs = torch.split(xbc, [di, g * ds, g * ds], dim=-1)

    xh = xs.reshape(b, nc, q, nh, hp)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (b,s,nh)
    dt = dt.reshape(b, nc, q, nh)
    a = -torch.exp(params["A_log"].float())  # (nh,) negative
    cum = torch.cumsum(dt * a, dim=2)  # inclusive cumsum within the chunk

    # ---- intra-chunk: kernel layout through transposed views ------------
    bg = bs.reshape(b, nc, q, g, ds).transpose(2, 3)
    cg = cs.reshape(b, nc, q, g, ds).transpose(2, 3)
    yk, st = ops.ssd_chunk(xh.transpose(2, 3), bg, cg, dt.transpose(2, 3),
                           cum.transpose(2, 3))
    y_intra = yk.transpose(2, 3)  # (b,nc,q,nh,hp)
    s_chunk = st.transpose(3, 4)  # (b,nc,nh,hp,ds)

    # ---- chunk states and the inter-chunk recurrence ---------------------
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b,nc,nh)
    state = (torch.zeros((b, nh, hp, ds), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    states_before = []
    for n in range(nc):
        states_before.append(state)
        state = state * chunk_decay[:, n, :, None, None] + s_chunk[:, n]
    states_before = torch.stack(states_before, dim=1)  # (b,nc,nh,hp,ds)

    chh = cs.reshape(b, nc, q, g, ds).repeat_interleave(nh // g, dim=3)
    y_inter = torch.einsum("bnqhs,bnhps->bnqhp",
                           chh.float() * torch.exp(cum)[..., None],
                           states_before).to(x.dtype)

    y = y_intra + y_inter + (params["D"].to(x.dtype)[None, None, None, :,
                                                      None] * xh)
    y = y.reshape(b, s, di)
    y = rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z))
    out = y @ params["out_proj"]
    if return_state:
        pad = cfg.conv_width - 1 - conv_tail.shape[1]
        if pad > 0:
            conv_tail = F.pad(conv_tail, (0, 0, pad, 0))
        return out, {"conv": conv_tail.to(x.dtype), "state": state}
    return out


def ssm_init_cache(batch: int, d_model: int, cfg, dtype=torch.bfloat16,
                   device="cpu"):
    """conv (B, conv_width - 1, conv_dim) in ``dtype``; state (B, NH, hp,
    ds) f32."""
    _, nh, conv_dim = _dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, cfg.head_dim, cfg.d_state),
                             dtype=torch.float32, device=device),
    }


def ssm_decode_step(params, cache, x_tok, d_model: int, cfg):
    """x_tok (B,1,dm) -> (y (B,1,dm), cache).  O(1) per token.  The cache's
    ``conv`` and ``state`` are written in place (the reference returns new
    arrays) and the same dict is returned."""
    b = x_tok.shape[0]
    di, nh, conv_dim = _dims(d_model, cfg)
    g, ds, hp = cfg.n_groups, cfg.d_state, cfg.head_dim

    zxbcdt = x_tok[:, 0, :] @ params["in_proj"]  # (B, d_in)
    z, _, _, _, dt_raw = _split_proj(zxbcdt, d_model, cfg)
    xbc = zxbcdt[:, di:di + conv_dim]  # (B, conv_dim)

    conv = cache["conv"]
    wdt = torch.promote_types(conv.dtype, xbc.dtype)  # as jnp.concatenate
    window = torch.cat([conv.to(wdt), xbc[:, None, :].to(wdt)], dim=1)
    conv_out = (window.float() * params["conv_w"].float()).sum(dim=1)
    conv_out = F.silu(conv_out + params["conv_b"].float()).to(x_tok.dtype)
    xs, bs, cs = torch.split(conv_out, [di, g * ds, g * ds], dim=-1)

    xh = xs.reshape(b, nh, hp).float()
    bh = bs.reshape(b, g, ds).repeat_interleave(nh // g, dim=1).float()
    chh = cs.reshape(b, g, ds).repeat_interleave(nh // g, dim=1).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B,nh)
    a = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt * a)  # (B,nh)

    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bhp,bhs->bhps", xh * dt[..., None], bh)
    y = torch.einsum("bhs,bhps->bhp", chh, state)  # (B,nh,hp)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(b, di).to(x_tok.dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z))
    out = (y @ params["out_proj"])[:, None, :]
    conv.copy_(window[:, 1:, :])
    cache["state"].copy_(state)
    return out, cache
