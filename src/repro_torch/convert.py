"""Carry weights, train states, dense caches and paged pools across from
the JAX package.

The caller turns each JAX leaf into numpy (``np.asarray``); this module
never imports jax.  Trees keep their structure: the stacked leading layer
axes (of a uniform or a grouped plan) and the head-explicit attention
weights (wq (dm,H,hd), wk/wv (dm,KV,hd), wo (H,hd,dm)) are already the
port's layout.
"""
from __future__ import annotations

import numpy as np
import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: go through f32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":  # ml_dtypes e4m3: its raw bytes
        t = torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(np.array(a))  # own, writable copy
    return t.to(device)


def params_from_jax(tree, device="cpu"):
    """JAX ``LM.init`` pytree of numpy arrays -> the port's params."""
    return _tree_map(lambda a: _to_torch(a, device), tree)


def train_state_from_jax(tree, device="cpu"):
    """JAX ``init_train_state`` tree as numpy ({"params", "opt": {"master",
    "mu", "nu", "step"}}) -> the port's train state, the step an int32
    scalar tensor."""
    out = _tree_map(lambda a: _to_torch(a, device), tree)
    out["opt"]["step"] = out["opt"]["step"].to(torch.int32).reshape(())
    return out


def train_state_to_numpy(state):
    """The port's train state -> numpy in the reference's structure (bf16
    leaves come back as f32)."""
    return cache_to_numpy(state)


def cache_from_jax(tree, device="cpu"):
    """JAX dense cache tree (any plan's: {"stack": {"k", "v"}} with
    (L,B,S,KV,D) leaves, or the grouped tree), as numpy -> the port's
    caches."""
    return _tree_map(lambda a: _to_torch(a, device), tree)


def cache_to_numpy(tree):
    """The port's caches -> numpy (bf16 leaves come back as f32, fp8
    leaves as their raw bytes, uint8)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.float8_e4m3fn:
            return t.view(torch.uint8).numpy()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return _tree_map(leaf, tree)


_POOL_KEYS = {"k", "v"}
_QUANT_POOL_KEYS = {"k", "v", "k_scale", "v_scale"}


def _check_pools(tree):
    """Every layer stack's pools in a converted plan tree (a dict of
    tensors): "k"/"v", or quantized int8/e4m3 values with their f32 scales
    (raw e4m3 bytes, uint8, are viewed as float8_e4m3fn in place)."""
    if not all(isinstance(v, torch.Tensor) for v in tree.values()):
        for v in tree.values():
            if not isinstance(v, dict):
                raise ValueError("a paged pool tree mixes pools and "
                                 "subtrees")
            _check_pools(v)
        return
    keys = set(tree)
    if keys not in (_POOL_KEYS, _QUANT_POOL_KEYS):
        raise ValueError(f"paged pools hold {sorted(keys)}: expected "
                         f"{sorted(_POOL_KEYS)} or {sorted(_QUANT_POOL_KEYS)}")
    if keys == _QUANT_POOL_KEYS:
        for name in ("k", "v"):
            leaf = tree[name]
            if leaf.dtype == torch.uint8:  # raw e4m3 bytes
                tree[name] = leaf.view(torch.float8_e4m3fn)
            elif leaf.dtype not in (torch.int8, torch.float8_e4m3fn):
                raise ValueError(f"quantized pool {name!r} is {leaf.dtype}, "
                                 f"not int8 or float8_e4m3fn")


def paged_cache_from_jax(tree, device="cpu"):
    """JAX paged pools in any plan tree ({"stack": {"k", "v"}}, or the
    grouped {"groups": {"inner", "outer"}, "rem"}; (..., P, page_size, KV,
    D) leaves, as numpy; the page axis stays where the reference keeps it)
    -> the port's pools.  Quantized pools come with f32 scale leaves
    "k_scale"/"v_scale" (..., P, page_size, KV, 1); their int8 values cross
    as int8 and their fp8 (e4m3) values as ml_dtypes arrays or as the raw
    bytes (uint8), which numpy holds without e4m3 support."""
    out = cache_from_jax(tree, device)
    _check_pools(out)
    return out


def paged_cache_to_numpy(tree):
    """The port's paged pools -> numpy, (..., P, page_size, KV, D) leaves as
    the reference lays them out (bf16 leaves come back as f32, fp8 pools
    as their raw bytes, uint8)."""
    return cache_to_numpy(tree)
