"""Carry weights, dense caches and paged pools across from the JAX
package.

The caller turns each JAX leaf into numpy (``np.asarray``); this module
never imports jax.  Trees keep their structure: the stacked leading layer
axis and the head-explicit attention weights (wq (dm,H,hd), wk/wv
(dm,KV,hd), wo (H,hd,dm)) are already the port's layout.
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
    else:
        t = torch.from_numpy(np.array(a))  # own, writable copy
    return t.to(device)


def params_from_jax(tree, device="cpu"):
    """JAX ``LM.init`` pytree of numpy arrays -> the port's params."""
    return _tree_map(lambda a: _to_torch(a, device), tree)


def cache_from_jax(tree, device="cpu"):
    """JAX dense cache tree ({"stack": {"k", "v"}}, (L,B,S,KV,D) leaves,
    as numpy) -> the port's caches."""
    return _tree_map(lambda a: _to_torch(a, device), tree)


def cache_to_numpy(tree):
    """The port's caches -> numpy (bf16 leaves come back as f32)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return _tree_map(leaf, tree)


def paged_cache_from_jax(tree, device="cpu"):
    """JAX paged pools ({"stack": {"k", "v"}}, (L, P, page_size, KV, D)
    leaves, as numpy; the page axis stays where the reference keeps it) ->
    the port's pools.  Quantized pools (scale leaves) are not ported."""
    if "k_scale" in tree.get("stack", {}):
        raise NotImplementedError("quantized (int8/fp8) paged pools are not "
                                  "ported yet (see ROADMAP.md)")
    return cache_from_jax(tree, device)


def paged_cache_to_numpy(tree):
    """The port's paged pools -> numpy, (L, P, page_size, KV, D) leaves as
    the reference lays them out (bf16 leaves come back as f32)."""
    return cache_to_numpy(tree)
