"""Atomic checkpoint save and restore, in the reference's on-disk layout.

The PyTorch counterpart of ``repro/checkpoint/checkpoint.py``.

Layout:  <dir>/step_<n>/  arrays.npz  +  meta.json
Atomicity: write into ``<dir>/.tmp_step_<n>`` then ``os.replace``, so a
crash mid-write never corrupts the latest checkpoint (restart from a
checkpoint must always succeed).

Each leaf is stored under the key ``jax.tree_util.tree_flatten_with_path``
gives it in the reference (dict keys joined by ``/``, e.g.
``opt/master/blocks/stack/attn/wq``), as a numpy array, so an f32
checkpoint that either package writes restores in the other.  numpy has no
bfloat16: a bf16 leaf is stored as its raw 16 bits (uint16) and
``meta.json``'s ``dtypes`` names it.  ``restore`` places each array on one
device; restoring against a mesh (resharding) is not ported.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _flatten(tree, prefix=()):
    """{key: leaf} in sorted-key order, keys as the reference builds them."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _to_numpy(t):
    """(numpy array, dtype name if stored as raw bits else None)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _from_numpy(arr, raw=None):
    if raw == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # own, writable copy


def save_checkpoint(ckpt_dir: str, step: int, state, extra: dict | None = None):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, raw = {}, {}
    for key, leaf in _flatten(state).items():
        arrays[key], name = _to_numpy(leaf)
        if name is not None:
            raw[key] = name
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "keys": sorted(arrays), "extra": extra or {},
            "dtypes": raw}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int | None = None):
    """Returns (flat dict key -> numpy array, meta); a bf16 leaf comes as
    its raw bits (uint16), named in ``meta["dtypes"]``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(d, "arrays.npz"))
    return {k: npz[k] for k in npz.files}, meta


def restore(ckpt_dir: str, target, device=None, step: int | None = None):
    """Restore into the structure of ``target`` (a tree of tensors, on the
    meta device for shapes only), each leaf cast to the target leaf's
    dtype and placed on ``device`` (default: the target leaf's).  A key
    the checkpoint lacks, or a shape that differs, raises.  Returns
    (state, meta)."""
    flat, meta = load_checkpoint(ckpt_dir, step)
    raw = meta.get("dtypes", {})

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        key = "/".join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(tree.shape)}")
        return _from_numpy(arr, raw.get(key)).to(
            device=device or tree.device, dtype=tree.dtype)

    return build(target, ()), meta


def prune_checkpoints(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
