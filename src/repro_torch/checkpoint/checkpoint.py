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
``meta.json``'s ``dtypes`` names it.

Elastic restore: arrays are stored whole, so ``restore`` against the
shardings of the current mesh (spec trees of ``sharding.rules``, with the
mesh) keeps each rank's block of every leaf, whatever mesh saved it (a
host failure -> a smaller gang; see ``runtime/fault.py``).  A sharded
``Trainer`` gathers its state whole before rank 0 writes it.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import zipfile

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


def _from_numpy(arr, raw=None, copy=True):
    """A tensor of ``arr``: its own writable copy, or (``copy=False``,
    for a caller that copies a block of it) a view where ``arr`` is
    writable."""
    arr = np.array(arr) if copy or not arr.flags.writeable else arr
    if raw == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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


def _mapped_npz(path: str) -> dict:
    """{key: array} of an ``np.savez`` file, each array a copy-on-write
    memory map of its member's bytes: nothing is read (or checked
    against its CRC) until a block of it is used.  ``np.savez`` stores
    members uncompressed; a compressed one is read whole."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            key = info.filename[:-len(".npy")]
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as member:
                    out[key] = np.lib.format.read_array(member)
                continue
            f.seek(info.header_offset + 26)  # the local header's lengths
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            major, _ = np.lib.format.read_magic(f)
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(f) if major == 1
                else np.lib.format.read_array_header_2_0(f))
            out[key] = np.memmap(path, dtype=dtype, mode="c",
                                 offset=f.tell(), shape=shape,
                                 order="F" if fortran else "C")
    return out


def load_checkpoint(ckpt_dir: str, step: int | None = None,
                    mapped: bool = False):
    """Returns (flat dict key -> numpy array, meta); a bf16 leaf comes as
    its raw bits (uint16), named in ``meta["dtypes"]``.  ``mapped``: each
    array a memory map of the file (``_mapped_npz``), for a caller that
    reads blocks of them."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    path = os.path.join(d, "arrays.npz")
    if mapped:
        return _mapped_npz(path), meta
    npz = np.load(path)
    return {k: npz[k] for k in npz.files}, meta


def restore(ckpt_dir: str, target, shardings=None, device=None,
            step: int | None = None, *, mesh=None):
    """Restore into the structure of ``target`` (a tree of tensors, on the
    meta device for shapes only), each leaf cast to the target leaf's
    dtype and placed on ``device`` (default: the target leaf's).  A key
    the checkpoint lacks, or a shape that differs, raises.  Returns
    (state, meta).

    ``shardings`` (a spec tree like ``target``, from ``sharding.rules``)
    with ``mesh`` (this rank's ``DeviceMesh``) keeps only the rank's block
    of each leaf: the reference's elastic restore, the mesh free to differ
    from the one that saved.  The block is a slice of the stored array, so
    it holds the saved bits; the arrays are memory-mapped, so a rank reads
    only its blocks."""
    from ..sharding.rules import mesh_coord, mesh_sizes, shard_block

    if (shardings is None) != (mesh is None):
        raise ValueError("restore(shardings=...) needs the mesh they cut "
                         "over (mesh=...), and mesh= needs shardings")
    flat, meta = load_checkpoint(ckpt_dir, step, mapped=mesh is not None)
    raw = meta.get("dtypes", {})
    cut = (None if mesh is None
           else (mesh_sizes(mesh), mesh_coord(mesh)))

    def build(tree, spec, prefix):
        if isinstance(tree, dict):
            return {k: build(v, None if spec is None else spec[k],
                             prefix + (str(k),)) for k, v in tree.items()}
        key = "/".join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(tree.shape)}")
        out = _from_numpy(arr, raw.get(key), copy=cut is None)
        if cut is not None:
            out = shard_block(out, spec, *cut).clone()
        return out.to(device=device or tree.device, dtype=tree.dtype)

    return build(target, shardings, ()), meta


def prune_checkpoints(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
