"""The work of each kernel: flops by rate class and HBM bytes, from its
shapes and, where the work depends on the data, the positions it runs at.

One cost function a kernel, shared by every place that reads a kernel's
work: the wrappers' meta branch in ``ops.py`` (the dry run counts a
kernel's work there, ``launch/roofline.py``), and the least-time bound
``chip_smoke.py`` prints beside each kernel's time on the card.  So a
kernel's cost reads the same whatever implements it.

Rate classes are keys of ``core.h100.RATES``: the decode kernels (#1-#3,
#5) multiply on the CUDA cores ("f32") but at the groupings their route
puts on the tensor cores (``decode_rate``); the many-row kernels (#4, #6),
the SSD chunk (#7) and those decode rows on the wgmma route, bf16
operands at the bf16 rate, f32 operands as three TF32 products
("tf32x3") and a quantized (1-byte) pool against f32 as two ("tf32x2");
the decode rows on the warp-mma route as its TF32 products
(``mma_class``).
Bytes count each input read once and each output written once.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core import h100
from .decode_attention import decode_route

__all__ = ["Work", "decode_rate", "decode_work", "flash_work", "mma_class",
           "prefill_work", "record", "recording", "ssd_work", "tc_class"]


@dataclasses.dataclass
class Work:
    """``flops``: {rate class: flops}; ``bytes_read``, ``bytes_written``:
    HBM bytes."""

    flops: dict
    bytes_read: float
    bytes_written: float

    @property
    def nbytes(self) -> float:
        return self.bytes_read + self.bytes_written

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def bound(self):
        """(least ms on an H100 SXM, "bytes" or "operations", the rate
        used): the larger of the bytes over the HBM rate and the flops of
        each class over its rate."""
        t_bytes = self.nbytes / h100.HBM_BYTES_PER_S * 1e3
        t_ops = sum(f / h100.RATES[c] for c, f in self.flops.items()) * 1e3
        rate = " and ".join(h100.RATE_NAMES[c] for c in sorted(self.flops)
                            if self.flops[c])
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations", rate)


# ------------------------------------------------------------- recording
_RECORDERS: list = []


@contextlib.contextmanager
def recording(fn):
    """Calls ``fn(name, work)`` for every kernel call on the meta device
    inside the block (``record``)."""
    _RECORDERS.append(fn)
    try:
        yield fn
    finally:
        _RECORDERS.remove(fn)


def record(name: str, work: Work) -> None:
    """Hand one kernel call's work to the active recorders (none: no-op)."""
    for fn in list(_RECORDERS):
        fn(name, work)


# ------------------------------------------------------------ rate class
def tc_class(q, k) -> str:
    """The tensor-core class of the many-row kernels' products for q's and
    k's dtypes (tensors, or anything with ``dtype`` and ``element_size``):
    bf16 operands at the bf16 rate, a 1-byte pool at 2xTF32, f32 at
    3xTF32."""
    if q.dtype == k.dtype == torch.bfloat16:
        return "bf16"
    return "tf32x2" if k.element_size() == 1 else "tf32x3"


def mma_class(q, k) -> str:
    """The class of the warp-mma decode route's TF32 products
    (``csrc/chunked_decode_mma.cuh``, both its plans: D over the warps at
    head dim 128, the keys over the warps at 64): an f32 pool at 3xTF32;
    a bf16 pool, exact in TF32, at 2xTF32 against an f32 q (the scores'
    two products, P V's one counted at their rate) and at the TF32 rate
    against a bf16 q."""
    if k.dtype == torch.float32:
        return "tf32x3"
    return "tf32" if q.dtype == torch.bfloat16 else "tf32x2"


def decode_rate(q, k) -> str:
    """The rate class of the chunked decode kernel's products for q (B, T,
    H, D) against a cache or pool ``k`` (KV heads at dim 2): "f32" on the
    CUDA-core route, ``tc_class`` on the tensor-core route, ``mma_class``
    on the warp-mma route (``decode_attention.decode_route``: by grouping,
    head dim and pool dtype; head dim 64 on f32 and bf16 pools at every
    grouping)."""
    route = decode_route(q.shape[2] // k.shape[2], q.shape[3], k.dtype)
    if route == "tensor_cores":
        return tc_class(q, k)
    return mma_class(q, k) if route == "warp_mma" else "f32"


def _positions(pos, b: int, s: int):
    """The slots' positions as a list: ``pos`` (host numbers), or every
    slot at the cache's last row where they are not known (a tensor on
    the meta device: the dry run's decode against a full cache)."""
    if pos is None:
        return [s - 1] * b
    vals = np.asarray(pos).reshape(-1).tolist()
    return vals * b if len(vals) == 1 else vals


# ----------------------------------------------------------------- kernels
def decode_work(b: int, t: int, h: int, d: int, kv: int, s: int,
                q_bytes: int, kv_bytes: int, pos=None, *, page_size: int = 0,
                scales: bool = False, rate: str = "f32") -> Work:
    """#1/#2 (dense), #3/#5 (``page_size``: paged), #3q/#5q (``scales``):
    the live K/V prefix of the active slots read once (keys up to pos + T
    - 1 for a T-row q; paged: and the page-table entries that map it; a
    quantized pool: and its f32 scale per key and KV head), q and pos read
    and the output written once; QK + PV, 4 D flops a (row, key) pair
    (row t sees pos + t + 1 keys), at ``rate`` (``decode_rate``: the CUDA
    cores' "f32", or the tensor-core route's class).  Split-K does the
    same work."""
    active = [p for p in _positions(pos, b, s) if p >= 0]
    live = sum(min(p + t, s) for p in active)
    kv_read = 2 * live * kv * (d * kv_bytes + (4 if scales else 0))
    q_read = b * t * h * d * q_bytes + 4 * b
    if page_size:
        q_read += 4 * sum(-(-min(p + t, s) // page_size) for p in active)
    pairs = sum(min(p + i + 1, s) for p in active for i in range(t))
    return Work({rate: 4 * pairs * h * d}, kv_read + q_read,
                b * t * h * d * q_bytes)


def prefill_work(c: int, h: int, d: int, kv: int, q_offset: int,
                 q_bytes: int, kv_bytes: int, page_size: int, rate: str,
                 *, scales: bool = False) -> Work:
    """#4 (and #4q with ``scales``): one slot's C-row chunk at
    ``q_offset`` against its live prefix [0, q_offset + C): causal QK + PV
    at ``rate`` (``tc_class``); the prefix's K/V (and scales) and its
    page-table entries read once, q read and the output written once."""
    keys = c * q_offset + c * (c + 1) // 2
    kv_read = 2 * (q_offset + c) * kv * (d * kv_bytes + (4 if scales else 0))
    io = c * h * d * q_bytes
    return Work({rate: 4 * h * d * keys},
                kv_read + io + 4 * -(-(q_offset + c) // page_size), io)


def attended_pairs(s: int, causal: bool, window: int) -> int:
    """(row, key) pairs of an S x S attention that the mask keeps: key j
    for row i when j <= i (``causal``) and i - j < ``window`` (> 0)."""
    i = np.arange(s, dtype=np.int64)
    hi = i + 1 if causal else np.full(s, s, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_work(b: int, s: int, h: int, d: int, kv: int, q_bytes: int,
               kv_bytes: int, rate: str, *, causal: bool = True,
               window: int = 0) -> Work:
    """#6: QK + PV, 4 D flops per attended (row, key) pair at ``rate``;
    q, K and V read once and the output written once."""
    pairs = b * h * attended_pairs(s, causal, window)
    q_io = b * s * h * d * q_bytes
    return Work({rate: 4 * d * pairs}, q_io + 2 * b * s * kv * d * kv_bytes,
                q_io)


def ssd_work(bb: int, nc: int, nh: int, q: int, hp: int, g: int, ds: int,
             x_bytes: int, *, cuda_cores: bool = False) -> Work:
    """#7: products over the lower triangle (the pairs i >= j a chunk
    needs): C.B^T 2 ds flops a pair per (chunk, group), att @ x 2 hp a pair
    per (chunk, head), the state 2 Q ds hp per (chunk, head).  f32 inputs
    at the 3xTF32 rate; bf16 inputs C.B^T and att @ x at the bf16 rate and
    the state (f32 B * w against bf16 x) at 2xTF32; ``cuda_cores``: all on
    the CUDA cores (the bound of a design without the tensor cores).  x,
    B, C, dt and cum read once, y and the f32 state written once."""
    pairs = q * (q + 1) // 2
    cb = bb * nc * g * 2 * ds * pairs
    att_x = bb * nc * nh * 2 * hp * pairs
    state = bb * nc * nh * 2 * q * ds * hp
    if cuda_cores:
        flops = {"f32": cb + att_x + state}
    elif x_bytes == 4:
        flops = {"tf32x3": cb + att_x + state}
    else:
        flops = {"bf16": cb + att_x, "tf32x2": state}
    x_io = bb * nc * nh * q * hp * x_bytes
    read = (x_io + 2 * bb * nc * g * q * ds * x_bytes
            + 2 * bb * nc * nh * q * 4)
    return Work(flops, read, x_io + bb * nc * nh * ds * hp * 4)
