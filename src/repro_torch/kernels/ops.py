"""Model-layout dispatch of the decode kernels (the counterpart of
``repro/kernels/ops.py``).

The device decides the path: tensors on the CPU take the plain versions in
``ref.py`` (through transposed views, no copies); CUDA tensors launch the
hand-written kernels, or the call raises.  There is no fallback.
"""
from __future__ import annotations

from . import ref
from .decode_attention import (decode_attention_cuda,
                               decode_attention_splitk_cuda)


def _split(q, num_splits):
    """Split-K only for one-token decode; T > 1 always runs single pass,
    as in the reference."""
    return num_splits > 1 and q.shape[1] == 1


def decode_attention_plain(q, k_cache, v_cache, pos, *, active=None,
                           window=0, num_splits=1):
    """The plain versions in model layout, on any device (the CPU path of
    ``decode_attention``; the on-card checks compare the kernels with it).
    """
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k_cache, v_cache))
    if _split(q, num_splits):
        out = ref.decode_attention_splitk_ref(
            qt, kt, vt, pos, active=active, window=window,
            num_splits=num_splits)
    else:
        out = ref.decode_attention_ref(qt, kt, vt, pos, active=active,
                                       window=window)
    return out.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, pos, *, active=None, window=0,
                     num_splits=1):
    """Model layout: q (B,T,H,D); caches (B,S,KV,D) -> (B,T,H,D).

    ``pos`` scalar or (B,); ``active`` (B,) 0/1 (default ``pos >= 0``).
    ``num_splits > 1`` with T = 1 takes the two-phase split-K path; T > 1
    always takes the single-pass kernel, as in the reference.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos,
                                      active=active, window=window,
                                      num_splits=num_splits)
    if _split(q, num_splits):
        return decode_attention_splitk_cuda(q, k_cache, v_cache, pos,
                                            active=active, window=window,
                                            num_splits=num_splits)
    return decode_attention_cuda(q, k_cache, v_cache, pos, active=active,
                                 window=window)
