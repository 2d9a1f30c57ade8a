"""The many-row attention kernel's row plan, as the wrapper computes it.

``csrc/many_row_attention.cuh`` flattens the query rows of one (batch row,
KV head) into (position, group head) pairs, position-major, and gives each
CTA ``ROWS`` consecutive ones whatever G is; its key range runs from its
first row's window start, rounded down to a tile, to its last row's
position.  ``flash_attention.row_plan`` states that plan in Python and
``launch_many_row`` sizes the launch from it (``many_row_ctas``).  Here,
for G in {1, 2, 4, 5, 16, 48, 64} and Sq in {1, 17, 256, 4096}: every
(batch row, position, head) lies in exactly one CTA, each CTA's keys cover
every key its rows see (causal or not, windows 0, 64 and 1024, offsets 0
and 3840), idle rows sit only in the last CTA of a (batch row, KV head),
and the launch counts the CTAs the plan has.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ROWS, TILE_KEYS, many_row_ctas, row_blocks, row_plan)

GS = (1, 2, 4, 5, 16, 48, 64)
SQS = (1, 17, 256, 4096)
# (causal, window, q_offset): the paged prefill's chunks are causal at an
# offset; the flash attention runs from position 0, causal or not
RANGES = [(True, w, off) for w in (0, 64, 1024) for off in (0, 3840)] + \
    [(False, w, 0) for w in (0, 64, 1024)]
B, KV = 2, 2


@pytest.mark.parametrize("sq", SQS)
@pytest.mark.parametrize("g", GS)
def test_every_row_lies_in_exactly_one_cta(g, sq):
    plan = row_plan(sq, g, sq)
    assert len(plan) == row_blocks(sq, g)
    seen = np.zeros((B, sq, KV * g), dtype=np.int64)
    # the grid is (KV, row blocks, B): each (batch row, KV head) its blocks
    for b in range(B):
        for j in range(KV):
            for r0, r1, _, _ in plan:
                r = np.arange(r0, r1)
                np.add.at(seen, (b, r // g, j * g + r % g), 1)
    assert (seen == 1).all()
    assert plan[0][0] == 0 and plan[-1][1] == sq * g
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))


@pytest.mark.parametrize("causal,window,q_offset", RANGES)
@pytest.mark.parametrize("sq", SQS)
@pytest.mark.parametrize("g", GS)
def test_cta_keys_cover_every_visible_key(g, sq, causal, window, q_offset):
    sk = q_offset + sq
    plan = row_plan(sq, g, sk, q_offset=q_offset, causal=causal,
                    window=window)
    n = sq * g
    blk = np.arange(n) // ROWS
    kbeg = np.array([p[2] for p in plan])[blk]
    hi = np.array([p[3] for p in plan])[blk]
    qpos = q_offset + np.arange(n) // g
    first = np.maximum(0, qpos - window + 1) if window else np.zeros(n, int)
    last = qpos if causal else np.full(n, sk - 1)  # visible: [first, last]
    assert (first <= last).all()  # every row sees a key
    assert (kbeg <= first).all() and (hi > last).all() and (hi <= sk).all()
    for r0, r1, kb, h in plan:  # and no more than the rows need
        assert kb % TILE_KEYS == 0
        assert kb == first[r0] // TILE_KEYS * TILE_KEYS
        assert h == last[r1 - 1] + 1


@pytest.mark.parametrize("sq", SQS)
@pytest.mark.parametrize("g", GS)
def test_idle_rows_only_in_the_last_cta(g, sq):
    plan = row_plan(sq, g, sq)
    full = [r1 - r0 == ROWS for r0, r1, _, _ in plan]
    assert all(full[:-1])
    assert full[-1] == (sq * g % ROWS == 0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq", SQS)
@pytest.mark.parametrize("g", GS)
def test_launch_counts_the_planned_ctas(g, sq, d, monkeypatch):
    """``launch_many_row`` splits the key range over the CTAs the plan
    has, at every head dim: B x KV x row blocks."""
    seen = []

    def splits(ctas, keys, sms):
        seen.append((ctas, keys, sms))
        return 1

    monkeypatch.setattr(tflash, "num_splits", splits)
    monkeypatch.setattr(tflash, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    launched = []

    def fn(*args):
        launched.append(args)
        return 0

    out = torch.empty((B, sq, KV * g, d))
    tflash.launch_many_row(fn, out, KV, sq, ("args",), ("tail",))
    ctas = B * KV * len(row_plan(sq, g, sq))
    assert seen == [(ctas, sq, 132)]
    assert ctas == many_row_ctas(B, sq, KV * g, KV)
    assert launched == [("args", 1, 0, 0, 0, "tail", 0)]
