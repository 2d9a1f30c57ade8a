"""The chunked decode kernel's head-dim-64 plan, modelled on the CPU.

``decode_attention.decode_route`` sends head dim 64 (musicgen, G = 1) on
f32 and bf16 pools to ``csrc/chunked_decode_mma.cuh``'s
``mma64_decode_kernel`` at every grouping: the chunk grid, the page table
read first and the cp.async ring of the warp-mma route, ``mma.sync``
m16n8k8 in TF32 with 16 keys on M and the rows on N in blocks of 8
columns, but each of the four warps over its own keys of a tile (16 in
f32, 32 in bf16: tiles of 64 and 128 keys) across all 64 d.  A warp's S^T
is its own 8 k-steps; its own online softmax over its keys (each lane's l
over its keys 2t, 2t + 8, 2t + 1, 2t + 9 of each 16-key m-tile, the quad's
parts summed (t 0 + 1) + (2 + 3) at the chunk's end); p rounded to v's
dtype; O^T = V^T P^T in fresh registers added to O; f32 operands in 3xTF32
with the big part truncated.  At the chunk's end the warps' (acc, m, l)
merge in warp order, then the chunks' in chunk order in a second kernel.

Here: that arithmetic emulated on the chunk grid (``emulate_d64``) and held
to the JAX package's oracles within TOL 5e-5 on f32 caches and pools,
dense and paged, windows 0 and 100, 1 and 2 splits, at T = 1 and musicgen's
T = 9 verify block, with one truncated TF32 product missing it; bf16 pools
against the plain version; the bitwise claims (a verify row t and the
T = 1 launch at pos + t, a row in any instance or row tile, split-K at
whole chunks and the single pass); the route's row plan at head dim 64;
and the ring's swizzle and the warps' exchange, whose fragment reads meet
no bank conflict.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MMA64_ROWS, MMA_COLS, decode_chunks, decode_route, row_tiles)
from test_torch_decode_mma import (  # noqa: E402
    _dense_oracle, _mma_sum, _worst_conflict)
from test_torch_row_tiles import _oracle  # noqa: E402

TOL = 5e-5  # chip_smoke.py TOL[torch.float32]
B, D, S, PAGE = 3, 64, 768, 8  # three 256-key chunks per slot
L = tdecode.CHUNK_KEYS
WARPS = 4  # each warp over its own keys of a tile, merged in warp order
NEG_INF = -1e30
T9 = 9  # musicgen's verify block (draft_k = 8)
# (KV, G, T, positions, window, num_splits): musicgen's one token and its
# verify block (16 columns, 9 live), windows that start a chunk part way,
# split-K, and a grouping past one 16-column tile
CASES = {
    "t1": (2, 1, 1, [-1, L, S - 1], 0, 1),
    "t1_window": (2, 1, 1, [L - 3, 400, S - 1], 100, 1),
    "t9": (2, 1, T9, [L - 1, 2 * L - 5, S - T9], 0, 1),
    "t9_window": (2, 1, T9, [L - 3, 500, S - T9], 100, 1),
    "splits2": (2, 1, 1, [L - 1, 500, S - 1], 0, 2),
    "splits2_window": (2, 1, 1, [L, 600, S - 1], 100, 2),
    "g4_t5": (1, 4, 5, [3, 2 * L - 4, S - 5], 0, 1),
}
VERIFY = [c for c in CASES if CASES[c][2] > 1]


def _inputs(kv, g, t, seed=0, dtype=torch.float32):
    """q (B, t, KV * G, D), pools (P, PAGE, KV, D) of ``dtype`` and a
    shuffled (B, S / PAGE) table over every page but the null page 0."""
    max_pages = S // PAGE
    rng = np.random.default_rng(seed)
    table = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
    q = rng.normal(size=(B, t, kv * g, D)).astype(np.float32)
    k, v = (torch.from_numpy(rng.normal(
        size=(B * max_pages + 1, PAGE, kv, D)).astype(np.float32)).to(dtype)
        for _ in (0, 1))
    return (torch.from_numpy(q), k, v,
            torch.from_numpy(table.astype(np.int32)))


def _warp_keys(k_dtype):
    """Keys a warp takes of a tile: 16 KiB of K a ring stage."""
    return 64 // torch.empty((), dtype=k_dtype).element_size()


def _lane_sum(pr, mt_tiles):
    """Each lane's part of a row's l over a warp's keys of one tile: lane
    tq sums its keys 16 mt + (2 tq, 2 tq + 8, 2 tq + 1, 2 tq + 9) in that
    order, m-tile by m-tile; (4, cols)."""
    parts = []
    for tq in range(4):
        acc = torch.zeros(pr.shape[0])
        for mt in range(mt_tiles):
            for k in (2 * tq, 2 * tq + 8, 2 * tq + 1, 2 * tq + 9):
                acc = acc + pr[:, 16 * mt + k]
        parts.append(acc)
    return torch.stack(parts)


def _chunk(qt, kd, vd, lo, hi, cx, wlo, whi, products, p_dtype):
    """One CTA's chunk: keys [lo, hi) in tiles on the chunk's grid, each
    warp's online softmax over its keys, then the warps' merge in warp
    order; returns the chunk's (acc, m, l) of the tile's columns."""
    cols, d = qt.shape
    kw = _warp_keys(kd.dtype)
    tk = WARPS * kw
    m = torch.full((WARPS, cols), NEG_INF)
    l = torch.zeros(WARPS, 4, cols)
    o = torch.zeros(WARPS, cols, d)
    for k0 in range(cx + (lo - cx) // tk * tk, hi, tk):
        for w in range(WARPS):
            kpos = torch.arange(k0 + kw * w, k0 + kw * (w + 1))
            inside = (kpos >= lo) & (kpos < hi)
            kt = torch.zeros(kw, d)
            vt = torch.zeros(kw, d)
            kt[inside] = kd[kpos[inside]].float()
            vt[inside] = vd[kpos[inside]].float()
            sc = _mma_sum(qt[:, None], kt[None], -1, products)
            seen = (kpos >= wlo[:, None]) & (kpos <= whi[:, None])
            x = torch.where(seen, sc * d ** -0.5, NEG_INF)
            m_new = torch.maximum(m[w], x.amax(dim=1))
            alpha = torch.exp(m[w] - m_new)
            pr = torch.where(seen, torch.exp(x - m_new[:, None]), 0.0)
            l[w] = l[w] * alpha + _lane_sum(pr, kw // 16)
            m[w] = m_new
            pr = pr.to(p_dtype).float()
            o[w] = o[w] * alpha[:, None] + _mma_sum(pr[:, :, None], vt[None],
                                                    1, products)
    ls_w = (l[:, 0] + l[:, 1]) + (l[:, 2] + l[:, 3])
    ms = torch.full((cols,), NEG_INF)
    for w in range(WARPS):
        ms = torch.maximum(ms, m[w])
    acc, ls = torch.zeros(cols, d), torch.zeros(cols)
    for w in range(WARPS):
        e = torch.exp(m[w] - ms)
        acc = acc + o[w] * e[:, None]
        ls = ls + ls_w[w] * e
    return acc, ms, ls


def emulate_d64(q, k_pages, v_pages, page_idx, pos, *, window=0,
                num_splits=1, tile_rows=None, active=None, products=3):
    """The plan's launch: per (slot, KV head, row tile of ``tile_rows``
    rows, default ``row_tiles``' plan, padded to blocks of 8 columns that
    see no key), per working chunk of ``decode_chunks``, ``_chunk``; a
    slot with one working chunk writes its rows there, otherwise the
    chunks' (acc, m, l) merge in chunk order.  Row r of KV head j is head
    j G + r // T at position pos + r % T."""
    b, t, h, d = q.shape
    _, page_size, kv, _ = k_pages.shape
    g, rows = h // kv, h // kv * t
    if tile_rows is None:
        tile_rows = row_tiles(g, t, D, "warp_mma")[0]
    _, _, ranges = decode_chunks(page_idx.shape[1], page_size, num_splits)
    kd, vd = (x[page_idx.long()].flatten(1, 2) for x in (k_pages, v_pages))
    out = torch.full((b, t, h, d), float("nan"))
    for s in range(b):
        p = int(pos[s])
        live = p >= 0 if active is None else bool(active[s])
        lo_b = max(0, p - window + 1) if window else 0
        hi_b = min(kd.shape[1], p + t) if live else 0
        work = [z for z, (lo, hi) in enumerate(ranges)
                if max(lo, lo_b) < min(hi, hi_b)]
        for j in range(kv):
            qj = q[s, :, j * g:(j + 1) * g].transpose(0, 1).reshape(rows, d)
            for r0 in range(0, rows, tile_rows):
                rt = min(tile_rows, rows - r0)
                cols = -(-rt // MMA_COLS) * MMA_COLS
                r = torch.arange(r0, r0 + rt)
                if not work:
                    out[s, r % t, j * g + r // t] = 0.0
                    continue
                qt = torch.zeros(cols, d)
                qt[:rt] = qj[r]
                qpos = p + (r0 + torch.arange(cols)) % t
                wlo = qpos - window + 1 if window else torch.zeros_like(qpos)
                parts = []
                for z in work:
                    cx, cy = ranges[z]
                    lo, hi = max(cx, lo_b), min(cy, hi_b)
                    whi = torch.where(torch.arange(cols) < rt,
                                      torch.clamp(qpos, max=hi - 1), -1)
                    o, m, l = _chunk(qt, kd[s, :, j], vd[s, :, j], lo, hi,
                                     cx, wlo, whi, products, v_pages.dtype)
                    parts.append((o[:rt], m[:rt], l[:rt]))
                if len(work) == 1:
                    o, _, l = parts[0]
                    res = o / torch.clamp(l, min=1e-30)[:, None]
                else:
                    m_star = torch.stack([m for _, m, _ in parts]).amax(0)
                    num, den = torch.zeros(rt, d), torch.zeros(rt)
                    for o, m, l in parts:
                        e = torch.exp(m - m_star)
                        num = num + o * e[:, None]
                        den = den + l * e
                    res = num / torch.clamp(den, min=1e-30)[:, None]
                out[s, r % t, j * g + r // t] = res
    return out


def _dense(q, k_pages, v_pages, table):
    """The same keys as a dense cache (B, S, KV, D) and the identity table
    over its one-token pages, the kernel's dense mode."""
    kd, vd = (x[table.long()].flatten(1, 2) for x in (k_pages, v_pages))
    ident = torch.arange(B * S, dtype=torch.int32).reshape(B, S)
    return kd, vd, ident, [x.reshape(B * S, 1, *x.shape[2:])
                           for x in (kd, vd)]


# ------------------------------------------------------- the arithmetic
@pytest.mark.parametrize("case", list(CASES))
def test_paged_model_matches_jax_oracle(case):
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    got = emulate_d64(q, k, v, table, pos, window=window, num_splits=ns)
    np.testing.assert_allclose(got.numpy(),
                               _oracle(q, k, v, table, pos, window),
                               atol=TOL, rtol=TOL)
    for s, p in enumerate(pos):
        if p < 0:
            assert float(got[s].abs().max()) == 0.0  # a parked slot


@pytest.mark.parametrize("case", ["t1", "t9_window", "splits2_window"])
def test_dense_model_matches_jax_oracle(case):
    """The dense mode: the slot's stripe as one-token pages through an
    identity table, on the same chunk grid (``decode_chunks(S, 1, ns)``),
    against the JAX dense oracle."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    kd, vd, ident, pages = _dense(q, k, v, table)
    got = emulate_d64(q, *pages, ident, pos, window=window, num_splits=ns)
    np.testing.assert_allclose(got.numpy(),
                               _dense_oracle(q, kd, vd, pos, window),
                               atol=TOL, rtol=TOL)


def test_one_truncated_product_misses_the_tolerance():
    """The split is needed: big.big alone, both operands truncated to
    TF32, lands outside TOL of the oracle on the same inputs."""
    kv, g, t, pos, window, ns = CASES["t9"]
    q, k, v, table = _inputs(kv, g, t)
    got = emulate_d64(q, k, v, table, pos, window=window, products=1)
    want = _oracle(q, k, v, table, pos, window)
    assert np.abs(got.numpy() - want).max() > TOL


@pytest.mark.parametrize("case", ["t1", "t9_window", "splits2"])
def test_model_on_bf16_pools_matches_the_plain_version(case):
    """bf16 pools (128-key tiles, two m-tiles a warp): K and V exact in
    TF32, p rounded to bf16 before P V, as the plain version (the card's
    yardstick) does; the tolerance is chip_smoke.py's for bf16 pools."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t, dtype=torch.bfloat16)
    got = emulate_d64(q, k, v, table, pos, window=window, num_splits=ns)
    want = ops.paged_decode_attention_plain(
        q, k, v, table, torch.tensor(pos, dtype=torch.int32), window=window,
        num_splits=ns)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-3)


# --------------------------------------------------- the bitwise claims
@pytest.mark.parametrize("case", VERIFY)
def test_verify_rows_are_bitwise_the_one_token_rows(case):
    """Row t of a T-row block (16 columns at T = 9) equals the T = 1 launch
    at pos + t (8 columns, under the block's ``active``) bitwise: another
    instance, other chunks, other tiles before the row's window or past its
    position, the same bits."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    block = emulate_d64(q, k, v, table, pos, window=window)
    active = [p >= 0 for p in pos]
    for tt in range(t):
        one = emulate_d64(q[:, tt:tt + 1].contiguous(), k, v, table,
                          [p + tt for p in pos], window=window,
                          active=active)
        assert torch.equal(block[:, tt:tt + 1], one)


@pytest.mark.parametrize("case", ["t9_window", "g4_t5"])
def test_a_row_does_not_depend_on_its_instance_or_tile(case):
    """Instances of 8 and 16 columns and row tiles of each (and of 32): a
    row's bits never see its column, its block, the padding beside it or
    the other rows of its tile."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    outs = [emulate_d64(q, k, v, table, pos, window=window, tile_rows=rt)
            for rt in (MMA_COLS, MMA64_ROWS, 2 * MMA64_ROWS)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_split_k_at_whole_chunks_is_bitwise_the_single_pass(dtype):
    """Three splits of 256 keys are the three chunks: each slot's working
    chunks, their warps' keys and the merge orders are the single pass's."""
    kv, g, t, pos, window, _ = CASES["t1"]
    q, k, v, table = _inputs(kv, g, t, dtype=dtype)
    one = emulate_d64(q, k, v, table, pos)
    assert torch.equal(emulate_d64(q, k, v, table, pos, num_splits=3), one)


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("g", [1, 2, 8, 48])
def test_head_dim_64_takes_the_warp_mma_route_at_every_grouping(g, dtype):
    """Head dim 64 on f32 and bf16 pools: the warp-mma route at any G (no
    T argument); the 1-byte pools keep the CUDA cores."""
    assert decode_route(g, D, dtype) == "warp_mma"
    assert decode_route(g, D, torch.int8) == "cuda_cores"


@pytest.mark.parametrize("g,t", [(1, 1), (1, 4), (1, 8), (1, 9), (1, 16),
                                 (1, 17), (2, 9), (4, 5), (48, 4)])
def test_plan_covers_every_row_once(g, t):
    """Rows that fit 8 or 16 columns take the smaller instance in one tile
    (musicgen's T = 1 one block, its T = 9 block 16 columns with 9 live);
    more take tiles of ``MMA64_ROWS`` = 16; the tiles hold each (head,
    token) of the KV head once, none empty."""
    inst, n = row_tiles(g, t, D, "warp_mma")
    rows = g * t
    assert inst in (MMA_COLS, MMA64_ROWS)
    assert inst == (MMA_COLS if rows <= MMA_COLS else MMA64_ROWS)
    assert n == -(-rows // inst)
    held = [r for i in range(n) for r in range(i * inst,
                                               min((i + 1) * inst, rows))]
    assert sorted(held) == list(range(rows)) and (n - 1) * inst < rows
    assert row_tiles(1, 9, D, "warp_mma") == (MMA64_ROWS, 1)
    assert row_tiles(1, 1, D, "warp_mma") == (MMA_COLS, 1)


# ------------------------------------------------------ the ring layout
def _swz64(kk, esz):
    """csrc mma64_swz: key row kk's 16-byte chunk c lies at c ^
    _swz64(kk)."""
    return (((kk ^ (kk >> 2)) & 1) << 2) | (((kk >> 1) & 1)
                                            << (1 if esz == 2 else 0))


@pytest.mark.parametrize("esz", [4, 2], ids=["f32", "bf16"])
def test_fragment_reads_are_free_of_bank_conflicts(esz):
    """Every ring read of the tile loop at head dim 64, for each warp's
    keys: the K fragment (lane (g, t): keys g and g + 8 of the m-tile, its
    chunks t + 4 c, 16 bytes a read), the V fragment (keys 2t + c of each
    k-step, d 8 g .., 16 bytes a read) and the cp.async stores (thread i:
    chunk i % (D / vec) of key i // (D / vec)), through the swizzle, meet
    no two words of one bank in a wavefront."""
    vec = 16 // esz
    kw = 64 // esz

    def addr(kk, c):
        return kk * D * esz + (c ^ _swz64(kk, esz)) * 16

    for w in range(WARPS):
        for mt in range(kw // 16):
            kb = kw * w + 16 * mt
            for h in (0, 1):
                for c in range(16 // vec):
                    ka = [addr(kb + (ln >> 2) + 8 * h, (ln & 3) + 4 * c)
                          for ln in range(32)]
                    assert _worst_conflict(ka, 16) == 1, (w, mt, h, c)
            for u in (0, 1):
                for c in (0, 1):
                    for cc in range(8 // vec):
                        va = [addr(kb + 8 * u + 2 * (ln & 3) + c,
                                   8 * (ln >> 2) // vec + cc)
                              for ln in range(32)]
                        assert _worst_conflict(va, 16) == 1, (w, u, c, cc)
    vpr = D // vec
    for i in range(WARPS * kw * vpr // 128):
        st = [addr((tid + 128 * i) // vpr, (tid + 128 * i) % vpr)
              for tid in range(32)]
        assert _worst_conflict(st, 16) == 1, i


def test_the_exchange_reads_are_free_of_bank_conflicts():
    """The warp's S^T slice, row r's chunk c of 4 keys at c ^ 2 ((r >> 1)
    & 1): the transposed float4 reads (lane (g, t): row g, chunk t) meet no
    conflict, the float2 stores (lane (g, t): rows 2t and 2t + 1, keys g
    and g + 8) at most two words a bank (16 lanes of 8 bytes over rows 16
    floats apart cannot do better)."""
    def at(r, c, e=0):
        return 4 * (16 * r + 4 * (c ^ (2 * ((r >> 1) & 1))) + e)

    reads = [at(ln >> 2, ln & 3) for ln in range(32)]
    assert _worst_conflict(reads, 16) == 1
    for h in (0, 1):
        stores = [at(2 * (ln & 3) + h, (ln >> 2) >> 1, 2 * ((ln >> 2) & 1))
                  for ln in range(32)]
        assert _worst_conflict(stores, 8) == 2
