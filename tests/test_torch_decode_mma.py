"""The chunked decode kernel's warp-mma route, modelled on the CPU.

``decode_attention.decode_route`` sends the chunked decode kernel's rows to
``csrc/chunked_decode_mma.cuh`` at the groupings whose G * T rows a KV head
are few (G = 2, 4, 5 at head dim 128) on f32 and bf16 pools.  Its CTA keeps the CUDA-core kernel's chunk grid and cp.async
ring of 16-key (f32) or 32-key (bf16) tiles, and multiplies on
``mma.sync`` m16n8k8 in TF32: S^T = K q^T with 16 keys on M and the rows
on N in blocks of 8 columns, each of the four warps over its quarter of D,
the quarters summed in warp order; an online softmax per row, each lane
summing l over its keys 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-key m-tile and
the quad's parts summed at the end; p rounded to v's dtype; O^T = V^T P^T
in fresh registers added to O; f32 operands in 3xTF32 with the big part
truncated and the remainder read to its top TF32 bits.  The chunks'
(acc, m, l) merge in chunk order in a second kernel.

Here: that arithmetic emulated on the chunk grid (``emulate_mma``) and
held to the JAX package's oracles within TOL 5e-5 on f32 caches and pools,
dense and paged, windows 0 and 100, 1 and 2 splits, with one truncated TF32
product missing it; bf16 pools against the plain version; the bitwise
claims the design rests on (a verify row t and the T = 1 launch at pos + t,
a row in any instance of 8, 16 or 32 columns and any row tile, split-K at
whole chunks and the single pass); the route's plan and the route code the
dense wrappers hand the kernel for every arch on a fake card; and the
ring's swizzle, which keeps every fragment read free of bank conflicts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MMA_COLS, MMA_ROWS, ROUTES, decode_chunks, decode_route, row_tiles)
from test_torch_decode_route import ARCHS  # noqa: E402
from test_torch_row_tiles import _oracle  # noqa: E402

TOL = 5e-5  # chip_smoke.py TOL[torch.float32]
B, D, S, PAGE = 3, 32, 768, 8  # three 256-key chunks per slot
L = tdecode.CHUNK_KEYS
WARPS = 4  # each warp's S^T over a quarter of D, summed in warp order
NEG_INF = -1e30
# (KV, G, T, positions, window, num_splits): internlm2's G = 2 at one
# token and its verify block, mixtral's G = 4 verify block (16 columns),
# qwen2.5's G = 5 (8, 20 and 40 rows: one tile of 32, two), windows that
# start a chunk part way, split-K
CASES = {
    "g2_t1": (2, 2, 1, [-1, L, S - 1], 0, 1),
    "g2_t4": (2, 2, 4, [L - 1, 2 * L - 2, S - 4], 0, 1),
    "g2_t4_window": (2, 2, 4, [L - 3, 400, S - 4], 100, 1),
    "g4_t4": (2, 4, 4, [-1, 300, S - 4], 0, 1),
    "g5_t1": (1, 5, 1, [95, 2 * L, S - 1], 0, 1),
    "g5_t4_window": (1, 5, 4, [L - 3, 500, S - 4], 100, 1),
    "g5_t8": (1, 5, 8, [3, 2 * L - 4, S - 8], 0, 1),
    "g2_splits2": (2, 2, 1, [L - 1, 500, S - 1], 0, 2),
    "g4_splits2_window": (2, 4, 1, [L, 600, S - 1], 100, 2),
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


def _dense(q, k_pages, v_pages, table):
    """The same keys as a dense cache (B, S, KV, D) and the identity table
    over its one-token pages, the kernel's dense mode."""
    kd, vd = (x[table.long()].flatten(1, 2) for x in (k_pages, v_pages))
    ident = torch.arange(B * S, dtype=torch.int32).reshape(B, S)
    return kd, vd, ident, [x.reshape(B * S, 1, *x.shape[2:])
                           for x in (kd, vd)]


def tf32_trunc(x):
    """A TF32 operand as the product reads it: the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits, -0x2000).view(torch.float32)


def _mma_sum(a, b, dim, products=3):
    """Sum over ``dim`` of the route's TF32 products of ``a`` and ``b``:
    each operand's big part truncated, the remainder x - big (exact) read
    to its TF32 bits; 3 = small.big + big.small + big.big, 1 = big.big
    alone.  Values exact in TF32 (bf16) have no remainder."""
    ab, bb = tf32_trunc(a), tf32_trunc(b)
    if products == 1:
        return (ab * bb).sum(dim)
    as_, bs = tf32_trunc(a - ab), tf32_trunc(b - bb)
    return ((as_ * bb).sum(dim) + (ab * bs).sum(dim)) + (ab * bb).sum(dim)


def emulate_mma(q, k_pages, v_pages, page_idx, pos, *, window=0,
                num_splits=1, tile_rows=None, active=None, products=3):
    """The route's launch: per (slot, KV head, row tile of ``tile_rows``
    rows, default ``row_tiles``' plan, padded to blocks of 8 columns that
    see no key), per working chunk of ``decode_chunks``, the chunk's keys
    in TK-key tiles on the chunk's grid (16 in f32, 32 in bf16; keys
    outside the CTA's [lo, hi) zero-filled): S as each warp's quarter of D
    in TF32 products, summed in warp order, scaled; the row's own mask
    before the exp; the online softmax in f32, each lane's l over its keys
    2t, 2t + 8, 2t + 1, 2t + 9 of each 16-key m-tile in that order, the
    quad's parts summed (t 0 + 1) + (2 + 3) at the chunk's end; p rounded
    to v's dtype; P V in TF32 products added to O.  A slot with one
    working chunk writes its rows there, otherwise the chunks' (acc, m, l)
    merge in chunk order.  Row r of KV head j is head j G + r // T at
    position pos + r % T."""
    b, t, h, d = q.shape
    _, page_size, kv, _ = k_pages.shape
    g, rows = h // kv, h // kv * t
    if tile_rows is None:
        tile_rows = row_tiles(g, t, 128, "warp_mma")[0]
    tk = 64 // k_pages.element_size()
    _, _, ranges = decode_chunks(page_idx.shape[1], page_size, num_splits)
    kd, vd = (x[page_idx.long()].flatten(1, 2) for x in (k_pages, v_pages))
    p_dtype = v_pages.dtype
    lanes = [[16 * mt + k for mt in range(tk // 16)
              for k in (2 * tq, 2 * tq + 8, 2 * tq + 1, 2 * tq + 9)]
             for tq in range(4)]
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
                    m = torch.full((cols,), NEG_INF)
                    l = torch.zeros(4, cols)
                    o = torch.zeros(cols, d)
                    for k0 in range(cx + (lo - cx) // tk * tk, hi, tk):
                        kpos = torch.arange(k0, k0 + tk)
                        inside = (kpos >= lo) & (kpos < hi)
                        kt = torch.zeros(tk, d)
                        vt = torch.zeros(tk, d)
                        kt[inside] = kd[s, kpos[inside], j].float()
                        vt[inside] = vd[s, kpos[inside], j].float()
                        sc = None
                        for w in range(WARPS):
                            ds = slice(w * d // WARPS, (w + 1) * d // WARPS)
                            part = _mma_sum(qt[:, None, ds], kt[None, :, ds],
                                            -1, products)
                            sc = part if sc is None else sc + part
                        seen = (kpos >= wlo[:, None]) & (kpos <= whi[:, None])
                        x = torch.where(seen, sc * d ** -0.5, NEG_INF)
                        m_new = torch.maximum(m, x.amax(dim=1))
                        alpha = torch.exp(m - m_new)
                        pr = torch.where(seen, torch.exp(x - m_new[:, None]),
                                         0.0)
                        for tq, keys in enumerate(lanes):
                            acc = torch.zeros(cols)
                            for key in keys:
                                acc = acc + pr[:, key]
                            l[tq] = l[tq] * alpha + acc
                        m = m_new
                        pr = pr.to(p_dtype).float()
                        o = o * alpha[:, None] + _mma_sum(
                            pr[:, :, None], vt[None], 1, products)
                    parts.append((o[:rt], m[:rt], ((l[0] + l[1])
                                                   + (l[2] + l[3]))[:rt]))
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


def _dense_oracle(q, k, v, pos, window):
    j = [jnp.asarray(x.float().numpy()).transpose(0, 2, 1, 3)
         for x in (q, k, v)]
    want = jref.decode_attention_ref(*j, jnp.asarray(pos, jnp.int32),
                                     window=window)
    return np.asarray(want).transpose(0, 2, 1, 3)


# ------------------------------------------------------- the arithmetic
@pytest.mark.parametrize("case", list(CASES))
def test_paged_model_matches_jax_oracle(case):
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    got = emulate_mma(q, k, v, table, pos, window=window, num_splits=ns)
    np.testing.assert_allclose(got.numpy(),
                               _oracle(q, k, v, table, pos, window),
                               atol=TOL, rtol=TOL)
    for s, p in enumerate(pos):
        if p < 0:
            assert float(got[s].abs().max()) == 0.0  # a parked slot


@pytest.mark.parametrize("case", ["g2_t4_window", "g5_t8",
                                  "g4_splits2_window"])
def test_dense_model_matches_jax_oracle(case):
    """The dense mode: the slot's stripe as one-token pages through an
    identity table, on the same chunk grid (``decode_chunks(S, 1, ns)``),
    against the JAX dense oracle."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    kd, vd, ident, pages = _dense(q, k, v, table)
    got = emulate_mma(q, *pages, ident, pos, window=window, num_splits=ns)
    np.testing.assert_allclose(got.numpy(),
                               _dense_oracle(q, kd, vd, pos, window),
                               atol=TOL, rtol=TOL)


def test_one_truncated_product_misses_the_tolerance():
    """The split is needed: big.big alone, both operands truncated to
    TF32, lands outside TOL of the oracle on the same inputs."""
    kv, g, t, pos, window, ns = CASES["g2_t4"]
    q, k, v, table = _inputs(kv, g, t)
    got = emulate_mma(q, k, v, table, pos, window=window, products=1)
    want = _oracle(q, k, v, table, pos, window)
    assert np.abs(got.numpy() - want).max() > TOL


@pytest.mark.parametrize("case", ["g2_t4", "g5_t4_window"])
def test_model_on_bf16_pools_matches_the_plain_version(case):
    """bf16 pools (32-key tiles, two m-tiles): K and V exact in TF32, p
    rounded to bf16 before P V, as the plain version (the card's
    yardstick) does; the tolerance is chip_smoke.py's for bf16 pools."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t, dtype=torch.bfloat16)
    got = emulate_mma(q, k, v, table, pos, window=window, num_splits=ns)
    want = ops.paged_decode_attention_plain(
        q, k, v, table, torch.tensor(pos, dtype=torch.int32), window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-3)


# --------------------------------------------------- the bitwise claims
@pytest.mark.parametrize("case", VERIFY)
def test_verify_rows_are_bitwise_the_one_token_rows(case):
    """Row t of a T-row block equals the T = 1 launch at pos + t (under
    the block's ``active``) bitwise: another instance (8 columns for one
    token), other chunks, other tiles before the row's window or past its
    position, the same bits."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    block = emulate_mma(q, k, v, table, pos, window=window)
    active = [p >= 0 for p in pos]
    for tt in range(t):
        one = emulate_mma(q[:, tt:tt + 1].contiguous(), k, v, table,
                          [p + tt for p in pos], window=window,
                          active=active)
        assert torch.equal(block[:, tt:tt + 1], one)


@pytest.mark.parametrize("case", ["g5_t4_window", "g5_t8"])
def test_a_row_does_not_depend_on_its_instance_or_tile(case):
    """Instances of 8, 16 and 32 columns and row tiles of each: a row's
    bits never see its column, its block, the padding beside it or the
    other rows of its tile."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    outs = [emulate_mma(q, k, v, table, pos, window=window, tile_rows=rt)
            for rt in (MMA_COLS, 2 * MMA_COLS, MMA_ROWS)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_split_k_at_whole_chunks_is_bitwise_the_single_pass(dtype):
    """Three splits of 256 keys are the three chunks: each slot's working
    chunks and their merge order are the single pass's."""
    kv, g, t, pos, window, _ = CASES["g5_t1"]
    q, k, v, table = _inputs(kv, g, t, dtype=dtype)
    one = emulate_mma(q, k, v, table, pos)
    assert torch.equal(emulate_mma(q, k, v, table, pos, num_splits=3), one)


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("g,t", [(1, 1), (2, 1), (2, 4), (4, 4), (5, 1),
                                 (5, 3), (5, 4), (5, 8), (1, 9), (1, 16)])
def test_plan_covers_every_row_once(g, t):
    """Rows that fit 8 or 16 columns take the smaller instance in one tile;
    more take tiles of ``MMA_ROWS``; the tiles hold each (head, token) of
    the KV head once, none empty."""
    inst, n = row_tiles(g, t, 128, "warp_mma")
    rows = g * t
    assert inst in (MMA_COLS, 2 * MMA_COLS, MMA_ROWS)
    assert n == 1 or inst == MMA_ROWS
    assert inst == next(i for i in (MMA_COLS, 2 * MMA_COLS, MMA_ROWS)
                        if rows <= i or i == MMA_ROWS)
    held = [r for i in range(n) for r in range(i * inst,
                                               min((i + 1) * inst, rows))]
    assert sorted(held) == list(range(rows)) and (n - 1) * inst < rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_wrappers_hand_the_route_code(arch, dtype, monkeypatch):
    """The arch's grouping and head dim on a dense cache of ``dtype``,
    through the dense wrapper on a fake card at T = 1..16 (and split-K at
    T = 1): every launch hands the kernel ``decode_route``'s route as its
    index in ``ROUTES`` beside ``row_tiles``' plan on that route, the same
    route at every T."""
    from test_torch_kernels import _fake_card

    cfg = get_config(arch)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    monkeypatch.setattr(tdecode, "_TICKETS", {})
    monkeypatch.setattr(tdecode, "ROUTE_LAUNCHES",
                        dict.fromkeys(ROUTES, 0))
    lib, _ = _fake_card(monkeypatch, 0)
    cache = torch.zeros((1, 32, kv, d)).to(dtype)
    route = decode_route(h // kv, d, dtype)
    for t in range(1, 17):
        tdecode.decode_attention_cuda(torch.zeros((1, t, h, d)), cache,
                                      cache.clone(), [3])
        # B, T, H, KV, S, D, window at 6-12, then chunk, chunks, the plan
        assert lib.calls[-1][1][15:18] == (
            *row_tiles(h // kv, t, d, route), ROUTES.index(route))
    tdecode.decode_attention_splitk_cuda(torch.zeros((1, 1, h, d)), cache,
                                         cache.clone(), [3], num_splits=2)
    # split-K: B, H, KV, S, D, window, ns at 6-12
    assert lib.calls[-1][1][15:18] == (*row_tiles(h // kv, 1, d, route),
                                       ROUTES.index(route))
    assert tdecode.ROUTE_LAUNCHES[route] == 17
    want = {"granite-20b": "tensor_cores", "qwen3-moe-235b-a22b":
            "tensor_cores", "zamba2-2.7b": "cuda_cores"}.get(arch,
                                                             "warp_mma")
    assert route == want


# ------------------------------------------------------ the ring layout
def _swz(kk):
    """csrc mma_swz: the position of a key row's 16-byte chunk c is
    c ^ _swz(kk)."""
    return (kk & 7) ^ ((kk & 1) << 2)


def _worst_conflict(addrs, nbytes):
    """The most lanes of one 128-byte wavefront that hit one bank at
    different words (1: conflict-free) for a warp's ``nbytes`` loads."""
    per, worst = 128 // nbytes, 1
    for start in range(0, 32, per):
        banks = {}
        for a in addrs[start:start + per]:
            for w in range(nbytes // 4):
                word = a // 4 + w
                banks.setdefault(word % 32, set()).add(word)
        worst = max(worst, max(len(v) for v in banks.values()))
    return worst


@pytest.mark.parametrize("esz", [4, 2], ids=["f32", "bf16"])
def test_fragment_reads_are_free_of_bank_conflicts(esz):
    """Every fragment read of the kernel's tile loop at head dim 128, at
    each warp: the K fragment (lane (g, t): key g (+ 8) of the m-tile, d
    32 w + 8 t .., 8 values, 16 bytes a read) and the V fragment (key 2t +
    c of each k-step, d 32 w + 4 g .., 4 values), through the swizzle, meet
    no two words of one bank in a wavefront."""
    d, vec = 128, 16 // esz

    def addr(kk, e):
        c = e // vec
        return kk * d * esz + ((c ^ _swz(kk)) * vec + e % vec) * esz

    wd = d // 4
    kpl = wd // 4  # a lane's K values, read 16 bytes (or all) at a time
    nbytes = min(16, kpl * esz)
    for w in range(4):
        for k8 in (0, 8):
            for c in range(kpl * esz // nbytes):
                ka = [addr((ln >> 2) + k8, wd * w + kpl * (ln & 3)
                           + c * nbytes // esz) for ln in range(32)]
                assert _worst_conflict(ka, nbytes) == 1, (w, k8, c)
        for u in (0, 1):
            for c in (0, 1):
                va = [addr(8 * u + 2 * (ln & 3) + c,
                           wd * w + wd // 8 * (ln >> 2)) for ln in range(32)]
                assert _worst_conflict(va, wd // 8 * esz) == 1, (w, u, c)
