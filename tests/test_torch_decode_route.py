"""The chunked decode kernel's tensor-core route, modelled on the CPU.

``decode_attention.decode_route`` sends the chunked decode kernel's rows to
``csrc/chunked_decode_tc.cuh`` (``wgmma`` TF32, 3xTF32 for f32 operands) at
head dim 128 on f32 and bf16 pools where G = H / KV >= 16 (granite's 48,
qwen3-moe's 16), to ``csrc/chunked_decode_mma.cuh`` (``mma.sync`` TF32,
modelled in ``test_torch_decode_mma.py`` and, at head dim 64,
``test_torch_decode_d64.py``) at 2 <= G < 16 there and at every G at head
dim 64, and to the CUDA cores elsewhere.  The choice may depend on
the grouping, the head dim and the pool's dtype, never on T: a verify row
is bitwise the one-token launch at pos + t only on one arithmetic.

Here: the route of every arch at every pool dtype, through the wrappers on
a fake card at T = 1..16; the route's row plan (tiles of ``TC_ROWS`` rows
over the same chunk grid, scratch rows and tickets as the CUDA-core row
tiles keep them, modelled by ``test_torch_row_tiles.tiled_decode``); the
route's arithmetic emulated (its 32-key tiles on the chunk's grid, the
3xTF32 products of ``test_torch_tf32_split``, the row's own mask, p rounded
to v's dtype, each chunk's (acc, m, l) merged in chunk order by the
launch's second kernel) against the
JAX package's oracle and bitwise across T, splits and row tiles; and the
yardstick's rate class (``cost.decode_rate``) on each route.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    CHUNK_KEYS, TC_ROWS, decode_chunks, decode_route, row_tiles)
from test_torch_row_tiles import _oracle, tiled_decode  # noqa: E402
from test_torch_tf32_split import _tf32_sum  # noqa: E402

TOL = 5e-5  # chip_smoke.py TOL[torch.float32]
B, D, S, PAGE = 3, 32, 768, 8  # three 256-key chunks per slot
L = CHUNK_KEYS
TK = 32  # keys per tile of the route (csrc TC_TK)
NEG_INF = -1e30
# (KV, G, T, positions, window, num_splits): granite at one token and its
# verify block, qwen3-moe's one token and verify block, windows that start
# a chunk part way, granite's split-K
CASES = {
    "g48_t1": (1, 48, 1, [L, 95, S - 1], 0, 1),
    "g48_t4": (1, 48, 4, [L - 1, 2 * L - 2, S - 4], 0, 1),
    "g48_t4_window": (1, 48, 4, [L - 3, 400, S - 4], 100, 1),
    "g16_t1": (2, 16, 1, [-1, 300, S - 1], 0, 1),
    "g16_t4": (2, 16, 4, [-1, 300, S - 4], 0, 1),
    "g16_t4_window": (2, 16, 4, [L - 3, 500, S - 4], 100, 1),
    "g48_splits2": (1, 48, 1, [L - 1, 500, S - 1], 0, 2),
}
VERIFY = [c for c in CASES if CASES[c][2] > 1]
ARCHS = [a for a in list_archs() if get_config(a).num_heads]
POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8,
               torch.float8_e4m3fn)


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


def emulate_tc(q, k_pages, v_pages, page_idx, pos, *, window=0,
               num_splits=1, tile_rows=TC_ROWS, active=None):
    """The route's launch: per (slot, KV head, row tile of ``tile_rows``
    rows, working chunk of ``decode_chunks``), the chunk's keys in
    ``TK``-key tiles on the chunk's grid (keys outside the CTA's [lo, hi)
    zero-filled), S in 3xTF32, the row's own mask before the exp, the
    online softmax in f32 with p rounded to v's dtype for PV; a slot with
    one working chunk writes its rows there, otherwise the chunks' (acc,
    m, l) merge in chunk order.  Row r of KV head j is head j G + r // T at
    position pos + r % T."""
    b, t, h, d = q.shape
    _, page_size, kv, _ = k_pages.shape
    g, rows = h // kv, h // kv * t
    _, _, ranges = decode_chunks(page_idx.shape[1], page_size, num_splits)
    kd, vd = (x[page_idx.long()].flatten(1, 2) for x in (k_pages, v_pages))
    p_dtype = v_pages.dtype
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
                r = torch.arange(r0, min(r0 + tile_rows, rows))
                if not work:
                    out[s, r % t, j * g + r // t] = 0.0
                    continue
                qpos = (p + r % t)[:, None]
                parts = []
                for z in work:
                    cx, cy = ranges[z]
                    lo, hi = max(cx, lo_b), min(cy, hi_b)
                    m = torch.full((len(r),), NEG_INF)
                    l = torch.zeros(len(r))
                    o = torch.zeros(len(r), d)
                    for k0 in range(cx + (lo - cx) // TK * TK, hi, TK):
                        kpos = torch.arange(k0, k0 + TK)
                        inside = (kpos >= lo) & (kpos < hi)
                        kt = torch.zeros(TK, d)
                        vt = torch.zeros(TK, d)
                        kt[inside] = kd[s, kpos[inside], j].float()
                        vt[inside] = vd[s, kpos[inside], j].float()
                        sc = _tf32_sum(qj[r][:, None, :], kt[None], -1) \
                            * d ** -0.5
                        seen = (kpos < hi) & (kpos <= qpos)
                        if window:
                            seen = seen & (qpos - kpos < window)
                        x = torch.where(seen, sc, NEG_INF)
                        m_new = torch.maximum(m, x.amax(dim=1))
                        alpha = torch.exp(m - m_new)
                        pr = torch.where(seen, torch.exp(x - m_new[:, None]),
                                         0.0)
                        m = m_new
                        l = l * alpha + pr.sum(dim=1)
                        pr = pr.to(p_dtype).float()
                        o = o * alpha[:, None] + _tf32_sum(
                            pr[:, :, None], vt[None], 1)
                    parts.append((o, m, l))
                if len(work) == 1:
                    o, _, l = parts[0]
                    res = o / torch.clamp(l, min=1e-30)[:, None]
                else:
                    m_star = torch.stack([m for _, m, _ in parts]).amax(0)
                    num, den = torch.zeros(len(r), d), torch.zeros(len(r))
                    for o, m, l in parts:
                        e = torch.exp(m - m_star)
                        num = num + o * e[:, None]
                        den = den + l * e
                    res = num / torch.clamp(den, min=1e-30)[:, None]
                out[s, r % t, j * g + r // t] = res
    return out


# ------------------------------------------------------------ the route
def test_route_takes_no_t():
    """The route's arguments are the grouping, the head dim and the pool's
    dtype: nothing that T or the row count could move."""
    assert list(inspect.signature(decode_route).parameters) == [
        "g", "head_dim", "kv_dtype"]


@pytest.mark.parametrize("g,d,dtype,want", [
    (48, 128, torch.float32, "tensor_cores"),
    (48, 128, torch.bfloat16, "tensor_cores"),
    (16, 128, torch.float32, "tensor_cores"),
    (64, 128, torch.float32, "tensor_cores"),
    (48, 128, torch.int8, "cuda_cores"),
    (16, 128, torch.float8_e4m3fn, "cuda_cores"),
    (5, 128, torch.float32, "warp_mma"),
    (4, 128, torch.bfloat16, "warp_mma"),
    (2, 128, torch.float32, "warp_mma"),
    (1, 64, torch.float32, "warp_mma"),
    (1, 64, torch.bfloat16, "warp_mma"),
    (16, 64, torch.float32, "warp_mma"),
    (1, 64, torch.int8, "cuda_cores"),
    (1, 80, torch.bfloat16, "cuda_cores"),
    (16, 80, torch.float32, "cuda_cores"),
    (2, 128, torch.int8, "cuda_cores"),
    (1, 128, torch.float32, "cuda_cores")])
def test_route_by_grouping_head_dim_and_pool_dtype(g, d, dtype, want):
    assert decode_route(g, d, dtype) == want


@pytest.mark.parametrize("dtype", POOL_DTYPES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_wrappers_take_one_route_at_every_t(arch, dtype, monkeypatch):
    """The arch's grouping and head dim on a pool of ``dtype``, through the
    paged wrapper on a fake card at T = 1..16: every launch hands the
    kernel the plan of one route, ``decode_route``'s, and counts it in
    ``ROUTE_LAUNCHES``: on f32 and bf16 pools the wgmma row tiles at
    granite and qwen3-moe, the CUDA-core instances at zamba2's head dim
    80 and the warp-mma instances at every other arch (musicgen's head dim
    64 too); the CUDA cores on the 1-byte pools."""
    from test_torch_quant_kv import _fake_card

    cfg = get_config(arch)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    monkeypatch.setattr(tdecode, "_TICKETS", {})
    monkeypatch.setattr(tdecode, "ROUTE_LAUNCHES",
                        dict.fromkeys(tdecode.ROUTES, 0))
    lib = _fake_card(monkeypatch, 0)
    pool = torch.zeros((5, PAGE, kv, d)).to(dtype)
    sc = {}
    if dtype in tdecode.QUANT_DTYPES:
        scale = torch.ones((5, PAGE, kv, 1))
        sc = dict(k_scale=scale, v_scale=scale.clone())
    table = torch.arange(1, 5, dtype=torch.int32).reshape(1, 4)
    route = decode_route(h // kv, d, dtype)
    for t in range(1, 17):
        tpaged.paged_decode_attention_cuda(torch.zeros((1, t, h, d)), pool,
                                           pool.clone(), table, [3], **sc)
        plan = lib.calls[-1][1][19:22]  # 7 pointers, pt_stride, 11 ints
        assert plan == (*row_tiles(h // kv, t, d, route),
                        tdecode.ROUTES.index(route))
        assert (plan[0] == TC_ROWS) == (route == "tensor_cores")
    assert tdecode.ROUTE_LAUNCHES[route] == 16
    want = {"granite-20b": "tensor_cores", "qwen3-moe-235b-a22b":
            "tensor_cores", "zamba2-2.7b": "cuda_cores"}.get(arch,
                                                             "warp_mma")
    assert route == (want if dtype in tdecode.FLOAT_DTYPES else "cuda_cores")


def test_route_refuses_q_rows_off_16_bytes(monkeypatch):
    """The tensor-core route copies q 16 bytes at a time: a q whose rows
    do not start on 16 bytes raises before any launch, at granite's
    grouping; the warp-mma route (G = 2), which reads q a value at a
    time, takes it."""
    from test_torch_kernels import _fake_card

    monkeypatch.setattr(tdecode, "_TICKETS", {})
    lib, _ = _fake_card(monkeypatch, 0)
    for h, kv, raises in ((48, 1, True), (4, 2, False)):
        buf = torch.zeros(2 * h * 128 + 1)
        q = buf[1:].reshape(2, 1, h, 128)  # rows 4 bytes off 16
        cache = torch.zeros((2, 64, kv, 128))
        calls = len(lib.calls)
        if raises:
            with pytest.raises(ValueError, match="start on 16 bytes"):
                tdecode.decode_attention_cuda(q, cache, cache.clone(), [3, 9])
            assert len(lib.calls) == calls
        else:
            tdecode.decode_attention_cuda(q, cache, cache.clone(), [3, 9])
            assert len(lib.calls) == calls + 1


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("g,t", [(16, 1), (16, 4), (16, 8), (16, 16),
                                 (48, 1), (48, 2), (48, 3), (48, 4),
                                 (64, 4)])
def test_route_plan_covers_every_row_once(g, t):
    """Tiles of ``TC_ROWS`` rows cover each (head, token) of the KV head
    once, none empty; a tile's second warpgroup (rows 64-127) has rows
    only where G * T reaches them (granite's T = 1 and qwen3-moe's blocks
    run one warpgroup)."""
    inst, n = row_tiles(g, t, 128, "tensor_cores")
    rows = g * t
    assert inst == TC_ROWS and (n - 1) * inst < rows <= n * inst
    held = [r for i in range(n) for r in range(i * inst,
                                               min((i + 1) * inst, rows))]
    assert sorted(held) == list(range(rows))
    assert {divmod(r, t) for r in held} == {(gg, tt) for gg in range(g)
                                            for tt in range(t)}
    busy = [[i * inst + 64 * w < rows for w in (0, 1)] for i in range(n)]
    assert all(b[0] for b in busy)
    assert busy[-1][1] == (rows > (n - 1) * inst + 64)


@pytest.mark.parametrize("case", list(CASES))
def test_route_tiles_write_disjoint_scratch_rows(case):
    """The route's CTAs, (KV head and tile of ``TC_ROWS`` rows, slot,
    chunk), write each row's chunk partial once, inside the (B, KV,
    chunks, G * T) scratch: every row of a slot once for each of its
    working chunks, which the merge then reads in chunk order."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    _, written, _ = tiled_decode(q, k, v, table, pos, window=window,
                                 num_splits=ns, tile_rows=TC_ROWS)
    _, _, ranges = decode_chunks(S // PAGE, PAGE, ns)
    rows = [r for rs in written.values() for r in rs]
    assert len(rows) == len(set(rows))
    assert 0 <= min(rows) and max(rows) < B * kv * len(ranges) * g * t
    for s, p in enumerate(pos):
        lo_b = max(0, p - window + 1) if window else 0
        work = [z for z, (lo, hi) in enumerate(ranges)
                if p >= 0 and max(lo, lo_b) < min(hi, p + t)]
        for j in range(kv):
            base = (s * kv + j) * len(ranges)
            got = sorted(r for (x, ss, z), rs in written.items()
                         if ss == s and x // -(-g * t // TC_ROWS) == j
                         for r in rs)
            assert got == sorted((base + z) * g * t + r for z in work
                                 for r in range(g * t))


# ------------------------------------------------------- the arithmetic
@pytest.mark.parametrize("case", list(CASES))
def test_route_model_matches_jax_oracle(case):
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    got = emulate_tc(q, k, v, table, pos, window=window, num_splits=ns)
    np.testing.assert_allclose(got.numpy(),
                               _oracle(q, k, v, table, pos, window),
                               atol=TOL, rtol=TOL)
    for s, p in enumerate(pos):
        if p < 0:
            assert float(got[s].abs().max()) == 0.0  # a parked slot


@pytest.mark.parametrize("case", ["g48_t4", "g16_t1"])
def test_route_model_on_bf16_pools_matches_the_plain_version(case):
    """bf16 pools: K and V exact in TF32 (no small part), p rounded to
    bf16 before PV, as the plain version (the card's yardstick) does; the
    tolerance is chip_smoke.py's for bf16 pools (a p next to a bf16
    rounding boundary may round the other way)."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t, dtype=torch.bfloat16)
    got = emulate_tc(q, k, v, table, pos, window=window, num_splits=ns)
    want = ops.paged_decode_attention_plain(
        q, k, v, table, torch.tensor(pos, dtype=torch.int32), window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("case", VERIFY)
def test_verify_rows_are_bitwise_the_one_token_rows(case):
    """Row t of a T-row block equals the T = 1 launch at pos + t (under
    the block's ``active``) bitwise: other chunks, other tiles before the
    row's window or past its position, the same bits."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    block = emulate_tc(q, k, v, table, pos, window=window)
    active = [p >= 0 for p in pos]
    for tt in range(t):
        one = emulate_tc(q[:, tt:tt + 1].contiguous(), k, v, table,
                         [p + tt for p in pos], window=window, active=active)
        assert torch.equal(block[:, tt:tt + 1], one)


def test_split_k_at_whole_chunks_is_bitwise_the_single_pass():
    """Three splits of 256 keys are the three chunks: each slot's working
    chunks and their merge order are the single pass's."""
    kv, g, t, pos, window, _ = CASES["g48_t1"]
    q, k, v, table = _inputs(kv, g, t)
    one = emulate_tc(q, k, v, table, pos)
    assert torch.equal(emulate_tc(q, k, v, table, pos, num_splits=3), one)


@pytest.mark.parametrize("case", ["g48_t4", "g16_t4_window"])
def test_a_row_does_not_depend_on_its_row_tile(case):
    """Row tiles of 64, 128 (the route's) and 192 rows: a row's bits never
    see its tile or the other rows in it."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    outs = [emulate_tc(q, k, v, table, pos, window=window, tile_rows=rt)
            for rt in (64, TC_ROWS, 192)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


# ------------------------------------------------------------ the bound
@pytest.mark.parametrize("h,kv,d,qd,kd,want", [
    (48, 1, 128, torch.float32, torch.float32, "tf32x3"),
    (64, 4, 128, torch.bfloat16, torch.bfloat16, "bf16"),
    (64, 4, 128, torch.float32, torch.bfloat16, "tf32x3"),
    (48, 1, 128, torch.float32, torch.int8, "f32"),
    (40, 8, 128, torch.float32, torch.float32, "tf32x3"),
    (32, 32, 64, torch.float32, torch.float32, "tf32x3"),
    (32, 32, 64, torch.float32, torch.bfloat16, "tf32x2"),
    (32, 32, 64, torch.float32, torch.int8, "f32"),
    (32, 32, 80, torch.float32, torch.float32, "f32")])
def test_decode_work_reckons_the_route_s_rate(h, kv, d, qd, kd, want):
    """``cost.decode_rate`` gives the route's rate class (``tc_class`` on
    the wgmma route, ``mma_class`` on the warp-mma route, the CUDA cores'
    "f32" elsewhere), and the meta branch's record carries the same flops
    under it."""
    q = torch.zeros((2, 4, h, d), dtype=qd, device="meta")
    k = torch.zeros((2, 64, kv, d), dtype=kd, device="meta")
    assert cost.decode_rate(q, k) == want
    w = cost.decode_work(2, 4, h, d, kv, 64, q.element_size(),
                         k.element_size(), [10, 20],
                         rate=cost.decode_rate(q, k))
    assert set(w.flops) == {want}
    if kd in tdecode.FLOAT_DTYPES:
        got = []
        with cost.recording(lambda name, work: got.append(work)):
            ops.decode_attention(q, k, k, [10, 20])
        assert got[0].flops == w.flops


@pytest.mark.parametrize("qd,kd,want", [
    (torch.float32, torch.float32, "tf32x3"),
    (torch.float32, torch.bfloat16, "tf32x2"),
    (torch.bfloat16, torch.bfloat16, "tf32"),
    (torch.bfloat16, torch.float32, "tf32x3")], ids=str)
def test_decode_work_reckons_the_warp_mma_rate(qd, kd, want):
    """On the warp-mma route (qwen2.5's G = 5 at head dim 128) the class of
    its TF32 products: three on an f32 pool, two where only q has a small
    part (bf16 K and V are exact in TF32, and so is p rounded to bf16), one
    on bf16 q and pools; the bound's operations term takes that rate."""
    q = torch.zeros((2, 4, 40, 128), dtype=qd, device="meta")
    k = torch.zeros((2, 64, 8, 128), dtype=kd, device="meta")
    assert decode_route(5, 128, kd) == "warp_mma"
    assert cost.mma_class(q, k) == cost.decode_rate(q, k) == want
    w = cost.decode_work(2, 4, 40, 128, 8, 64, q.element_size(),
                         k.element_size(), [10, 20], rate=want)
    t_ops = w.total_flops / cost.h100.RATES[want] * 1e3
    assert w.bound()[0] == max(t_ops, w.nbytes / cost.h100.HBM_BYTES_PER_S
                               * 1e3)
