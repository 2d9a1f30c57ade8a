"""The chunked decode kernel's row tiles, modelled on the CPU.

Where a KV head's G * T query rows are more than the kernel's largest
instance (16 rows at head dim 128, 8 at 64 and 80), ``csrc/chunked_decode
.cuh`` spreads them over ``row_tiles(g, t, head_dim)`` tiles: CTA
(blockIdx.x = j * n_tiles + i, slot b, chunk z) holds rows [i * rt,
min((i + 1) * rt, G * T)) of KV head j, writes each row's chunk partial
(acc, m, l) to scratch row (b * KV + j) * n_chunks * R + z * R + r (R = G *
T), counts ticket (b * KV + j) * n_tiles + i, and the slot's last CTA of
the tile merges the tile's rows in chunk order.  Here the same index
arithmetic runs in Python over every CTA of a launch, each row's partial
computed by a few lines of torch on its own, and the result is held to the
JAX package's oracle; a row's result must not depend on the tile size.
The wrappers' launches on a fake card (the C entry points stubbed) show the
tile plan and the tickets they hand the kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    CHUNK_KEYS, decode_chunks, row_tiles)
from test_torch_paged_decode_chunks import NEG_INF, TOL  # noqa: E402

B, D, S, PAGE = 3, 16, 768, 8  # three 256-key chunks per slot
L = CHUNK_KEYS
# (KV, G, T, positions, window, num_splits): qwen2.5's verify block (20
# rows), granite at one token (48) and its verify block (192), qwen3-moe's
# verify block (64), granite's split-K
CASES = {
    "g5_t4": (2, 5, 4, [-1, L - 2, S - 4], 0, 1),
    "g5_t4_window": (2, 5, 4, [L - 3, 400, S - 4], 100, 1),
    "g48_t1": (1, 48, 1, [L, 95, S - 1], 0, 1),
    "g48_t4": (1, 48, 4, [L - 1, 2 * L - 2, S - 4], 0, 1),
    "g16_t4": (2, 16, 4, [-1, 300, S - 4], 0, 1),
    "g48_splits2": (1, 48, 1, [L - 1, 500, S - 1], 0, 2),
}


def _inputs(kv, g, t, seed=0):
    """q (B, t, KV * G, D), pools (P, PAGE, KV, D) and a shuffled
    (B, S / PAGE) table over every page but the null page 0."""
    max_pages = S // PAGE
    rng = np.random.default_rng(seed)
    table = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
    q = rng.normal(size=(B, t, kv * g, D)).astype(np.float32)
    k, v = (rng.normal(size=(B * max_pages + 1, PAGE, kv, D))
            .astype(np.float32) for _ in (0, 1))
    return (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(table.astype(np.int32)))


def _row_partial(qrow, kx, vx, keys, qpos, window):
    """One query row's unnormalised (acc, m, l) over one chunk's keys: the
    same call for every row, whichever tile holds it."""
    sc = (kx @ qrow) * D ** -0.5
    mask = keys <= qpos
    if window:
        mask &= qpos - keys < window
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.max()
    e = torch.where(mask, torch.exp(sc - m), 0.0)
    return e @ vx, m, e.sum()


def tiled_decode(q, k_pages, v_pages, page_idx, pos, *, window=0,
                 num_splits=1, tile_rows, drop_tile=None):
    """Every CTA of the launch in the kernel's index arithmetic: its tile's
    rows, the scratch rows it writes, the ticket it counts; the last CTA of
    each (slot, KV head, tile) merges the tile's rows in chunk order.
    Returns (output, scratch rows written by CTA, ticket counts).  A
    1-byte pool's codes are taken as they are (the partition, not the
    arithmetic).  ``drop_tile``: the merge of that tile index is skipped
    (the mutant)."""
    b, t, h, d = q.shape
    _, page_size, kv, _ = k_pages.shape
    g, r_all = h // kv, h // kv * t
    _, _, ranges = decode_chunks(page_idx.shape[1], page_size, num_splits)
    n_chunks = len(ranges)
    n_tiles = -(-r_all // tile_rows)
    kd, vd = (x[page_idx.long()].flatten(1, 2).float()
              for x in (k_pages, v_pages))
    o_part = torch.full((b * kv * n_chunks * r_all, d), float("nan"))
    ml_part = torch.full((b * kv * n_chunks * r_all, 2), float("nan"))
    tickets = torch.zeros(b * kv * n_tiles, dtype=torch.int64)
    written = {}
    out = torch.full((b, t, h, d), float("nan"))
    for x in range(kv * n_tiles):
        j, tile = divmod(x, n_tiles)
        r0 = tile * tile_rows
        rt = min(tile_rows, r_all - r0)
        for s in range(b):
            p = int(pos[s])
            lo_b = max(0, p - window + 1) if window else 0
            hi_b = min(kd.shape[1], p + t) if p >= 0 else 0
            work = [z for z, (lo, hi) in enumerate(ranges)
                    if max(lo, lo_b) < min(hi, hi_b)]
            base = (s * kv + j) * n_chunks
            if not work:  # a slot that sees no key: its z = 0 CTA zeros
                for r in range(r0, r0 + rt):
                    out[s, r % t, j * g + r // t] = 0.0
                continue
            for z in work:
                lo, hi = max(ranges[z][0], lo_b), min(ranges[z][1], hi_b)
                keys = torch.arange(lo, hi)
                for r in range(r0, r0 + rt):
                    gg, tt = divmod(r, t)
                    acc, m, l = _row_partial(
                        q[s, tt, j * g + gg], kd[s, lo:hi, j],
                        vd[s, lo:hi, j], keys, p + tt, window)
                    row = (base + z) * r_all + r
                    written.setdefault((x, s, z), []).append(row)
                    o_part[row], ml_part[row] = acc, torch.stack([m, l])
                tickets[(s * kv + j) * n_tiles + tile] += 1
            if tile == drop_tile:
                continue
            for r in range(r0, r0 + rt):  # the tile's last CTA merges
                rows = [(base + z) * r_all + r for z in work]
                m_star = ml_part[rows, 0].max()
                num, den = 0.0, 0.0
                for row in rows:
                    alpha = torch.exp(ml_part[row, 0] - m_star)
                    num = num + o_part[row] * alpha
                    den = den + ml_part[row, 1] * alpha
                gg, tt = divmod(r, t)
                out[s, tt, j * g + gg] = num / torch.clamp(den, min=1e-30)
    return out, written, tickets


def _oracle(q, k, v, table, pos, window):
    j = [jnp.asarray(x.numpy()) for x in (q, k, v)]
    want = jref.paged_decode_attention_ref(
        j[0].transpose(0, 2, 1, 3), j[1].transpose(0, 2, 1, 3),
        j[2].transpose(0, 2, 1, 3), jnp.asarray(table.numpy()),
        jnp.asarray(pos, jnp.int32), window=window)
    return np.asarray(want).transpose(0, 2, 1, 3)


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("g,t", [(1, 1), (2, 1), (4, 4), (16, 1), (1, 8),
                                 (1, 9), (1, 16), (5, 4), (5, 8), (16, 4),
                                 (48, 1), (48, 4)])
def test_row_plan_covers_every_row_once(g, t, d):
    """Rows that fit an instance take the smallest that holds them, in one
    tile; more take tiles of ``TILE_ROWS``.  Tile i's rows [i * rt,
    min((i + 1) * rt, G * T)) cover each (head, token) of the KV head once,
    and no tile is empty."""
    inst, n = row_tiles(g, t, d)
    rows = g * t
    built = (2, 8, 16) if d == 128 else (2, 8)
    assert inst in built
    if rows <= tdecode.max_rows(d):
        assert n == 1 and inst == min(x for x in built if x >= rows)
    else:
        assert inst == tdecode.TILE_ROWS and n == -(-rows // inst)
    held = [r for i in range(n) for r in range(i * inst,
                                               min((i + 1) * inst, rows))]
    assert sorted(held) == list(range(rows))
    assert (n - 1) * inst < rows <= n * inst
    assert {divmod(r, t) for r in held} == {(gg, tt) for gg in range(g)
                                            for tt in range(t)}


def test_row_plan_refuses_a_head_dim_not_built():
    with pytest.raises(ValueError, match="head_dim 96 not built"):
        row_tiles(48, 1, 96)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("tile_rows", [8, 16])
@pytest.mark.parametrize("case", list(CASES))
def test_tiles_write_disjoint_scratch_rows_and_count_their_tickets(case,
                                                                  tile_rows):
    """Each CTA writes its tile's rows of its chunk, no two CTAs the same
    row, all inside the (B, KV, n_chunks, G * T) scratch; each (slot, KV
    head, tile) ticket is counted once by each working chunk."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    _, written, tickets = tiled_decode(q, k, v, table, pos, window=window,
                                       num_splits=ns, tile_rows=tile_rows)
    n_chunks = len(decode_chunks(S // PAGE, PAGE, ns)[2])
    rows = [r for rs in written.values() for r in rs]
    assert len(rows) == len(set(rows))
    assert 0 <= min(rows) and max(rows) < B * kv * n_chunks * g * t
    n_tiles = -(-g * t // tile_rows)
    assert tickets.numel() == B * kv * n_tiles
    for s, p in enumerate(pos):
        lo_b = max(0, p - window + 1) if window else 0
        _, _, ranges = decode_chunks(S // PAGE, PAGE, ns)
        n_work = sum(max(lo, lo_b) < min(hi, p + t) for lo, hi in ranges) \
            if p >= 0 else 0
        assert tickets.reshape(B, kv, n_tiles)[s].eq(n_work).all()


@pytest.mark.parametrize("tile_rows", [2, 8, 16])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_model_matches_jax_oracle(case, tile_rows):
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    got, _, _ = tiled_decode(q, k, v, table, pos, window=window,
                             num_splits=ns, tile_rows=tile_rows)
    np.testing.assert_allclose(got.numpy(),
                               _oracle(q, k, v, table, pos, window),
                               atol=TOL["float32"], rtol=TOL["float32"])
    for s, p in enumerate(pos):
        if p < 0:
            assert float(got[s].abs().max()) == 0.0  # a parked slot


@pytest.mark.parametrize("case", list(CASES))
def test_a_row_does_not_depend_on_the_tile_size(case):
    """Tiles of 2, 8 and 16 rows, and one tile of all G * T rows, give every
    row bitwise the same: nothing in a row's sums sees the tile."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    outs = [tiled_decode(q, k, v, table, pos, window=window, num_splits=ns,
                         tile_rows=rt)[0] for rt in (2, 8, 16, g * t)]
    for other in outs[1:]:
        assert torch.equal(other, outs[0])


@pytest.mark.parametrize("case", ["g5_t4", "g48_t1", "g16_t4"])
def test_model_skipping_a_tiles_merge_fails(case):
    """The oracle comparison bites on the tiles: leave out the merge of
    tile 1 and its rows are never written."""
    kv, g, t, pos, window, ns = CASES[case]
    q, k, v, table = _inputs(kv, g, t)
    mutant, _, _ = tiled_decode(q, k, v, table, pos, window=window,
                                num_splits=ns, tile_rows=8, drop_tile=1)
    want = _oracle(q, k, v, table, pos, window)
    assert not np.allclose(mutant.numpy(), want, atol=1e3 * TOL["float32"],
                           equal_nan=False)


# --------------------------------------------------- the wrappers, fake card
def _dense_card(monkeypatch):
    from test_torch_kernels import _fake_card

    monkeypatch.setattr(tdecode, "_TICKETS", {})
    return _fake_card(monkeypatch, 0)[0]


def _paged_card(monkeypatch):
    from test_torch_quant_kv import _fake_card

    monkeypatch.setattr(tdecode, "_TICKETS", {})
    return _fake_card(monkeypatch, 0)


# (H, KV, T, head dim): granite one token and verify block, qwen2.5's
# verify blocks at draft_k 3 and 7, qwen3-moe's, musicgen's T = 16
LAUNCHES = {"g48_t1": (48, 1, 1, 128), "g48_t4": (48, 1, 4, 128),
            "g5_t4": (10, 2, 4, 128), "g5_t8": (10, 2, 8, 128),
            "g16_t4": (32, 2, 4, 128), "d64_t16": (4, 4, 16, 64)}


KINDS = ("dense", "dense_splitk", "paged", "paged_splitk", "paged_int8")


@pytest.mark.parametrize("case,kind", [
    (case, kind) for case in LAUNCHES for kind in KINDS
    if LAUNCHES[case][2] == 1 or not kind.endswith("splitk")])
def test_wrappers_launch_once_with_the_row_tiles(case, kind, monkeypatch):
    """Each wrapper launches the kernel once, handing it ``row_tiles``'
    instance rows and tile count, with exactly B * KV * n_tiles zeroed
    tickets; split-K (single-token cases) and the quantized pools alike."""
    h, kv, t, d = LAUNCHES[case]
    b = 2
    q = torch.zeros((b, t, h, d))
    before = {w: w.launches for w in (
        tdecode.decode_attention_cuda, tdecode.decode_attention_splitk_cuda,
        tpaged.paged_decode_attention_cuda,
        tpaged.paged_decode_attention_splitk_cuda)}
    if kind.startswith("dense"):
        lib = _dense_card(monkeypatch)
        cache = torch.zeros((b, 520, kv, d))
        if kind == "dense":
            out = tdecode.decode_attention_cuda(q, cache, cache.clone(),
                                                [3, 300])
            wrapper = tdecode.decode_attention_cuda
        else:
            out = tdecode.decode_attention_splitk_cuda(
                q, cache, cache.clone(), [3, 300], num_splits=2)
            wrapper = tdecode.decode_attention_splitk_cuda
        at = 15  # chunk 13, chunks per split 14, then the plan
    else:
        lib = _paged_card(monkeypatch)
        pool = torch.zeros((9, 8, kv, d))
        table = torch.arange(1, 9, dtype=torch.int32).reshape(b, 4)
        sc = {}
        if kind == "paged_int8":
            pool = pool.to(torch.int8)
            scale = torch.ones((9, 8, kv, 1))
            sc = dict(k_scale=scale, v_scale=scale.clone())
        if kind == "paged_splitk":
            out = tpaged.paged_decode_attention_splitk_cuda(
                q, pool, pool.clone(), table, [3, 20], num_splits=2, **sc)
            wrapper = tpaged.paged_decode_attention_splitk_cuda
        else:
            out = tpaged.paged_decode_attention_cuda(
                q, pool, pool.clone(), table, [3, 20], **sc)
            wrapper = tpaged.paged_decode_attention_cuda
        at = 19  # 7 pointers, pt_stride, 11 ints, then the plan
    (_, args), = lib.calls
    inst, n_tiles = row_tiles(h // kv, t, d)
    assert args[at:at + 2] == (inst, n_tiles)
    assert n_tiles > 1 and inst == tdecode.TILE_ROWS
    tickets = tdecode._TICKETS[(torch.device("cpu"), 0)]
    assert tickets.numel() == b * kv * n_tiles and not tickets.any()
    assert tickets.data_ptr() in args
    assert out.shape == q.shape and wrapper.launches == before[wrapper] + 1
