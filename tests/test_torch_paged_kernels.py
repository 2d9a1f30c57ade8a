"""The port's paged attention kernels, plain versions on the CPU, held
against the JAX package's Pallas paged kernels (interpret mode) on the same
numpy inputs: paged decode, paged split-K decode and fused paged prefill.

The page table is shuffled, one physical page is shared by two slots, and
every entry past a slot's span is the null page 0 (filled with random
values here, so computing on it would show).  The CUDA kernels run only on the
card: ``chip_smoke.py`` holds them against these plain versions there.
Here the wrappers are checked for refusing what the kernels do not take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_decode_attention as jax_paged  # noqa: E402
from repro.kernels import paged_prefill_attention as jax_prefill  # noqa
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
    paged_prefill_attention_cuda)
from repro_torch.models import attention as tattn  # noqa: E402

B, KV, D, S = 4, 2, 16, 64
POS = np.array([-1, 5, 40, S - 1], np.int32)  # parked, ragged, last row

# f32: both sides compute in f32 with different summation orders and the
# Pallas kernel's page-by-page online softmax; 1e-5 covers that reordering.
# bf16: the Pallas kernel rounds p to bf16 before PV while the plain
# version keeps f32, and the bf16 output itself carries ~3 significant
# digits; 2e-2 covers that (the dense kernel tests use the same bounds).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _table(page_size, span, seed):
    """(B, max_pages) int32 page table over a pool of B*max_pages + 2
    pages: slot b maps the pages covering positions < span[b] to a shuffled
    set of physical pages, slot 3 shares its first page with slot 2, and
    the rest of every row is the null page 0."""
    max_pages = S // page_size
    rng = np.random.default_rng(seed)
    phys = rng.permutation(np.arange(1, B * max_pages + 2))
    table = np.zeros((B, max_pages), np.int32)
    used = 0
    for b in range(B):
        n = -(-int(span[b]) // page_size)
        table[b, :n] = phys[used:used + n]
        used += n
    table[3, 0] = table[2, 0]  # one physical page read by two slots
    return table, B * max_pages + 2


def _inputs(g, t, dtype, page_size, seed=0, c=None):
    """q (B,t,H,D) (or (1,c,H,D) for prefill), pools (P,page_size,KV,D) of
    random values (the null page too) and the page table, as JAX and torch
    arrays of ``dtype``."""
    span = (np.minimum(np.where(POS >= 0, POS + t, 0), S) if c is None
            else np.full(B, S))
    table, n_pages = _table(page_size, span, seed)
    rng = np.random.default_rng(seed + 1)
    h = KV * g
    q = rng.normal(size=(B, t, h, D) if c is None else (1, c, h, D))
    k = rng.normal(size=(n_pages, page_size, KV, D))
    v = rng.normal(size=(n_pages, page_size, KV, D))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    arrs = [a.astype(np.float32) for a in (q, k, v)]
    jx = [jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(table)]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs] + [
        torch.from_numpy(table)]
    return jx, tx


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


CASES = [(1, 1), (3, 1), (1, 2), (1, 4)]  # (T, num_splits); split-K at T=1


@pytest.mark.parametrize("page_size", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("t,ns", CASES)
def test_plain_paged_decode_matches_pallas(t, ns, window, g, dtype,
                                           page_size):
    (jq, jk, jv, jt), (tq, tk, tv, tt) = _inputs(g, t, dtype, page_size)
    want = jax_paged(jq, jk, jv, jt, jnp.asarray(POS), window=window,
                     num_splits=ns)
    got = ops.paged_decode_attention(tq, tk, tv, tt, torch.from_numpy(POS),
                                     window=window, num_splits=ns)
    assert got.shape == (B, t, KV * g, D) and got.dtype == tq.dtype
    _close(got, want, dtype)
    assert float(got[0].abs().max()) == 0.0  # parked slot writes zeros


@pytest.mark.parametrize("page_size", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("offset", [0, 24, S - 16])  # first, middle, last
def test_plain_paged_prefill_matches_pallas(offset, window, g, dtype,
                                            page_size):
    """One slot's 16-row chunk at a page-aligned offset against the slot's
    own (shuffled) page chain."""
    c, slot = 16, 2
    (jq, jk, jv, jt), (tq, tk, tv, tt) = _inputs(g, 1, dtype, page_size,
                                                 seed=7, c=c)
    want = jax_prefill(jq, jk, jv, jt, slot, offset, window=window)
    got = ops.paged_prefill_attention(tq, tk, tv, tt, slot, offset,
                                      window=window)
    assert got.shape == (1, c, KV * g, D) and got.dtype == tq.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("t,ns", CASES)
def test_paged_plain_equals_dense_plain_over_gathered_view(t, ns):
    """Gathering each slot's pages and running the dense plain version
    gives exactly the paged plain version (the same arithmetic)."""
    _, (tq, tk, tv, tt) = _inputs(2, t, "float32", 8, seed=3)
    pos = torch.from_numpy(POS)
    kd, vd = (tattn._gather(x, tt) for x in (tk, tv))
    want = ops.decode_attention_plain(tq, kd, vd, pos, window=24,
                                      num_splits=ns)
    got = ops.paged_decode_attention_plain(tq, tk, tv, tt, pos, window=24,
                                           num_splits=ns)
    assert torch.equal(got, want)
    assert torch.equal(ops.paged_decode_attention(
        tq, tk, tv, tt, pos, window=24, num_splits=ns), got)


@pytest.mark.parametrize("window", [0, 24])
def test_paged_prefill_plain_equals_chunked_attention(window):
    """The fused prefill's plain version equals the dense chunked-prefill
    attention over the slot's gathered pages (f32 reordering only)."""
    c, slot, offset = 16, 1, 32
    _, (tq, tk, tv, tt) = _inputs(2, 1, "float32", 4, seed=5, c=c)
    kd, vd = tattn.gather_slot_pages(tk, tv, tt, slot)
    want = tattn.flash_attention_xla(tq, kd, vd, window=window, q_chunk=c,
                                     q_offset=offset)
    got = ops.paged_prefill_attention_plain(tq, tk, tv, tt, slot, offset,
                                            window=window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ns", [2, 4, 8])
def test_paged_splitk_plain_equals_single_pass(ns):
    """Splits own whole pages of the table; the combine reproduces the
    single softmax (f32 rounding only)."""
    _, (tq, tk, tv, tt) = _inputs(2, 1, "float32", 8, seed=9)
    qt, kt, vt = tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2)
    pos = torch.from_numpy(POS)
    one = ref.paged_decode_attention_ref(qt, kt, vt, tt, pos, window=24)
    split = ref.paged_decode_attention_splitk_ref(qt, kt, vt, tt, pos,
                                                  window=24, num_splits=ns)
    torch.testing.assert_close(split, one, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------ CUDA wrapper checks
def _card_shaped(t=1, g=2, c=None, page_size=16, max_pages=4):
    """CPU tensors of a shape the kernels take (head_dim 128)."""
    h = KV * g
    q = torch.zeros((B, t, h, 128) if c is None else (1, c, h, 128))
    pool = torch.zeros((B * max_pages + 1, page_size, KV, 128))
    table = torch.zeros((B, max_pages), dtype=torch.int32)
    return q, pool, pool.clone(), table


@pytest.mark.parametrize("fn", [paged_decode_attention_cuda,
                                paged_decode_attention_splitk_cuda])
def test_decode_wrappers_refuse_cpu_tensors(fn):
    """No hidden fallback: a wrapper never runs a plain version."""
    q, k, v, table = _card_shaped()
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(q, k, v, table, torch.from_numpy(POS))
    assert fn.launches == before


def test_prefill_wrapper_refuses_cpu_tensors():
    q, k, v, table = _card_shaped(c=32)
    before = paged_prefill_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_prefill_attention_cuda(q, k, v, table[0], 0)
    assert paged_prefill_attention_cuda.launches == before


@pytest.mark.parametrize("case,match", [
    ("head_dim", "head_dim 16 not built"),
    ("pool_3d", "expected q"),
    ("kv_mismatch", "shapes differ"),
    ("table_int64", "int32"),
    ("table_rows", "rows for"),
    ("rows", "does not fit"),
    ("dtype", "float32/bfloat16")])
def test_decode_wrapper_refuses_bad_inputs(case, match):
    q, k, v, table = _card_shaped()
    if case == "head_dim":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
    elif case == "pool_3d":
        k = v = k[0]
    elif case == "kv_mismatch":
        v = v[:-1]
    elif case == "table_int64":
        table = table.long()
    elif case == "table_rows":
        table = table[:2]
    elif case == "rows":
        # any G*T rows per KV head go in row tiles (18 > 16 included), but
        # H must be whole groups of KV heads
        q = torch.zeros((B, 9, KV * 2 + 1, 128))
    elif case == "dtype":
        k, v = k.half(), v.half()
    with pytest.raises(ValueError, match=match):
        paged_decode_attention_cuda(q, k, v, table, torch.from_numpy(POS))


def test_splitk_wrapper_refuses_multi_token_and_ragged_splits():
    q, k, v, table = _card_shaped(t=3)
    with pytest.raises(ValueError, match="single-token"):
        paged_decode_attention_splitk_cuda(q, k, v, table, 3, num_splits=2)
    q, k, v, table = _card_shaped(max_pages=6)
    with pytest.raises(ValueError, match="must divide max_pages"):
        paged_decode_attention_splitk_cuda(q, k, v, table, 3, num_splits=4)


@pytest.mark.parametrize("case,match", [
    ("two_slots", "one slot per call"),
    ("past_row", "outside"),
    ("unaligned_g", "exceeds the 64 query rows"),
    ("table_2d", "1-D")])
def test_prefill_wrapper_refuses_bad_inputs(case, match):
    q, k, v, table = _card_shaped(c=32)
    row, offset = table[0], 0
    if case == "two_slots":
        q = torch.zeros((2, 32, KV * 2, 128))
    elif case == "past_row":
        offset = 48  # 48 + 32 > 4 pages * 16
    elif case == "unaligned_g":
        # G = 3 or 48, which do not divide 64, are taken; G > 64 is not
        q = torch.zeros((1, 32, KV * 65, 128))
    elif case == "table_2d":
        row = table
    with pytest.raises(ValueError, match=match):
        paged_prefill_attention_cuda(q, k, v, row, offset)


# ------------------------------------------------------------------- build
def test_build_target_tracks_shared_header(tmp_path, monkeypatch):
    """An edited shared header changes every library's name, so a stale
    library is never loaded; a source edit changes the libraries of that
    source (every head dim) only; each head dim is its own library; no
    nvcc is needed to see it."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert sorted(p.name for p in csrc.glob("*.cuh")) == [
        "attention_common.cuh", "chunked_decode.cuh",
        "chunked_decode_mma.cuh", "chunked_decode_tc.cuh",
        "many_row_attention.cuh", "wgmma_tf32.cuh"]
    libs = _build.LIBS
    assert len(libs) == 3 * len(_build.HEAD_DIMS) + 1
    before = {name: _build._target(name) for name in libs}
    assert all(t.parent == tmp_path / "build" for t in before.values())
    assert len(set(before.values())) == len(libs)
    assert before == {name: _build._target(name) for name in libs}
    header = csrc / "attention_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._target(name) for name in libs}
    assert all(after[n] != before[n] for n in libs)
    # a source edit changes only that source's libraries
    src = csrc / "paged_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {name: _build._target(name) for name in libs}
    for name in libs:
        assert (again[name] != after[name]) == \
            name.startswith("paged_attention_d")
