"""The port's paged model path held against the JAX model's (its XLA path,
``use_pallas=False``): the same weights (JAX ``LM.init``, carried across
with ``params_from_jax``), the same page pools (``paged_cache_from_jax``)
and the same numpy inputs must give the same logits and pools, and the
paged cache writes must land where the reference's do."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

# f32 end to end on both sides; the frameworks sum in different orders
# through 2 layers and the unembedding, which stays well inside 1e-4.
ATOL = 1e-4
PAGE, MAX_PAGES = 4, 8  # 32 logical positions per slot


def _pair():
    jm, jp = tiny_lm()
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _table(spans, seed, n_pages):
    """Shuffled page table: slot b maps ceil(spans[b] / PAGE) distinct
    pages drawn from 1..n_pages-1, the rest of each row is page 0."""
    rng = np.random.default_rng(seed)
    phys = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((len(spans), MAX_PAGES), np.int32)
    used = 0
    for b, span in enumerate(spans):
        n = -(-span // PAGE)
        table[b, :n] = phys[used:used + n]
        used += n
    return table


def _pools(jm, tm, n_pages, seed):
    """Random-filled pools as a JAX tree and the port's converted tree."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda a: a.shape,
                          jm.init_cache_paged(n_pages, PAGE))
    filled = jax.tree.map(
        lambda shp: rng.normal(size=shp).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    tc = convert.paged_cache_from_jax(filled)
    want = tm.init_cache_paged(n_pages, PAGE)["stack"]["k"].shape
    assert tc["stack"]["k"].shape == want == filled["stack"]["k"].shape
    return jax.tree.map(jnp.asarray, filled), tc


def _rows(n, seed, b=2, t=1, kv=2, d=8):
    rng = np.random.default_rng(seed)
    pools = rng.normal(size=(n, PAGE, kv, d)).astype(np.float32)
    new = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    return pools, new


def _update_both(jfn, tfn, pools, new, *args):
    jk, _ = jfn(jnp.asarray(pools), jnp.asarray(pools), jnp.asarray(new),
                jnp.asarray(new), *[jnp.asarray(a) for a in args], PAGE)
    tk = torch.from_numpy(pools.copy())
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args]
    tfn(tk, tk.clone(), torch.from_numpy(new), torch.from_numpy(new),
        *targs, PAGE)
    return tk.numpy(), np.asarray(jk)


def test_paged_cache_update_parks_on_null_page():
    """pos -1 writes null page 0 (offset 0) -- not the slot's last mapped
    page, where a torch [-1] index would land -- a mapped position writes
    its page and offset, and a position past the span writes nothing; all
    exactly as the reference, whole pools compared."""
    pools, new = _rows(10, seed=1)
    table = np.array([[3, 5, 0, 0, 0, 0, 0, 0], [7, 2, 9, 0, 0, 0, 0, 0]],
                     np.int32)
    pos = np.array([-1, 6], np.int32)
    got, want = _update_both(jattn.paged_cache_update,
                             tattn.paged_cache_update, pools, new, pos, table)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], new[0, 0])  # null page
    np.testing.assert_array_equal(got[2, 2], new[1, 0])  # page 2, offset 2
    np.testing.assert_array_equal(got[5], pools[5])  # slot 0's last page
    changed = np.argwhere((got != pools).any(axis=(2, 3)))
    assert sorted(map(tuple, changed)) == [(0, 0), (2, 2)]
    # past the table's span the reference drops the write, and so does the
    # port: with a parked slot beside it, with a live slot beside it, and
    # with every row past the span
    for pos in ([-1, MAX_PAGES * PAGE], [5, MAX_PAGES * PAGE + 3],
                [MAX_PAGES * PAGE, MAX_PAGES * PAGE + 1]):
        got, want = _update_both(jattn.paged_cache_update,
                                 tattn.paged_cache_update, pools, new,
                                 np.array(pos, np.int32), table)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pools)


def test_paged_cache_update_multi_past_span_goes_to_null_page():
    """A 3-row block of a parked slot and one that runs past the table's
    span: every row that is not valid lands on page 0 and no page the
    slot holds is touched beyond its own rows."""
    pools, new = _rows(10, seed=2, t=3)
    table = np.array([[3, 5, 0, 0, 0, 0, 0, 0], [7, 2, 9, 4, 6, 1, 8, 5]],
                     np.int32)
    pos = np.array([-1, MAX_PAGES * PAGE - 2], np.int32)
    got, want = _update_both(jattn.paged_cache_update_multi,
                             tattn.paged_cache_update_multi, pools, new, pos,
                             table)
    # page 0 takes several rows at once (either write may win): compare
    # every other page exactly
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_array_equal(got[5, 2:], new[1, :2])  # last page
    untouched = np.ones(10, bool)
    untouched[[0, 5]] = False
    np.testing.assert_array_equal(got[untouched], pools[untouched])


def test_paged_prefill_chunk_update_matches_jax():
    """A 12-row chunk at offset 8 writes the three pages its row maps from
    block 2; a chunk past the row is an error (the reference would clamp
    its start)."""
    rng = np.random.default_rng(3)
    pools = rng.normal(size=(16, PAGE, 2, 8)).astype(np.float32)
    new = rng.normal(size=(1, 12, 2, 8)).astype(np.float32)
    table = _table([24, 32], seed=3, n_pages=16)
    got_k = torch.from_numpy(pools.copy())
    tattn.paged_prefill_chunk_update(got_k, got_k.clone(),
                                     torch.from_numpy(new),
                                     torch.from_numpy(new), 1, 8,
                                     torch.from_numpy(table), PAGE)
    jk, _ = jattn.paged_prefill_chunk_update(
        jnp.asarray(pools), jnp.asarray(pools), jnp.asarray(new),
        jnp.asarray(new), 1, 8, jnp.asarray(table), PAGE)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(got_k.numpy()[table[1, 2:5]],
                                  new[0].reshape(3, PAGE, 2, 8))
    for offset in (24, 6):  # past the row; not page-aligned
        with pytest.raises(ValueError):
            tattn.paged_prefill_chunk_update(
                got_k, got_k.clone(), torch.from_numpy(new),
                torch.from_numpy(new), 1, offset, torch.from_numpy(table),
                PAGE)


def test_paged_decode_attention_xla_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 2, 4, 8)).astype(np.float32)
    k = rng.normal(size=(20, PAGE, 2, 8)).astype(np.float32)
    v = rng.normal(size=(20, PAGE, 2, 8)).astype(np.float32)
    table = _table([0, 9, 32], seed=4, n_pages=20)
    pos = np.array([-1, 7, 30], np.int32)
    want = jattn.paged_decode_attention_xla(
        *(jnp.asarray(a) for a in (q, k, v, table, pos)), window=6)
    got = tattn.paged_decode_attention_xla(
        *(torch.from_numpy(a) for a in (q, k, v, table, pos)), window=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("splits", [1, 2])
def test_decode_step_paged_matches_jax(splits):
    """Ragged positions with a parked slot (-1) and the last row, through a
    shuffled table; logits and every page of both pools."""
    jm, jp, tm, tp = _pair()
    if splits > 1:
        tm = LM(tm.cfg, tm.knobs.with_(decode_splits=splits), device="cpu")
    n_pages = 4 * MAX_PAGES + 1
    pos = np.array([-1, 0, 13, MAX_PAGES * PAGE - 1], np.int32)
    table = _table([0, 1, 14, MAX_PAGES * PAGE], seed=5, n_pages=n_pages)
    jc, tc = _pools(jm, tm, n_pages, seed=6)
    toks = np.random.default_rng(7).integers(0, 64, size=(4, 1))
    step = jax.jit(functools.partial(jm.decode_step_paged, page_size=PAGE))
    jl, jc2 = step(jp, jc, jnp.asarray(toks, jnp.int32), jnp.asarray(pos),
                   jnp.asarray(table))
    tl, tc2 = tm.decode_step_paged(tp, tc, torch.from_numpy(toks), pos,
                                   torch.from_numpy(table), page_size=PAGE)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    got = convert.paged_cache_to_numpy(tc2)
    for key in ("k", "v"):
        np.testing.assert_allclose(got["stack"][key],
                                   np.asarray(jc2["stack"][key]), atol=ATOL,
                                   rtol=ATOL)


def test_prefill_chunk_step_paged_matches_jax():
    """Two 8-row chunks of one slot through a shuffled table: the second,
    at offset 8, reads the pages the first wrote."""
    jm, jp, tm, tp = _pair()
    c, slot, n_pages = 8, 1, 2 * MAX_PAGES + 1
    table = _table([20, 16], seed=8, n_pages=n_pages)
    jc, tc = _pools(jm, tm, n_pages, seed=9)
    prompt = np.random.default_rng(10).integers(0, 64, size=(1, 2 * c))
    step = jax.jit(functools.partial(jm.prefill_chunk_step_paged,
                                     page_size=PAGE))
    for ci in range(2):
        chunk = prompt[:, ci * c:(ci + 1) * c]
        jl, jc = step(jp, jc, jnp.asarray(chunk, jnp.int32), jnp.int32(slot),
                      jnp.int32(ci * c), jnp.asarray(table))
        tl, tc = tm.prefill_chunk_step_paged(
            tp, tc, torch.from_numpy(chunk), slot, ci * c,
            torch.from_numpy(table), page_size=PAGE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL)
    got = convert.paged_cache_to_numpy(tc)
    for key in ("k", "v"):
        np.testing.assert_allclose(got["stack"][key],
                                   np.asarray(jc["stack"][key]), atol=ATOL,
                                   rtol=ATOL)


def test_quantized_pools_raise():
    """Scale-carrying pools convert (int8 as int8, fp8 from its raw bytes)
    and serve a step; a pool tree that is neither plain nor quantized, or a
    float pool beside scale leaves, raises."""
    jm, jp, tm, tp = _pair()
    qm = LM(tm.cfg, tm.knobs.with_(kv_quant="int8"), device="cpu")
    pools = qm.init_cache_paged(3, PAGE)
    raw = convert.paged_cache_to_numpy(pools)
    got = convert.paged_cache_from_jax(raw)
    assert got["stack"]["k"].dtype == torch.int8
    assert got["stack"]["k_scale"].shape == (2, 3, PAGE, 2, 1)
    qm.decode_step_paged(tp, got, np.zeros((1, 1), np.int64), [0],
                         np.zeros((1, MAX_PAGES), np.int32), page_size=PAGE)
    raw8 = dict(raw["stack"], k=raw["stack"]["k"].view(np.uint8),
                v=raw["stack"]["v"].view(np.uint8))
    got8 = convert.paged_cache_from_jax({"stack": raw8})
    assert got8["stack"]["v"].dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="expected"):
        convert.paged_cache_from_jax({"stack": {"k_scale": np.zeros(1)}})
    f32 = dict(raw["stack"], k=raw["stack"]["k"].astype(np.float32))
    with pytest.raises(ValueError, match="not int8 or float8_e4m3fn"):
        convert.paged_cache_from_jax({"stack": f32})
