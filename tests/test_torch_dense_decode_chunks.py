"""The dense decode kernels' chunk partition, modelled on the CPU.

The dense decode and split-K decode launch the chunked decode kernel of
``csrc/chunked_decode.cuh`` in its dense mode: slot b's stripe of the cache
(B, S, KV, D) is addressed as S pages of one token, and its key axis is cut
into the chunks of ``decode_attention.decode_chunks(S, 1, num_splits)``
(256 keys, clipped at the split boundaries S / num_splits and at S).  Here
the dense cache is viewed as such pages through an identity table, and the
chunk model of ``tests/test_torch_paged_decode_chunks.py``
(``chunked_decode``) runs on it.  The result is held to the JAX package's
dense oracle (``repro.kernels.ref.decode_attention_ref``) and, for
split-K, to the Pallas ``decode_attention_splitk_tpu`` in interpret mode,
on seeded numpy inputs at the tolerances of the paged model's file.  A
model that drops the slot's last chunk fails them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_splitk_tpu)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    CHUNK_KEYS, decode_chunks)
from test_torch_paged_decode_chunks import TOL, chunked_decode  # noqa: E402

B, KV, G, D = 4, 2, 2, 16
L = CHUNK_KEYS

# (S, positions, T, window, num_splits); S = 768 is three chunks, S = 520
# is two and a clipped 8-key chunk (and splits of 260, 130 and 65 keys)
CASES = {
    "parked": (768, [-1, 5, 300, 700], 1, 0, 1),
    "chunk_edges": (768, [L - 1, L, L + 1, 767], 1, 0, 1),
    "window_starts_inside_chunk": (768, [300, 600, L + 1, 767], 1, 100, 1),
    "window_in_one_chunk": (768, [300, 600, L + 1, 767], 1, 40, 1),
    "verify_t4": (768, [-1, L - 2, L, 764], 4, 0, 1),
    "verify_t4_window": (768, [L - 3, 2 * L - 1, 400, 764], 4, 100, 1),
    "splits2": (768, [L - 1, L, 500, 767], 1, 0, 2),
    "splits4": (768, [-1, L + 1, 500, 767], 1, 0, 4),
    "splits8_shorter_than_chunk": (768, [L - 1, 95, 97, 767], 1, 0, 8),
    "splits8_window": (768, [L, 95, 500, 767], 1, 100, 8),
    "s520_last_chunk_clipped": (520, [-1, 511, 512, 519], 1, 0, 1),
    "s520_verify_t4": (520, [L - 2, 300, 509, 516], 4, 0, 1),
    "s520_splits2": (520, [259, 260, 515, 519], 1, 0, 2),
    "s520_splits4_window": (520, [129, 131, 400, 519], 1, 100, 4),
    "s520_splits8": (520, [64, 65, 300, 519], 1, 0, 8),
}
SPLIT_CASES = [c for c, (_, _, _, _, ns) in CASES.items() if ns > 1]


def _inputs(s, t, dtype, seed=0):
    """q (B, t, H, D) and caches (B, s, KV, D) from a seeded numpy draw."""
    rng = np.random.default_rng(seed)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(tdt) for shape in ((B, t, KV * G, D), (B, s, KV, D),
                                        (B, s, KV, D)))


def dense_chunked(q, k, v, pos, **kw):
    """The chunk model on a dense cache: (B, S, KV, D) as B * S pages of
    one token, slot b's table row the identity b * S .. b * S + S - 1, so
    the grid is ``decode_chunks(S, 1, num_splits)``."""
    b, s = k.shape[:2]
    table = torch.arange(b * s, dtype=torch.int32).reshape(b, s)
    pages = [x.reshape(b * s, 1, *x.shape[2:]) for x in (k, v)]
    return chunked_decode(q, *pages, table, pos, **kw)


def _oracle(q, k, v, pos, window):
    """The JAX dense oracle in f32 on the same values, in model layout."""
    j = [jnp.asarray(x.float().numpy()).transpose(0, 2, 1, 3)
         for x in (q, k, v)]
    want = jref.decode_attention_ref(*j, jnp.asarray(pos, jnp.int32),
                                     window=window)
    return np.asarray(want).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_dense_chunked_model_matches_jax_oracle(case, dtype):
    s, pos, t, window, ns = CASES[case]
    q, k, v = _inputs(s, t, dtype)
    got = dense_chunked(q, k, v, pos, window=window, num_splits=ns)
    assert got.shape == (B, t, KV * G, D) and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               _oracle(q, k, v, pos, window),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for b, p in enumerate(pos):
        if p < 0:
            assert float(got[b].abs().max()) == 0.0  # a parked slot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_dense_chunked_model_matches_pallas_splitk(case, dtype):
    """Split-K: the model's chunks clipped at S / ns against the Pallas
    two-phase kernel (interpret mode) on the same values and dtype."""
    s, pos, t, window, ns = CASES[case]
    q, k, v = _inputs(s, t, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jdt).transpose(0, 2, 1, 3)
                  for x in (q, k, v))
    want = decode_attention_splitk_tpu(
        jq, jk, jv, jnp.asarray(pos, jnp.int32), window=window,
        block_k=s // ns, num_splits=ns, interpret=True)
    got = dense_chunked(q, k, v, pos, window=window, num_splits=ns)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(want, np.float32).transpose(0, 2, 1, 3),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", ["chunk_edges", "verify_t4", "splits2",
                                  "s520_last_chunk_clipped", "s520_splits8"])
def test_dense_model_dropping_the_last_chunk_fails(case):
    """The oracle comparison bites on the dense partition too: without
    each slot's last live chunk (at S = 520 the clipped 8-key one for
    positions 512 and 519) a slot is off by far more than the
    tolerance."""
    s, pos, t, window, ns = CASES[case]
    q, k, v = _inputs(s, t, "float32")
    mutant = dense_chunked(q, k, v, pos, window=window, num_splits=ns,
                           drop_last=True)
    want = _oracle(q, k, v, pos, window)
    assert np.abs(mutant.numpy() - want).max() > 100 * TOL["float32"]


@pytest.mark.parametrize("ns", [2, 4, 8])
def test_whole_chunk_splits_equal_the_single_pass_bitwise(ns):
    """At S = 2048, S / ns is a multiple of the chunk for ns = 2, 4, 8:
    the split-K grid is the single pass's chunks in the same order, so the
    outputs are bitwise equal (as the kernel's, checked on the card)."""
    s = 2048
    assert (s // ns) % L == 0
    assert decode_chunks(s, 1, ns)[2] == decode_chunks(s, 1, 1)[2]
    q, k, v = _inputs(s, 1, "float32", seed=4)
    pos = [-1, L - 1, 1500, s - 1]
    one = dense_chunked(q, k, v, pos, window=300)
    assert torch.equal(dense_chunked(q, k, v, pos, window=300,
                                     num_splits=ns), one)


def test_splits_inside_a_chunk_change_the_grid():
    """The bitwise claim needs whole-chunk splits: at S = 768 and 2 splits
    the split boundary 384 cuts chunk [256, 512) in two."""
    ranges = [r for r in decode_chunks(768, 1, 2)[2] if r[0] < r[1]]
    assert ranges == [(0, 256), (256, 384), (384, 512), (512, 768)]


def test_slot_output_alone_equals_in_batch_bitwise():
    """A slot's chunks and merge order depend on its own position only."""
    s, pos, t, window, ns = CASES["s520_splits2"]
    q, k, v = _inputs(s, t, "float32")
    batch = dense_chunked(q, k, v, pos, window=window, num_splits=ns)
    alone = dense_chunked(q[3:], k[3:], v[3:], pos[3:], window=window,
                          num_splits=ns)
    assert torch.equal(alone[0], batch[3])


@pytest.mark.parametrize("s", [256, 520, 768, 8192])
@pytest.mark.parametrize("ns", [1, 2, 4, 8])
def test_dense_chunks_tile_the_key_axis(s, ns):
    """Chunks of one-token pages: 256 keys, each inside one split, ending
    at a multiple of 256, at a split boundary or at S; the live ones cover
    [0, S) once, in order."""
    chunk, cps, ranges = decode_chunks(s, 1, ns)
    assert chunk == L and len(ranges) == ns * cps
    live = [(lo, hi) for lo, hi in ranges if lo < hi]
    assert live[0][0] == 0 and live[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(live, live[1:]))
    for z, (lo, hi) in enumerate(ranges):
        if lo < hi:
            assert lo // (s // ns) == (hi - 1) // (s // ns) == z // cps
            assert hi - lo <= L and (hi % L == 0 or hi % (s // ns) == 0)


def test_working_ctas_at_the_chip_shape():
    """The card's dense shape (8192 positions, 8 KV heads) at pos
    [-1, 1000, 4200, 8191]: 424 of 1024 CTAs do work, as for the paged
    pool, single pass and at 2 splits alike; the wave engine's short cache
    (max_len 256) is one chunk per slot."""
    for ns in (1, 2):
        _, _, ranges = decode_chunks(8192, 1, ns)
        work = sum(lo <= p for p in (1000, 4200, 8191) for lo, hi in ranges
                   if lo < hi)
        assert (8 * work, 8 * 4 * len(ranges)) == (424, 1024)
    assert decode_chunks(256, 1, 1) == (L, 1, ((0, 256),))
