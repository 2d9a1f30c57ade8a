"""The paged decode kernel's chunk partition, modelled on the CPU.

The CUDA kernel (``csrc/chunked_decode.cuh``) cuts each slot's key axis
into the chunks of ``decode_attention.decode_chunks`` (multiples of 256 keys,
rounded up to whole pages, clipped at the split-K boundaries), computes an
unnormalised (acc, m, l) per chunk with p rounded to the pool's dtype (over
a quantized pool: the dot on the codes and the scales once per key, p kept
f32), and merges the chunks in chunk order.  Here a few lines of torch do
the same on the same grid, and the result is held to the JAX package's oracle
(``repro.kernels.ref.paged_decode_attention_ref``) on seeded numpy inputs,
at the tolerances of ``tests/test_torch_paged_kernels.py``.  A model that
drops the slot's last chunk fails them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    CHUNK_KEYS, decode_chunks)

B, KV, G, D, S = 4, 2, 2, 16, 768  # three 256-key chunks per slot
L = CHUNK_KEYS
# f32: reordered f32 sums (chunks, then the merge); bf16: p rounded to
# bf16 before PV and a bf16 output (as tests/test_torch_paged_kernels.py)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NEG_INF = -1e30

# (positions, T, window, num_splits)
CASES = {
    "parked": ([-1, 5, 300, 700], 1, 0, 1),
    "chunk_edges": ([L - 1, L, L + 1, S - 1], 1, 0, 1),
    "window_starts_inside_chunk": ([300, 600, L + 1, S - 1], 1, 100, 1),
    "window_in_one_chunk": ([300, 600, L + 1, S - 1], 1, 40, 1),
    "verify_t4": ([-1, L - 2, L, S - 4], 4, 0, 1),
    "verify_t4_window": ([L - 3, 2 * L - 1, 400, S - 4], 4, 100, 1),
    "splits2": ([L - 1, L, 500, S - 1], 1, 0, 2),
    "splits4": ([-1, L + 1, 500, S - 1], 1, 0, 4),
    "splits8_shorter_than_chunk": ([L - 1, 95, 97, S - 1], 1, 0, 8),
    "splits8_window": ([L, 95, 500, S - 1], 1, 100, 8),
}


def _inputs(page_size, t, dtype, seed=0):
    """q (B, t, H, D), pools (P, page_size, KV, D) and a shuffled
    (B, max_pages) table over every page but the null page 0."""
    max_pages = S // page_size
    rng = np.random.default_rng(seed)
    table = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
    q = rng.normal(size=(B, t, KV * G, D)).astype(np.float32)
    k = rng.normal(size=(B * max_pages + 1, page_size, KV, D))
    v = rng.normal(size=(B * max_pages + 1, page_size, KV, D))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).to(tdt)
                  for a in (q, k, v))
    return tq, tk, tv, torch.from_numpy(table.astype(np.int32))


def chunked_decode(q, k_pages, v_pages, page_idx, pos, *, window=0,
                   num_splits=1, drop_last=False, k_scale=None, v_scale=None):
    """The kernel's arithmetic on its chunk grid: per live chunk the rows'
    (acc, m, l), masked keys adding exactly 0 and p rounded to the pool's
    dtype, then merged in chunk order with exp(m_i - m*) and divided by
    max(l, 1e-30); a slot with pos < 0 writes zeros.  ``drop_last`` leaves
    out each slot's last live chunk (the mutant).  With ``k_scale`` /
    ``v_scale`` (int8/fp8 pools) the kernel's order: the score is (q .
    k_code) * (k_scale * D^-1/2), PV sums (p * v_scale) * v_code, l sums
    the unscaled p, and p stays f32."""
    b, t, h, d = q.shape
    _, page_size, kv, _ = k_pages.shape
    _, _, ranges = decode_chunks(page_idx.shape[1], page_size, num_splits)
    p_dtype = v_pages.dtype
    quant = k_scale is not None
    if quant:
        k_pages, v_pages = k_pages.float(), v_pages.float()  # the codes
        ksd, vsd = (x[page_idx.long()].flatten(1, 2)[..., 0]
                    for x in (k_scale, v_scale))  # (B, S, KV)
        p_dtype = torch.float32
    kd, vd = (x[page_idx.long()].flatten(1, 2) for x in (k_pages, v_pages))
    out = torch.zeros((b, t, h, d))
    for s in range(b):
        p = int(pos[s])
        lo_b, hi_b = (max(0, p - window + 1) if window else 0), p + t
        qpos = p + torch.arange(t)
        parts = []
        for lo, hi in ranges:
            lo, hi = max(lo, lo_b), min(hi, hi_b)
            if lo >= hi or p < 0:
                continue
            keys = torch.arange(lo, hi)
            kx = kd[s, lo:hi].float().repeat_interleave(h // kv, dim=1)
            vx = vd[s, lo:hi].float().repeat_interleave(h // kv, dim=1)
            if quant:  # (q . k_code) * (k_scale * D^-1/2), per key
                kf = (ksd[s, lo:hi] * d ** -0.5).repeat_interleave(h // kv,
                                                                   dim=1)
                sc = torch.einsum("thd,nhd->thn", q[s].float(), kx) * kf.T
            else:
                sc = torch.einsum("thd,nhd->thn", q[s].float(),
                                  kx) * d ** -0.5
            mask = keys[None, :] <= qpos[:, None]
            if window:
                mask &= qpos[:, None] - keys[None, :] < window
            sc = torch.where(mask[:, None], sc, NEG_INF)
            m = sc.amax(-1)
            e = torch.where(mask[:, None], torch.exp(sc - m[..., None]), 0.0)
            pr = e.to(p_dtype).float()
            if quant:  # p * v_scale, per key and row
                pr = pr * vsd[s, lo:hi].repeat_interleave(h // kv, dim=1).T
            parts.append((torch.einsum("thn,nhd->thd", pr, vx), m,
                          e.sum(-1)))
        if drop_last:
            parts = parts[:-1]
        if not parts:
            continue
        m_star = torch.stack([m for _, m, _ in parts]).amax(0)
        num, den = 0.0, 0.0
        for acc, m, l in parts:
            alpha = torch.exp(m - m_star)
            num = num + acc * alpha[..., None]
            den = den + l * alpha
        out[s] = num / torch.clamp(den, min=1e-30)[..., None]
    return out.to(q.dtype)


def _oracle(q, k, v, table, pos, window):
    """The JAX oracle in its kernel layout, back in the model layout."""
    j = [jnp.asarray(x.float().numpy(), jnp.float32) for x in (q, k, v)]
    want = jref.paged_decode_attention_ref(
        j[0].transpose(0, 2, 1, 3), j[1].transpose(0, 2, 1, 3),
        j[2].transpose(0, 2, 1, 3), jnp.asarray(table.numpy()),
        jnp.asarray(pos, jnp.int32), window=window)
    return np.asarray(want).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page_size", [4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_model_matches_jax_oracle(case, page_size, dtype):
    pos, t, window, ns = CASES[case]
    q, k, v, table = _inputs(page_size, t, dtype)
    got = chunked_decode(q, k, v, table, pos, window=window, num_splits=ns)
    assert got.shape == (B, t, KV * G, D) and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               _oracle(q, k, v, table, pos, window),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for s, p in enumerate(pos):
        if p < 0:
            assert float(got[s].abs().max()) == 0.0  # a parked slot


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_model_on_quantized_pools_matches_jax_oracle(case, name):
    """1-byte pools: the kernel's ring tiles hold 64 keys instead of 16 or
    32, but tiles lie inside a chunk and the chunk grid takes no dtype, so
    the partition is the one above.  Over int8/fp8 pools quantized by the
    JAX package, the dot on the codes, the scales once per key and p kept
    f32, the model holds to the JAX quantized oracle at the f32 tolerance
    (tests/test_torch_quant_decode.py runs it over three chunks a
    slot)."""
    pos, t, window, ns = CASES[case]
    q, k, v, table = _inputs(8, t, "float32")
    qd = jattn.KV_QUANT_DTYPES[name]
    (kq, ks), (vq, vs) = (jattn.quantize_kv(jnp.asarray(x.numpy()), qd)
                          for x in (k, v))
    tk, tv, tks, tvs = (convert.cache_from_jax(np.asarray(x))
                        for x in (kq, vq, ks, vs))
    got = chunked_decode(q, tk, tv, table, pos, window=window,
                         num_splits=ns, k_scale=tks, v_scale=tvs)
    want = jref.paged_decode_attention_quant_ref(
        jnp.asarray(q.numpy()).transpose(0, 2, 1, 3),
        *(x.transpose(0, 2, 1, 3) for x in (kq, vq, ks, vs)),
        jnp.asarray(table.numpy()), jnp.asarray(pos, jnp.int32),
        window=window)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 2, 1, 3),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("case", ["chunk_edges", "verify_t4", "splits2",
                                  "splits8_shorter_than_chunk"])
def test_model_dropping_the_last_chunk_fails(case):
    """The oracle comparison bites on the partition: leave out each slot's
    last live chunk and a slot spanning several chunks is off by far more
    than the tolerance."""
    pos, t, window, ns = CASES[case]
    q, k, v, table = _inputs(8, t, "float32")
    want = _oracle(q, k, v, table, pos, window)
    mutant = chunked_decode(q, k, v, table, pos, window=window,
                            num_splits=ns, drop_last=True)
    assert np.abs(mutant.numpy() - want).max() > 100 * TOL["float32"]


def test_slot_output_alone_equals_in_batch_bitwise():
    """Chunks and merge order depend on a slot's own position only, so the
    last slot alone gives bitwise the output it gives among four."""
    pos, t, window, ns = CASES["splits2"]
    q, k, v, table = _inputs(4, t, "float32")
    batch = chunked_decode(q, k, v, table, pos, window=window, num_splits=ns)
    alone = chunked_decode(q[3:], k, v, table[3:], pos[3:], window=window,
                           num_splits=ns)
    assert torch.equal(alone[0], batch[3])


@pytest.mark.parametrize("page_size", [4, 8, 16, 48])
@pytest.mark.parametrize("ns", [1, 2, 4, 8])
def test_chunks_tile_the_key_axis(page_size, ns):
    """The chunks cover every key once, in order; each is whole pages,
    lies in one split and ends at a multiple of the chunk or of the split
    length; the chunk is CHUNK_KEYS rounded up to whole pages."""
    max_pages = 192
    chunk, cps, ranges = decode_chunks(max_pages, page_size, ns)
    assert chunk % page_size == 0 and chunk - page_size < L <= chunk
    split = max_pages * page_size // ns
    live = [(lo, hi) for lo, hi in ranges if lo < hi]
    assert live[0][0] == 0 and live[-1][1] == max_pages * page_size
    assert all(a[1] == b[0] for a, b in zip(live, live[1:]))
    assert len(ranges) == ns * cps
    for z, (lo, hi) in enumerate(ranges):
        if lo >= hi:
            continue
        assert lo % page_size == 0 and hi % page_size == 0
        assert lo // split == (hi - 1) // split == z // cps
        assert hi % chunk == 0 or hi % split == 0


def test_working_ctas_at_the_chip_shape():
    """The card's shape (16-token pages, 512 per slot, 8 KV heads) at pos
    [-1, 1000, 4200, 8191]: 424 CTAs do work, as csrc/chunked_decode.cuh
    states, single pass and at 2 splits alike (4096 is a multiple of the
    chunk)."""
    for ns in (1, 2):
        _, _, ranges = decode_chunks(512, 16, ns)
        work = sum(max(lo, 0) < min(hi, p + 1)
                   for p in (1000, 4200, 8191) for lo, hi in ranges)
        assert 8 * work == 424
