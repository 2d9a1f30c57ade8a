"""The chunked decode kernel's 1-byte branch (int8 and fp8 e4m3 pools), on
the CPU.

``csrc/chunked_decode.cuh`` runs the score dot and PV on a 1-byte pool's
codes (``attention_common.cuh``: ``int8x4_codes``, a byte permute under a
magic exponent, and ``fp8x4_codes``, e4m3 -> f16 -> f32 a 16-bit pair at
a time), applies the scales once per key and row, and cuts the key axis
into the chunks of every dtype (``CHUNK_KEYS``).  Here:

- each conversion, modelled on 32-bit words with the kernel's byte
  permutes and halves in torch integer ops, gives exactly torch's int8 ->
  f32 and float8_e4m3fn -> f32 for every code (fp8: all but the NaNs,
  subnormals and signs included); without int8's sign flip, or with
  fp8's two halves swapped, it fails;
- the chunk model of ``tests/test_torch_paged_decode_chunks.py`` in the
  kernel's order, over several 1-byte chunks per slot, holds to the JAX
  package's quantized oracle; a slot alone equals the slot in a batch and
  split-K at whole chunks equals the single pass, bitwise;
- the row tiles' CTAs write disjoint scratch rows and count their
  tickets over several chunks of a 1-byte pool, and the wrappers hand the
  kernel f32's grid for a 1-byte pool on a fake card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    CHUNK_KEYS, decode_chunks, row_tiles)
from test_torch_paged_decode_chunks import TOL, chunked_decode  # noqa: E402
from test_torch_row_tiles import tiled_decode  # noqa: E402

L = CHUNK_KEYS
B, KV, G, D, PAGE = 4, 2, 2, 16, 8
S = 2 * L + L // 2  # three 1-byte chunks per slot, the last half full
NAMES = ("int8", "fp8")


# ------------------------------------------------------------ conversions
def byte_perm(x, y, s):
    """PTX prmt (``__byte_perm``) on int64 tensors of 32-bit words: result
    byte n is byte (s >> 4 n) & 7 of the 8 bytes y:x (x's are 0-3)."""
    both = (y.to(torch.int64) << 32) | x.to(torch.int64)
    out = torch.zeros_like(both)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((both >> (8 * sel)) & 0xFF) << (8 * n)
    return out


def as_f32(bits):
    """Unsigned 32-bit words (int64) read as f32."""
    signed = (bits.to(torch.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31
    return signed.to(torch.int32).view(torch.float32)


def int8x4_codes(w):
    """attention_common.cuh's int8x4_codes on words w (int64): four f32
    codes a word, the low byte first."""
    u = w ^ 0x80808080
    magic = torch.full_like(u, 0x4B000000)
    return torch.stack([as_f32(byte_perm(u, magic, 0x7440 + i)) - 8388736.0
                        for i in range(4)], -1)


def words(codes):
    """uint8 codes (a multiple of four) as little-endian 32-bit words."""
    c = codes.to(torch.int64).reshape(-1, 4)
    return c[:, 0] | c[:, 1] << 8 | c[:, 2] << 16 | c[:, 3] << 24


def test_int8_codes_are_exact_for_every_code():
    codes = torch.arange(256, dtype=torch.int64)
    want = codes.to(torch.uint8).view(torch.int8).float()
    got = int8x4_codes(words(codes)).reshape(-1)
    assert torch.equal(got, want)
    # without the top bit's flip the code is read unsigned: 128-255 fail
    bad = torch.stack([as_f32(byte_perm(
        words(codes), torch.full((64,), 0x4B000000), 0x7440 + i))
        - 8388608.0 for i in range(4)], -1).reshape(-1)
    assert not torch.equal(bad, want) and torch.equal(bad[:128], want[:128])


def fp8x2_to_float2(x):
    """attention_common.cuh's fp8x2_to_float2 on 16-bit pairs x (int64):
    cvt.rn.f16x2.e4m3x2 (the low byte to the low half), then each half
    to f32.  Returns (low, high)."""
    def half(b):
        return b.to(torch.uint8).view(torch.float8_e4m3fn) \
            .to(torch.float16).float()
    return half(x & 0xFF), half(x >> 8 & 0xFF)


def fp8x4_codes(w, swap=False):
    """attention_common.cuh's fp8x4_codes on words w (int64): the low
    16-bit pair to f[0], f[1], the high pair to f[2], f[3]; ``swap`` takes
    the halves the other way round (the mutant)."""
    lo, hi = w & 0xFFFF, w >> 16
    if swap:
        lo, hi = hi, lo
    return torch.stack([*fp8x2_to_float2(lo), *fp8x2_to_float2(hi)], -1)


def test_fp8_codes_are_exact_for_every_code_but_nan():
    """254 codes (0x7F and 0xFF are e4m3fn's NaNs): the kernel's word of
    four codes, two cvt.rn.f16x2.e4m3x2 pairs and f16 -> f32, gives torch's
    e4m3 -> f32 of each byte in place, the 14 subnormal codes (nonzero) and
    both signs included; with the word's halves swapped it fails."""
    codes = torch.arange(256, dtype=torch.int64)
    want = codes.to(torch.uint8).view(torch.float8_e4m3fn).float()
    ok = ~torch.isnan(want)
    assert int(ok.sum()) == 254
    sub = ok & ((codes & 0x78) == 0) & ((codes & 7) != 0)
    assert int(sub.sum()) == 14 and bool((want[sub] != 0).all())
    assert bool((want[ok & (codes >= 128) & (codes != 128)] < 0).all())
    got = fp8x4_codes(words(codes)).reshape(-1)
    assert torch.equal(got[ok], want[ok])
    bad = fp8x4_codes(words(codes), swap=True).reshape(-1)
    assert not torch.equal(bad[ok], want[ok])


# ---------------------------------------------------------- the chunk model
# (positions, T, window, num_splits) over three 1-byte chunks per slot
CASES = {
    "parked": ([-1, 5, L + L // 4, S - 1], 1, 0, 1),
    "chunk_edges": ([L - 1, L, L + 1, S - 1], 1, 0, 1),
    "window_across_chunks": ([L + 100, 2 * L + 3, L - 1, S - 1], 1, 300, 1),
    "window_in_one_chunk": ([L + 100, 2 * L + 3, L // 2 + 60, S - 1], 1, 40,
                            1),
    "verify_t4": ([-1, L - 2, 2 * L, S - 4], 4, 0, 1),
    "verify_t4_window": ([L - 3, 2 * L - 1, L + L // 2, S - 4], 4, 500, 1),
    "splits2": ([L - 1, L, 2 * L - 20, S - 1], 1, 0, 2),
    "splits4": ([-1, L + 1, 2 * L + 10, S - 1], 1, 0, 4),
    "splits8_window": ([L, 95, 2 * L + L // 4, S - 1], 1, 100, 8),
}


def _quant_inputs(name, t, s=S, page=PAGE, seed=0):
    """q (B, t, H, D), a JAX-quantized pool pair with its scales (P, page,
    KV, D / 1) and a shuffled (B, s / page) table over every page but the
    null page 0, as torch tensors; the JAX arrays for the oracle."""
    max_pages = s // page
    rng = np.random.default_rng(seed)
    table = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
    q = rng.normal(size=(B, t, KV * G, D)).astype(np.float32)
    kv_np = [rng.normal(size=(B * max_pages + 1, page, KV, D))
             .astype(np.float32) for _ in (0, 1)]
    qd = jattn.KV_QUANT_DTYPES[name]
    (kq, ks), (vq, vs) = (jattn.quantize_kv(jnp.asarray(x), qd)
                          for x in kv_np)
    torch_pools = [convert.cache_from_jax(np.asarray(x))
                   for x in (kq, vq, ks, vs)]
    return (torch.from_numpy(q), *torch_pools,
            torch.from_numpy(table.astype(np.int32)), (kq, vq, ks, vs))


def _oracle(q, jpools, table, pos, window):
    want = jref.paged_decode_attention_quant_ref(
        jnp.asarray(q.numpy()).transpose(0, 2, 1, 3),
        *(x.transpose(0, 2, 1, 3) for x in jpools),
        jnp.asarray(table.numpy()), jnp.asarray(pos, jnp.int32),
        window=window)
    return np.asarray(want).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_quant_chunk_model_matches_jax_oracle(case, name):
    """The kernel's order over three chunks a slot: within the f32
    tolerance of the JAX package's quantized oracle; a parked slot is
    zero."""
    pos, t, window, ns = CASES[case]
    q, k, v, ks, vs, table, jpools = _quant_inputs(name, t)
    assert decode_chunks(S // PAGE, PAGE, ns)[0] == L
    got = chunked_decode(q, k, v, table, pos, window=window, num_splits=ns,
                         k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(),
                               _oracle(q, jpools, table, pos, window),
                               atol=TOL["float32"], rtol=TOL["float32"])
    for s, p in enumerate(pos):
        if p < 0:
            assert float(got[s].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["chunk_edges", "verify_t4", "splits2"])
def test_quant_model_dropping_the_last_chunk_fails(case):
    """The comparison bites on the 1-byte partition: without each slot's
    last live chunk a slot spanning several chunks is off by far more than
    the tolerance."""
    pos, t, window, ns = CASES[case]
    q, k, v, ks, vs, table, jpools = _quant_inputs("int8", t)
    mutant = chunked_decode(q, k, v, table, pos, window=window,
                            num_splits=ns, k_scale=ks, v_scale=vs,
                            drop_last=True)
    want = _oracle(q, jpools, table, pos, window)
    assert np.abs(mutant.numpy() - want).max() > 100 * TOL["float32"]


@pytest.mark.parametrize("name", NAMES)
def test_quant_slot_alone_and_whole_chunk_splits_are_bitwise(name):
    """A slot alone gives bitwise what it gives among four, and split-K at
    2 splits of two chunks each (whole chunks) bitwise the single pass:
    every product and scale a row sees depends on the key's position."""
    s = 4 * L
    pos = [-1, L + 7, 3 * L - 1, s - 1]
    q, k, v, ks, vs, table, _ = _quant_inputs(name, 1, s=s)
    sc = dict(k_scale=ks, v_scale=vs)
    one = chunked_decode(q, k, v, table, pos, **sc)
    alone = chunked_decode(q[3:], k, v, table[3:], pos[3:], **sc)
    assert torch.equal(alone[0], one[3])
    two = chunked_decode(q, k, v, table, pos, num_splits=2, **sc)
    assert torch.equal(two, one)


# (KV, G, T, positions, window, num_splits): qwen2.5's verify block,
# granite at one token and its split-K, on three 1-byte chunks a slot
TILE_CASES = {
    "g5_t4": (2, 5, 4, [-1, L - 2, S - 4], 0, 1),
    "g48_t1": (1, 48, 1, [L, 95, S - 1], 0, 1),
    "g48_splits2": (1, 48, 1, [L - 1, L + L // 2, S - 1], 0, 2),
}


@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_quant_tiles_write_disjoint_rows_and_count_tickets(case, page_size):
    """The row-tile model of ``tests/test_torch_row_tiles.py`` over an
    int8 pool of several chunks a slot: no two CTAs write one scratch row, every row lies in the
    (B, KV, n_chunks, G * T) scratch, and each (slot, KV head, tile)
    ticket counts the slot's working chunks."""
    kv, g, t, pos, window, ns = TILE_CASES[case]
    b, max_pages = 3, S // page_size
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(b, t, kv * g, D))
                         .astype(np.float32))
    pool = torch.zeros((b * max_pages + 1, page_size, kv, D),
                       dtype=torch.int8)
    table = torch.arange(1, b * max_pages + 1,
                         dtype=torch.int32).reshape(b, max_pages)
    tile_rows = row_tiles(g, t, 128)[0]
    _, written, tickets = tiled_decode(q, pool, pool, table, pos,
                                       window=window, num_splits=ns,
                                       tile_rows=tile_rows)
    _, _, ranges = decode_chunks(max_pages, page_size, ns)
    assert any(lo > 0 for lo, hi in ranges if lo < hi)  # several chunks
    rows = [r for rs in written.values() for r in rs]
    assert len(rows) == len(set(rows))
    assert 0 <= min(rows) and max(rows) < b * kv * len(ranges) * g * t
    n_tiles = -(-g * t // tile_rows)
    for s, p in enumerate(pos):
        lo_b = max(0, p - window + 1) if window else 0
        n_work = sum(max(lo, lo_b) < min(hi, p + t) for lo, hi in ranges) \
            if p >= 0 else 0
        assert tickets.reshape(b, kv, n_tiles)[s].eq(n_work).all()


# --------------------------------------------------- the wrappers, fake card
@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("ns", [1, 2])
def test_wrappers_hand_a_1byte_pool_the_f32_grid(ns, dtype, monkeypatch):
    """The paged decode wrappers pass a 1-byte pool f32's grid
    (``decode_chunks``: CHUNK_KEYS-key chunks, whole pages): the chunk,
    the chunks per split, and scratch of B * KV * n_chunks * G * T rows."""
    from test_torch_quant_kv import _fake_card

    monkeypatch.setattr(tdecode, "_TICKETS", {})
    lib = _fake_card(monkeypatch, 0)
    sized = []
    real = tdecode.chunk_scratch

    def scratch(rows, d, device):
        sized.append(rows)
        return real(rows, d, device)

    monkeypatch.setattr(tdecode, "chunk_scratch", scratch)
    b, kv, h, page_size = 2, 2, 4, 16
    max_pages = 4096 // page_size
    q = torch.zeros((b, 1, h, 128))
    pool = torch.zeros((5, page_size, kv, 128)).to(dtype)
    table = torch.ones((b, max_pages), dtype=torch.int32)
    scale = torch.ones((5, page_size, kv, 1))
    sc = dict(k_scale=scale, v_scale=scale.clone())
    if ns == 1:
        tpaged.paged_decode_attention_cuda(q, pool, pool.clone(), table,
                                           [3, 2000], **sc)
    else:
        tpaged.paged_decode_attention_splitk_cuda(
            q, pool, pool.clone(), table, [3, 2000], num_splits=ns, **sc)
    (_, args), = lib.calls
    chunk, cps, ranges = decode_chunks(max_pages, page_size, ns)
    assert chunk == CHUNK_KEYS
    assert args[17:19] == (chunk, cps)  # after 7 pointers, pt_stride, 9 ints
    assert sized == [b * kv * len(ranges) * (h // kv)]
