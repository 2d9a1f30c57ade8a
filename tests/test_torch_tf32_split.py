"""The many-row attention kernel's 3xTF32 arithmetic, emulated on the CPU.

The CUDA kernel (``csrc/many_row_attention.cuh``) multiplies on the tensor
cores in TF32 and keeps f32 accuracy by splitting each f32 operand into a
TF32 big part and a TF32 remainder: a.b = a_small.b_big + a_big.b_small +
a_big.b_big.  Here ``cvt.rna.tf32.f32`` is emulated with integer ops
(round to nearest, ties away from zero, on the low 13 mantissa bits), every
product of TF32 values is exact in f32, and attention computed so is held
to the f32 attention of the JAX package's oracle at the card's tolerance
(``chip_smoke.py``'s TOL for f32, 5e-5); one TF32 product alone misses it.
Inputs at phase 3c's scale: standard normal q, k, v from a seeded numpy
generator.  The kernel's tile loop is emulated too, on the flattened
(position, head) rows of its CTAs at granite's G = 48 and qwen2.5's G = 5:
a row's result is bitwise the same in whichever CTA holds it, however many
fully masked tiles that CTA walks before or after the row's own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    CTAS_PER_SM, MIN_SPLIT_KEYS, ROWS, SPLIT_COST_KEYS, TILE_KEYS, num_splits,
    row_plan)

TOL = 5e-5  # chip_smoke.py TOL[torch.float32]
B, S, H, KV, D = 1, 256, 4, 2, 128
CASES = [(True, 0), (True, 64), (False, 0)]  # (causal, window)


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, rounding the low 13
    to nearest with ties away from zero (sign-magnitude bits, so adding
    half a TF32 ulp to the bit pattern rounds the magnitude up)."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def tf32_matmul(a, b, products):
    """a @ b with TF32 operands: 3 = small.big + big.small + big.big (the
    kernel's order), 1 = big.big only.  Each term is an f32 matmul of TF32
    values, whose products are exact in f32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if products == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def attention_tf32(q, k, v, causal, window, products):
    """(B, S, H, D) attention as the kernel computes it: scores in TF32
    products, the scale after the dot, the mask selecting before the exp,
    f32 softmax, PV in TF32 products, divided by max(l, 1e-30)."""
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1)
    s = tf32_matmul(qt, kt.transpose(-1, -2), products) * D ** -0.5
    i = torch.arange(q.shape[1])[:, None]
    j = torch.arange(k.shape[1])[None, :]
    seen = torch.ones_like(i - j, dtype=torch.bool)
    if causal:
        seen &= j <= i
    if window:
        seen &= i - j < window
    s = torch.where(seen, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(seen, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = tf32_matmul(p, vt, products) / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))


def _oracle(q, k, v, causal, window):
    """f32 attention: the JAX package's oracle, in model layout."""
    out = jref.attention_ref(*(jnp.asarray(a).swapaxes(1, 2)
                               for a in (q, k, v)),
                             causal=causal, window=window)
    return np.asarray(out.swapaxes(1, 2))


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp, 1.0 + ulp / 2, -(1.0 + ulp / 2),
                      1.0 + ulp / 2 - 2.0 ** -23, 1.0 + 3 * ulp / 2, 0.0])
    want = torch.tensor([1.0, 1.0 + ulp, 1.0 + ulp, -(1.0 + ulp), 1.0,
                         1.0 + 2 * ulp, 0.0])
    assert torch.equal(tf32_rna(x), want)


def test_split_is_f32_accurate_and_exact_for_bf16():
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    big, small = split(x)
    assert torch.equal(tf32_rna(big), big) and torch.equal(tf32_rna(small),
                                                           small)
    # the remainder is rounded once more: |x - big - small| <= 2^-22 |x|
    assert bool(((x - big - small).abs() <= 2.0 ** -22 * x.abs()).all())
    assert float((x - big).abs().max()) > 0  # f32 values need the split
    xb = x.to(torch.bfloat16).float()  # bf16 is exact in TF32
    bb, bs = split(xb)
    assert torch.equal(bb, xb) and not bool(bs.any())


@pytest.mark.parametrize("causal,window", CASES)
def test_3xtf32_attention_within_f32_tolerance(causal, window):
    q, k, v = _inputs()
    got = attention_tf32(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                         window, products=3)
    want = _oracle(q, k, v, causal, window)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= TOL, err
    plain = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal, window=window)
    assert float((got - plain).abs().max()) <= TOL


@pytest.mark.parametrize("causal,window", CASES)
def test_1xtf32_attention_misses_f32_tolerance(causal, window):
    """One TF32 product keeps ~11 bits: the check on the card bites."""
    q, k, v = _inputs()
    got = attention_tf32(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                         window, products=1)
    err = float(np.abs(got.numpy() - _oracle(q, k, v, causal, window)).max())
    assert err > TOL, err


def test_bf16_operand_needs_two_products():
    """With bf16 keys the q_big . k_small term vanishes: two products give the
    three-product result bit for bit."""
    q, k, _ = (torch.from_numpy(a) for a in _inputs(2))
    qt = q[0].transpose(0, 1)  # (H, S, D)
    kt = k[0].transpose(0, 1).to(torch.bfloat16).float()
    kt = kt.repeat_interleave(H // KV, dim=0).transpose(-1, -2)
    qb, qs = split(qt)
    two = qs @ kt + qb @ kt
    assert torch.equal(two, tf32_matmul(qt, kt, 3))


@pytest.mark.parametrize("ctas,keys,want", [
    (8 * 4, 3840 + 256, 4),    # paged chunk C=256 at 3840: 32 -> 128 CTAs
    (8 * 2, 4096 + 104, 8),    # the ragged last chunk, 104 rows at 4096
    (8 * 4, 256, 1),           # the first chunk: too few keys to split
    (8 * 4, 512, 2),
    (8 * 64 * 2, 4096, 1),     # flash B=2, S=4096: 1024 CTAs fill the card
    (132, 8192, 1)])
def test_num_splits_fills_the_card(ctas, keys, want):
    """CTA counts of internlm2's grouping (G = 2: 512 rows a chunk of 256
    positions, 4 CTAs of ``ROWS`` rows per KV head)."""
    ns = num_splits(ctas, keys, 132)
    assert ns == want
    assert ctas * ns <= max(ctas, CTAS_PER_SM * 132)
    if ns < keys // MIN_SPLIT_KEYS:  # not held back by the key range:
        # one split more would pass a full wave
        assert ctas * (ns + 1) > CTAS_PER_SM * 132
    assert ROWS == 128 and CTAS_PER_SM == 1


@pytest.mark.parametrize("ctas,keys,want", [
    (96, 4096, 4),    # granite's chunk (G = 48): 3 waves of a quarter
    (80, 4096, 3),    # qwen2.5's (G = 5): 2 waves of a third
    (64, 4096, 2),    # mixtral's (G = 4): one full wave
    (128, 4096, 1)])  # qwen3-moe's (G = 16): already one wave
def test_num_splits_counts_waves(ctas, keys, want):
    """Past one wave, a split count is worth its waves: the launch's end,
    waves x (keys a split + its start and merge), is least at ``want``."""
    def end(ns):
        return -(-ctas * ns // (CTAS_PER_SM * 132)) * (keys / ns +
                                                       SPLIT_COST_KEYS)

    ns = num_splits(ctas, keys, 132)
    assert ns == want
    assert all(end(ns) < end(n) for n in range(1, keys // MIN_SPLIT_KEYS + 1)
               if n != ns)


def _tf32_sum(a, b, dim):
    """Sum over ``dim`` of the 3xTF32 products of ``a`` and ``b`` (in the
    kernel's order: small.big, big.small, big.big), each output's sum in an
    order that does not depend on the other rows."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return ((as_ * bb).sum(dim) + (ab * bs).sum(dim)) + (ab * bb).sum(dim)


def emulate_many_row(q, k, v, causal, window, q_offset, rows):
    """q (Sq, H, D) at positions ``q_offset + t`` against k/v (Sk, KV, D) as
    the kernel's CTAs compute it: each KV head's flattened rows (row r is
    position r // G, head r % G) in blocks of ``rows`` (``row_plan``), each
    block walking the ``TILE_KEYS``-key tiles of its key range, keys outside
    it zero-filled, with the mask selecting before the exp and the online
    softmax (m, l, acc) in f32."""
    sq, h, d = q.shape
    sk, kv, _ = k.shape
    g = h // kv
    out = torch.empty_like(q)
    for j in range(kv):
        qf = q[:, j * g:(j + 1) * g].reshape(sq * g, d)
        for r0, r1, kbeg, hi in row_plan(sq, g, sk, q_offset=q_offset,
                                         causal=causal, window=window,
                                         rows=rows):
            lo = max(0, q_offset + r0 // g - window + 1) if window else 0
            qpos = (q_offset + torch.arange(r0, r1) // g)[:, None]
            m = torch.full((r1 - r0,), -1e30)
            l = torch.zeros(r1 - r0)
            o = torch.zeros(r1 - r0, d)
            for k0 in range(kbeg, hi, TILE_KEYS):
                kpos = torch.arange(k0, k0 + TILE_KEYS)
                inside = (kpos >= lo) & (kpos < hi)
                kt = torch.zeros(TILE_KEYS, d)
                vt = torch.zeros(TILE_KEYS, d)
                kt[inside] = k[kpos[inside], j]
                vt[inside] = v[kpos[inside], j]
                s = _tf32_sum(qf[r0:r1, None, :], kt[None], -1) * d ** -0.5
                seen = (kpos >= lo) & (kpos <= qpos if causal else kpos < hi)
                if window:
                    seen = seen & (qpos - kpos < window)
                x = torch.where(seen, s, -1e30)
                m_new = torch.maximum(m, x.amax(dim=1))
                alpha = torch.exp(m - m_new)
                p = torch.where(seen, torch.exp(x - m_new[:, None]), 0.0)
                m = m_new
                l = l * alpha + p.sum(dim=1)
                o = o * alpha[:, None] + _tf32_sum(p[:, :, None], vt[None], 1)
            r = torch.arange(r0, r1)
            out[r // g, j * g + r % g] = o / torch.clamp(l, min=1e-30)[:, None]
    return out


# (G, causal, window, q_offset): rows of one CTA span positions inside a
# tile (G = 5: 25.6 positions a CTA; G = 48: 2.7), keys from 0 or from an
# offset (a prefill chunk), windows that start the CTAs at other tiles
G_CASES = [(5, True, 0, 0), (5, True, 40, 60), (5, False, 40, 0),
           (48, True, 0, 60), (48, True, 40, 0), (48, False, 0, 0)]
G_SQ, G_D = 100, 32


def _g_inputs(g, q_offset, seed=3):
    rng = np.random.default_rng(seed)
    kv = 2 if g == 5 else 1
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((G_SQ, g * kv, G_D), (G_SQ, kv, G_D),
                             (G_SQ, kv, G_D)))
    return q, k, v


@pytest.mark.parametrize("g,causal,window,q_offset", G_CASES)
def test_a_row_is_bitwise_the_same_in_any_cta(g, causal, window, q_offset):
    """The emulated kernel at 64, 128 and 192 rows a CTA (one, two, three
    warpgroups): other CTAs, other key ranges, the same bits in every
    row."""
    q, k, v = (torch.from_numpy(a) for a in _g_inputs(g, q_offset))
    q = q[q_offset:]
    plans = {rows: row_plan(G_SQ - q_offset, g, G_SQ, q_offset=q_offset,
                            causal=causal, window=window, rows=rows)
             for rows in (64, 128, 192)}
    # the plans differ: a row meets other leading or trailing tiles
    assert len({tuple(p[2:] for p in plan) for plan in plans.values()}) == 3
    outs = [emulate_many_row(q, k, v, causal, window, q_offset, rows)
            for rows in plans]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("g,causal,window,q_offset", G_CASES)
def test_flattened_rows_within_f32_tolerance(g, causal, window, q_offset):
    q, k, v = _g_inputs(g, q_offset)
    got = emulate_many_row(torch.from_numpy(q[q_offset:]),
                           torch.from_numpy(k), torch.from_numpy(v), causal,
                           window, q_offset, ROWS)
    want = _oracle(q[None], k[None], v[None], causal, window)[0]
    err = float(np.abs(got.numpy() - want[q_offset:]).max())
    assert err <= TOL, err
