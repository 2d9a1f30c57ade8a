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
generator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    CTAS_PER_SM, MIN_SPLIT_KEYS, ROWS, num_splits)

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
    (8 * 8, 3840 + 256, 4),    # paged chunk C=256 at 3840: 64 -> 256 CTAs
    (8 * 4, 4096 + 104, 8),    # the ragged last chunk, 104 rows at 4096
    (8 * 8, 256, 1),           # the first chunk: too few keys to split
    (8 * 8, 512, 2),
    (8 * 128 * 2, 4096, 1),    # flash B=2, S=4096: 2048 CTAs fill the card
    (132, 8192, 1)])
def test_num_splits_fills_the_card(ctas, keys, want):
    ns = num_splits(ctas, keys, 132)
    assert ns == want
    assert ctas * ns <= max(ctas, CTAS_PER_SM * 132)
    if ns < keys // MIN_SPLIT_KEYS:  # not held back by the key range
        assert ctas * ns >= 132
    assert ROWS == 64
