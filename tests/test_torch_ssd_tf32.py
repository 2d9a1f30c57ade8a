"""The SSD chunk kernel's tensor-core arithmetic and its partition, on the CPU.

The CUDA kernel (``csrc/ssd_scan.cu``) multiplies on the tensor cores in
TF32 and keeps f32 accuracy with the 3xTF32 split of the many-row kernel
(``test_torch_tf32_split.py`` holds the split itself): an f32 operand is a
TF32 big part plus a TF32 remainder, and a.b = a_small.b_big + a_big.b_small
+ a_big.b_big.  Here its products are emulated on one mamba2 chunk (Q = 256,
hp = 64, ds = 128) in its order: C.B^T over 32-key tiles, each summed over
32-wide blocks of ds in fresh f32 sums; att = C.B^T * exp(cum_i - cum_j) *
dt_j, the mask selecting first, rounded to x's dtype; y and the state summed
over 32-position tiles in fresh f32 sums.  That emulation is held to the JAX
package's oracle and to ``ssd_chunk_tpu`` in interpret mode within
``chip_smoke.py``'s SSD_RTOL = 1e-5 of the largest magnitude; one TF32
product alone misses it.  bf16 operands are exact in TF32, so their products
need no split.

The partition of a chunk over CTAs (``ssd_scan.work_units``: a 64-row block
and a 64-row slice of the state per unit) is modelled for Q in {32, 96,
256}: every (i, j <= i) pair and every state term is computed exactly once,
and no 64 x 8 product lies wholly above the diagonal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_chunk as jax_ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ROW_BLOCK, STATE_SLICE, work_units)
from test_torch_tf32_split import split  # noqa: E402

SSD_RTOL = 1e-5  # chip_smoke.py SSD_RTOL
Q, HP, DS = 256, 64, 128  # mamba2-1.3b's chunk, head dim and state
TILE = 32  # keys / positions per tile (csrc TK) and ds per fresh sum
KSTEP = 8  # keys per wgmma step (k8)


def _inputs(nh, g, seed=0):
    """One chunk as ``chip_smoke._ssd_inputs`` makes it: 0.5 randn x, B, C;
    dt log-uniform in [1e-3, 1e-1]; a in [-16, -1]; cum the inclusive
    cumsum of dt * a."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((1, 1, nh, Q, HP))
    b = 0.5 * rng.standard_normal((1, 1, g, Q, DS))
    c = 0.5 * rng.standard_normal((1, 1, g, Q, DS))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (1, 1, nh, Q)))
    a = -rng.uniform(1.0, 16.0, (1, 1, nh, 1))
    cum = np.cumsum(dt * a, axis=-1)
    return tuple(v.astype(np.float32) for v in (x, b, c, dt, cum))


def _products(a, b, n):
    """a @ b in TF32 products: n = 3 is small.big + big.small + big.big
    (the kernel's order), n = 1 big.big alone.  Each term is an f32 matmul
    of TF32 values."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    if n == 1:
        return a_big @ b_big
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def ssd_emulated(x, b, c, dt, cum, products=3):
    """(y, state) as the kernel computes them, in torch f32.  ``x``, ``b``,
    ``c`` hold values of ``x.dtype`` (f32 or bf16); att is rounded to it."""
    rep = x.shape[2] // b.shape[2]
    xf = x.float()
    bf = b.float().repeat_interleave(rep, dim=2)
    cf = c.float().repeat_interleave(rep, dim=2)
    q = x.shape[3]
    cb = torch.empty(x.shape[:3] + (q, q))
    for k0 in range(0, q, TILE):  # a 32-key tile of C.B^T
        s = torch.zeros(x.shape[:3] + (q, TILE))
        for d0 in range(0, bf.shape[-1], TILE):  # 32 of ds, fresh, added
            s = s + _products(cf[..., d0:d0 + TILE],
                              bf[..., k0:k0 + TILE, d0:d0 + TILE]
                              .transpose(-1, -2), products)
        cb[..., k0:k0 + TILE] = s
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])
    seen = torch.ones((q, q), dtype=torch.bool).tril()
    att = torch.where(seen, cb * decay * dt[..., None, :], 0.0)
    att = att.to(x.dtype).float()
    w = torch.exp(cum[..., -1:] - cum) * dt
    bw = (bf * w[..., None]).transpose(-1, -2)  # (.., ds, Q)
    y = torch.zeros(x.shape[:3] + (q, x.shape[4]))
    st = torch.zeros(x.shape[:3] + (bf.shape[-1], x.shape[4]))
    for k0 in range(0, q, TILE):  # a 32-position tile, fresh, added
        y = y + _products(att[..., k0:k0 + TILE], xf[..., k0:k0 + TILE, :],
                          products)
        st = st + _products(bw[..., k0:k0 + TILE], xf[..., k0:k0 + TILE, :],
                            products)
    return y.to(x.dtype), st


def _worst(got, want):
    """Largest error of y and the state, each over SSD_RTOL x max |want|."""
    return max(float((a.float() - torch.from_numpy(np.array(w)).float())
                     .abs().max()) / (SSD_RTOL * float(np.abs(w).max()))
               for a, w in zip(got, want))


@pytest.mark.parametrize("g", [1, 2])
def test_3xtf32_ssd_chunk_within_f32_tolerance(g):
    arrs = _inputs(4, g, seed=g)
    got = ssd_emulated(*(torch.from_numpy(a) for a in arrs))
    want_ref = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in arrs))
    want_pallas = jax_ssd(*(jnp.asarray(a) for a in arrs))
    assert _worst(got, want_ref) <= 1.0
    assert _worst(got, want_pallas) <= 1.0
    plain = ops.ssd_chunk(*(torch.from_numpy(a) for a in arrs))
    assert _worst(got, tuple(p.numpy() for p in plain)) <= 1.0


@pytest.mark.parametrize("g", [1, 2])
def test_1xtf32_ssd_chunk_misses_f32_tolerance(g):
    """One TF32 product keeps ~11 bits: the check on the card bites."""
    arrs = _inputs(4, g, seed=g)
    got = ssd_emulated(*(torch.from_numpy(a) for a in arrs), products=1)
    want = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in arrs))
    assert _worst(got, want) > 1.0


def test_bf16_operands_need_no_split():
    """bf16 C, B and x, and att rounded to bf16, have no small part: C.B^T
    and att @ x are one product each, and the state (f32 B * w against
    bf16 x) two, with the three-product result bit for bit."""
    x, b, c, dt, cum = (torch.from_numpy(a) for a in _inputs(4, 1, seed=3))
    xb, bb, cb = (v.to(torch.bfloat16) for v in (x, b, c))
    for v in (xb, bb, cb):
        big, small = split(v.float())
        assert torch.equal(big, v.float()) and not bool(small.any())
    y3, st3 = ssd_emulated(xb, bb, cb, dt, cum, products=3)
    y1, _ = ssd_emulated(xb, bb, cb, dt, cum, products=1)
    assert torch.equal(y3, y1)
    # the state's A side, B * w, is f32: its small part stays
    w = torch.exp(cum[..., -1:] - cum) * dt
    bw = bb.float() * w[..., None]
    assert bool(split(bw)[1].any())
    bw_big, bw_small = split(bw.transpose(-1, -2))
    two = bw_small @ xb.float() + bw_big @ xb.float()
    assert torch.equal(two, _products(bw.transpose(-1, -2), xb.float(), 3))
    want = jref.ssd_chunk_ref(*(jnp.asarray(v.float().numpy())
                                for v in (xb, bb, cb, dt, cum)))
    assert float((st3 - torch.from_numpy(np.array(want[1]))).abs().max()) \
        <= SSD_RTOL * float(np.abs(want[1]).max())


def test_emulated_mask_selects_before_the_overflow():
    """The mask selects before anything multiplies: steep decays overflow
    exp(cum_i - cum_j) above the diagonal, and the result stays finite."""
    x, b, c, dt, cum = (torch.from_numpy(a) for a in _inputs(2, 1, seed=5))
    y, st = ssd_emulated(x, b, c, dt, cum * 100.0)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


# ----------------------------------------------------- the partition model
def _cb_base(i0, w):
    """csrc cb_base: float offset of warp w's C.B^T fragments in a row
    block at i0 (32 lanes x 4 floats per 8-key n-tile of the warps before
    it)."""
    return 128 * w * (i0 // 8 + w + 1)


def _cb_floats_max(q):
    """csrc cb_floats_max: the C.B^T region of a launch."""
    most = 0
    for i0 in range(0, q, ROW_BLOCK):
        warps = sum(1 for w in range(4) if i0 + 16 * w < q)
        most = max(most, _cb_base(i0, warps))
    return most


@pytest.mark.parametrize("q", [32, 96, 256])
@pytest.mark.parametrize("ds", [32, 96, 128])
def test_partition_covers_each_pair_and_state_term_once(q, ds):
    units = work_units(q, ds)
    pairs = np.zeros((q, q), dtype=np.int64)
    state = np.zeros((ds, q), dtype=np.int64)
    for rb, sl in units:
        if rb is not None:
            i0 = ROW_BLOCK * rb
            rows = np.arange(i0, min(i0 + ROW_BLOCK, q))
            kend = min(q, i0 + ROW_BLOCK)
            assert kend % TILE == 0
            for k0 in range(0, kend, KSTEP):  # y's 64 x 8 products
                # never wholly above the diagonal of the row block
                assert k0 <= rows[-1]
                keys = np.arange(k0, k0 + KSTEP)
                seen = keys[None, :] <= rows[:, None]  # the select
                pairs[rows[:, None], keys[None, :]] += seen
            # each warp with rows keeps the C.B^T n-tiles its rows see, in
            # its own part of its CTA's region
            cb_region = np.zeros(_cb_floats_max(q), dtype=np.int64)
            for w in range(4):
                if i0 + 16 * w >= q:
                    continue
                ntw = (i0 + 16 * w + 16) // KSTEP
                base = _cb_base(i0, w)
                cb_region[base:base + 128 * ntw] += 1
                assert (i0 + 16 * w + 15) // KSTEP < ntw  # its last row's
            assert cb_region.max() == 1  # the warps' parts do not overlap
        if sl is not None:
            s_rows = np.arange(STATE_SLICE * sl,
                               min(STATE_SLICE * sl + STATE_SLICE, ds))
            for p0 in range(0, q, TILE):  # the state: every position
                state[s_rows[:, None], np.arange(p0, p0 + TILE)[None, :]] += 1
    lower = np.tril(np.ones((q, q), dtype=np.int64))
    np.testing.assert_array_equal(pairs, lower)  # (i, j <= i) once, j > i 0
    np.testing.assert_array_equal(state, np.ones((ds, q), dtype=np.int64))
    # row blocks are issued heaviest first, and every unit has work
    blocks = [rb for rb, _ in units if rb is not None]
    assert blocks == sorted(blocks, reverse=True)
    assert all(rb is not None or sl is not None for rb, sl in units)
    assert len(units) == max(-(-q // ROW_BLOCK), -(-ds // STATE_SLICE))


def test_partition_of_mamba2_chunk():
    """At mamba2's chunk the two heaviest row blocks share their CTAs (and
    x tiles) with the two state slices; the two lightest are alone."""
    assert work_units(Q, DS) == [(3, 0), (2, 1), (1, None), (0, None)]
