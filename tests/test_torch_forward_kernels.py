"""The whole-sequence kernels' plain versions (flash attention and the SSD
chunk), on the CPU, held against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernels (interpret mode) on the
same numpy inputs.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.  Here the wrappers are checked
for refusing what the kernels do not take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_chunk as jax_ssd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.ssd_scan import ssd_chunk_cuda  # noqa: E402

# f32 on both sides; the Pallas kernel's blocked online softmax and the
# frameworks' summation orders differ by rounding only, well inside 1e-5.
ATOL = 1e-5


def _attn_inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    return q, k, v


ATTN_CASES = [  # (causal, window, H, KV)
    (True, 0, 4, 2),    # causal GQA
    (True, 6, 4, 2),    # causal, windowed
    (False, 0, 4, 4),   # bidirectional, MHA
    (False, 6, 6, 2),   # window without the causal mask, G = 3
    (True, 0, 8, 1),    # one KV head for eight query heads
]


@pytest.mark.parametrize("causal,window,h,kv", ATTN_CASES)
def test_plain_flash_attention_matches_jax(causal, window, h, kv):
    """Model layout (B,S,H,D): the plain version against the JAX oracle
    and the Pallas kernel (interpret, 16-row blocks, so the masked-block
    skip is exercised)."""
    q, k, v = _attn_inputs(2, 32, h, kv, 16, seed=h + kv + window)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    oracle = jref.attention_ref(*(jnp.asarray(a).swapaxes(1, 2)
                                  for a in (q, k, v)),
                                causal=causal, window=window).swapaxes(1, 2)
    pallas = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                       window=window, block_q=16, block_k=16)
    for want in (oracle, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=ATOL)


def test_plain_attention_ref_kernel_layout():
    """``ref.attention_ref`` in the kernel layout (B,H,S,D), Sq < Sk."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 4, 8, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, 24, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, 24, 16)).astype(np.float32)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                            window=5)
    want = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                              window=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def _ssd_inputs(g, seed, b=2, nc=3, nh=4, q=8, hp=16, ds=8):
    """Inputs the way ``ssm_forward`` makes them: softplus'd steps and the
    inclusive cumsum of dt * a (a < 0) within each chunk."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, nc, nh, q, hp)).astype(np.float32)
    bm = rng.normal(size=(b, nc, g, q, ds)).astype(np.float32)
    cm = rng.normal(size=(b, nc, g, q, ds)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, nc, nh, q)) - 1.0))
    a = -rng.uniform(1.0, 16.0, size=(nh, 1))
    cum = np.cumsum(dt * a, axis=-1)
    return x, bm, cm, dt.astype(np.float32), cum.astype(np.float32)


@pytest.mark.parametrize("g", [1, 2])
def test_plain_ssd_chunk_matches_jax(g):
    """y and the chunk states against the JAX oracle and the Pallas kernel
    (interpret); G = 2 exercises the head -> group index."""
    arrs = _ssd_inputs(g, seed=g)
    y, st = ops.ssd_chunk(*(torch.from_numpy(a) for a in arrs))
    assert y.shape == arrs[0].shape and st.dtype == torch.float32
    assert st.shape == (2, 3, 4, 8, 16)
    for wy, ws in (jref.ssd_chunk_ref(*(jnp.asarray(a) for a in arrs)),
                   jax_ssd(*(jnp.asarray(a) for a in arrs))):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(ws), atol=ATOL,
                                   rtol=ATOL)


def test_plain_ssd_chunk_never_multiplies_overflow():
    """Steep decays make exp(cum_i - cum_j) overflow above the diagonal;
    the result stays finite because the mask selects first."""
    x, bm, cm, dt, cum = _ssd_inputs(1, seed=5)
    cum = cum * 100.0  # exp(-cum_j) ~ exp(1e4) = inf for j > i
    y, st = ops.ssd_chunk(*(torch.from_numpy(a) for a in (x, bm, cm, dt,
                                                          cum)))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


def test_flash_wrapper_refuses_cpu_and_bad_shapes():
    """No hidden fallback: the wrapper never runs the plain version."""
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(1, 8, 4, 2, 128, 0))
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="Sq"):
        flash_attention_cuda(torch.cat([q, q], 1), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q[..., :16], k[..., :16], v[..., :16])
    q3 = torch.zeros((1, 8, 6, 128))
    k5 = torch.zeros((1, 8, 5, 128))
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention_cuda(q3, k5, k5)
    for qd in (torch.int8, torch.float8_e4m3fn):  # pool dtypes only
        with pytest.raises(ValueError, match="kernel takes"):
            flash_attention_cuda(q, k.to(qd), v.to(qd))
    assert flash_attention_cuda.launches == before


def test_ssd_wrapper_refuses_cpu_and_bad_shapes():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 2, 4, 32, 64)).astype(
        np.float32))
    bm = torch.zeros((1, 2, 1, 32, 32))
    dt = torch.zeros((1, 2, 4, 32))
    before = ssd_chunk_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_cuda(x, bm, bm, dt, dt)
    with pytest.raises(ValueError, match="hp = 64"):
        ssd_chunk_cuda(x[..., :16], bm, bm, dt, dt)
    with pytest.raises(ValueError, match="f32"):
        ssd_chunk_cuda(x, bm, bm, dt.double(), dt)
    for qd in (torch.int8, torch.float8_e4m3fn):  # pool dtypes only
        with pytest.raises(ValueError, match="float32/bfloat16"):
            ssd_chunk_cuda(x.to(qd), bm.to(qd), bm.to(qd), dt, dt)
    with pytest.raises(ValueError, match="do not fit"):
        ssd_chunk_cuda(x, torch.zeros((1, 2, 3, 32, 32)),
                       torch.zeros((1, 2, 3, 32, 32)), dt, dt)
    assert ssd_chunk_cuda.launches == before
