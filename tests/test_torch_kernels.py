"""The port's decode kernels, plain versions on the CPU, held against the
JAX package's Pallas kernels (interpret mode) on the same numpy inputs.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.  Here the wrappers are checked
for refusing what the kernels do not take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_splitk_cuda)

B, KV, D, S = 4, 2, 16, 64
POS = np.array([-1, 5, 40, S - 1], np.int32)  # parked, ragged, last row

# f32: both sides compute in f32 with different summation orders and the
# Pallas kernel's blocked online softmax; 1e-5 covers that reordering.
# bf16: the Pallas kernel rounds p to bf16 before PV while the plain
# version keeps f32, and the bf16 output itself carries ~3 significant
# digits; 2e-2 covers that.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(g, t, dtype, seed=0):
    rng = np.random.default_rng(seed)
    h = KV * g
    q = rng.normal(size=(B, t, h, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a, jdt) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    return jx, tx


CASES = [(1, 1), (1, 2), (1, 4), (3, 1)]  # (T, num_splits); split-K at T=1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("t,ns", CASES)
def test_plain_decode_matches_pallas(t, ns, window, g, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(g, t, dtype)
    want = jax_decode(jq, jk, jv, jnp.asarray(POS), window=window,
                      block_k=16, num_splits=ns)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(POS),
                               window=window, num_splits=ns)
    assert got.shape == (B, t, KV * g, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert float(got[0].abs().max()) == 0.0  # parked slot writes zeros


@pytest.mark.parametrize("ns", [2, 4, 8])
def test_splitk_plain_version_equals_single_pass(ns):
    """The two-phase combine reproduces the single softmax (f32 rounding
    only), including a slot whose live prefix fits in the first split."""
    _, (tq, tk, tv) = _inputs(2, 1, "float32", seed=3)
    pos = torch.tensor([0, 7, 33, S - 1])
    qt, kt, vt = (x.transpose(1, 2) for x in (tq, tk, tv))
    one = ref.decode_attention_ref(qt, kt, vt, pos, window=24)
    split = ref.decode_attention_splitk_ref(qt, kt, vt, pos, window=24,
                                            num_splits=ns)
    torch.testing.assert_close(split, one, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("t,ns", [(1, 4), (3, 2)])
def test_plain_dispatch_splits_only_single_token(t, ns):
    """``decode_attention_plain`` (the CPU branch of the dispatch, and what
    the on-card checks compare the kernels with) takes split-K only at
    T = 1; T > 1 runs the single pass, as the reference does."""
    _, (tq, tk, tv) = _inputs(2, t, "float32", seed=5)
    pos = torch.from_numpy(POS)
    got = ops.decode_attention_plain(tq, tk, tv, pos, window=24,
                                     num_splits=ns)
    qt, kt, vt = (x.transpose(1, 2) for x in (tq, tk, tv))
    if t == 1:
        want = ref.decode_attention_splitk_ref(qt, kt, vt, pos, window=24,
                                               num_splits=ns)
    else:
        want = ref.decode_attention_ref(qt, kt, vt, pos, window=24)
    assert torch.equal(got, want.transpose(1, 2))
    assert torch.equal(ops.decode_attention(tq, tk, tv, pos, window=24,
                                            num_splits=ns), got)


def test_explicit_active_gates_slots():
    _, (tq, tk, tv) = _inputs(1, 1, "float32")
    pos = torch.tensor([3, 5, 40, S - 1])
    active = torch.tensor([1, 0, 1, 0])
    out = ops.decode_attention(tq, tk, tv, pos, active=active)
    full = ops.decode_attention(tq, tk, tv, pos)
    assert float(out[1].abs().max()) == 0.0
    assert float(out[3].abs().max()) == 0.0
    torch.testing.assert_close(out[0], full[0])
    torch.testing.assert_close(out[2], full[2])


@pytest.mark.parametrize("fn", [decode_attention_cuda,
                                decode_attention_splitk_cuda])
def test_cuda_wrappers_refuse_cpu_tensors(fn):
    """No hidden fallback: a wrapper never runs a plain version."""
    _, (tq, tk, tv) = _inputs(1, 1, "float32")
    before = fn.launches
    with pytest.raises(ValueError):
        fn(tq, tk, tv, torch.from_numpy(POS))
    assert fn.launches == before


def test_splitk_wrapper_refuses_multi_token():
    _, (tq, tk, tv) = _inputs(1, 3, "float32")
    with pytest.raises(ValueError, match="single-token"):
        decode_attention_splitk_cuda(tq, tk, tv, 3, num_splits=2)
