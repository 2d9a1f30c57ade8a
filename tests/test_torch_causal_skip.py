"""``RuntimeKnobs.causal_skip`` in the port: the reference's recursive
causal triangle (``_flash_causal_recursive``: the upper half of the
queries over the whole prefix, the lower half recursing on a prefix half
as long, depth 4), held against the reference's
``flash_attention_xla(causal_skip=True)`` and against the port's own
blocked attention without it, outputs and gradients, at ``q_offset`` 0
and > 0; and through the model's training route.

Tolerance: f32 both ways; the decomposition sums each row's softmax over
a shorter key range (the masked keys it drops add exact zeros), so the
sums run in other orders: within 2e-6 of the largest magnitude."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import attention as attn  # noqa: E402

RTOL = 2e-6
B, H, KV, D, QC = 2, 4, 2, 16, 8


def _inputs(sq, sk, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, sk, KV, D)).astype(np.float32)
    w = rng.normal(size=(B, sq, H, D)).astype(np.float32)
    return q, k, v, w


def _port(q, k, v, w, skip, q_offset):
    """(output, grads of sum(out * w) for q, k, v) of the port."""
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = attn.flash_attention_xla(*ts, causal=True, q_chunk=QC,
                                   q_offset=q_offset, causal_skip=skip)
    (out * torch.from_numpy(w)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _close(got, want):
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()), err


CASES = [(64, 64, 0), (32, 96, 64), (40, 40, 0)]


@pytest.mark.parametrize("sq,sk,q_offset", CASES)
def test_causal_skip_equals_the_blocked_attention(sq, sk, q_offset):
    """The recursion against the plain blocked pass over the whole prefix,
    output and the three gradients."""
    q, k, v, w = _inputs(sq, sk)
    for got, want in zip(_port(q, k, v, w, True, q_offset),
                         _port(q, k, v, w, False, q_offset)):
        _close(got, want)


@pytest.mark.parametrize("sq,sk,q_offset", CASES)
def test_causal_skip_equals_the_reference(sq, sk, q_offset):
    """The port's recursion against the reference's, output and the three
    gradients by ``jax.grad``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.attention import flash_attention_xla as jflash

    q, k, v, w = _inputs(sq, sk, seed=1)

    def loss(q_, k_, v_):
        out = jflash(q_, k_, v_, causal=True, q_chunk=QC, q_offset=q_offset,
                     causal_skip=True)
        return (out * w).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(out)] + [np.asarray(g) for g in grads]
    for got, ref in zip(_port(q, k, v, w, True, q_offset), want):
        _close(got, ref)


def test_causal_skip_applies_where_the_reference_applies_it(monkeypatch):
    """Only causal, unwindowed attention whose queries end at the last key
    recurses; a window or a query block short of the end takes the plain
    pass.  The recursion is static: 64 queries in chunks of 8 split at 32,
    16, 8 (three levels before the blocks get too short)."""
    calls = []
    real = attn._flash_causal_recursive

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], kw["q_offset"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn, "_flash_causal_recursive", spy)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(64, 64))
    attn.flash_attention_xla(q, k, v, q_chunk=QC, causal_skip=True)
    assert calls == [(64, 0), (32, 0), (16, 0)]
    calls.clear()
    attn.flash_attention_xla(q, k, v, q_chunk=QC, window=16,
                             causal_skip=True)
    attn.flash_attention_xla(q[:, :32], k, v, q_chunk=QC, causal_skip=True)
    assert calls == []


def test_causal_skip_through_the_training_route():
    """``RuntimeKnobs(causal_skip=True)`` on internlm2's smoke config:
    the loss and every gradient within the module's tolerance of the
    route without it."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, RuntimeKnobs

    cfg = get_config("internlm2-1.8b", smoke=True)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32))
    out = []
    for skip in (False, True):
        model = LM(cfg, RuntimeKnobs(q_chunk=8, causal_skip=skip),
                   device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        leaves = []
        stack = [params]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack.extend(t[k] for k in sorted(t))
            else:
                leaves.append(t.requires_grad_())
        loss, _ = model.loss(params, {"tokens": tokens})
        loss.backward()
        out.append((float(loss), [p.grad.numpy() for p in leaves]))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
    for got, want in zip(out[1][1], out[0][1]):
        _close(got, want)
