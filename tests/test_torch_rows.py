"""granite-20b's grouping (48 query heads on one KV head) and qwen2.5-32b's
(G = 5) in the port, on the CPU, against the JAX package and within the
port.  The smoke configs cut both archs to G <= 4; here they keep their
real groupings at head dim 16 and tiny widths: ``tiny_lm("granite-20b",
num_heads=48, num_kv_heads=1)`` and ``tiny_lm("qwen2.5-32b", num_heads=10,
num_kv_heads=2)``, 2 layers, a 64-token vocab, the JAX weights carried
across with ``params_from_jax``.

On the card these groupings take the chunked decode kernel's row tiles
(G * T past its largest instance) and the many-row kernel at a G that does
not divide its 64 rows; the CPU runs the plain versions, which the kernels
are held to by ``chip_smoke.py`` (phases 3r, 11, 12).  Held here: prefill
logits and caches against JAX, greedy engine streams (dense, paged) equal
to the JAX engine's, the verify block (``draft_k = 3``) bitwise four
sequential steps, speculative streams bitwise the plain engine's, and the
plain kernels at G * T in {20, 48, 64, 192} (and the many-row kernels at
G = 5 and 48) against the Pallas kernels in interpret mode.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro.kernels.decode_attention import decode_attention_tpu  # noqa: E402
from repro.kernels.flash_attention import flash_attention_tpu  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention_tpu, paged_prefill_attention_tpu)
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.runtime.serve import (Request, ServeConfig,  # noqa: E402
                                       ServeEngine)

# f32 end to end on both sides, summed in other orders (as
# tests/test_torch_archs.py: prefill logits and caches)
ATOL = 1e-5
# the plain kernels against the Pallas kernels in interpret mode: f32 both
# sides, a blocked online softmax against one softmax
KERNEL_TOL = 1e-5
GROUPINGS = {"granite-20b": dict(num_heads=48, num_kv_heads=1),
             "qwen2.5-32b": dict(num_heads=10, num_kv_heads=2)}
ARCHS = list(GROUPINGS)
B, S, PS = 2, 64, 8


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX model, JAX params, port model, port params) at the grouping."""
    jm, jp = tiny_lm(arch, **GROUPINGS[arch])
    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=2,
                              vocab_size=64, **GROUPINGS[arch])
    assert cfg.head_dim == 16
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    return jm, jp, tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


# ------------------------------------------------------------ model level
@pytest.mark.parametrize("arch", ARCHS)
def test_grouping_prefill_logits_and_caches_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(41)
    toks = rng.integers(0, 64, size=(B, 16)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    got = convert.cache_to_numpy(tc)
    for key in ("k", "v"):
        assert got["stack"][key].shape[-2:] == (
            GROUPINGS[arch]["num_kv_heads"], 16)
        np.testing.assert_allclose(got["stack"][key],
                                   np.asarray(jc["stack"][key]), atol=ATOL,
                                   rtol=ATOL)


def _trace(seed, n, max_new=8):
    """Prompts of a repeated 5-token pattern (the n-gram drafter finds
    continuations in them) or random, 3 to 20 tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_tok = int(rng.integers(3, 21))
        if i % 2:
            prompt = np.tile(rng.integers(0, 64, size=5), 5)[:n_tok]
        else:
            prompt = rng.integers(0, 64, size=n_tok)
        out.append((prompt.astype(np.int32), max_new))
    return out


def _serve(eng, trace, req_cls=Request):
    for i, (prompt, max_new) in enumerate(trace):
        eng.submit(req_cls(i, prompt.copy(), max_new_tokens=max_new))
    return {r.req_id: list(r.output) for r in eng.run()}


LAYOUTS = {"dense": {}, "paged": {"cache": "paged", "page_size": PS}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_grouping_engine_streams_equal_jax(arch, layout):
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine

    jm, jp, tm, tp = _pair(arch)
    trace = _trace(0, 4)
    kw = dict(batch_slots=2, max_len=S, **LAYOUTS[layout])
    want = _serve(JServeEngine(jm, jp, JServeConfig(**kw)), trace,
                  req_cls=JRequest)
    assert _serve(ServeEngine(tm, tp, ServeConfig(**kw)), trace) == want


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_grouping_verify_step_bitwise_equals_sequential_decode(arch, layout):
    """``decode_step_spec(_paged)`` at draft_k = 3 (T = 4: 192 query rows
    per KV head for granite, 20 for qwen2.5) gives, row by row, the exact
    logits of four one-token steps, and the same caches."""
    _, _, tm, tp = _pair(arch)
    t = 4
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, 64, size=(B, t)))
    pos0 = np.array([5, 37], np.int32)
    if layout == "paged":
        table = torch.arange(1, 1 + B * (S // PS), dtype=torch.int32)
        table = table.reshape(B, S // PS)
        fresh = functools.partial(tm.init_cache_paged, 1 + B * (S // PS), PS)
        dec = functools.partial(tm.decode_step_paged, page_idx=table,
                                page_size=PS)
        spec = functools.partial(tm.decode_step_spec_paged, page_idx=table,
                                 page_size=PS)
    else:
        fresh = functools.partial(tm.init_cache, B, S)
        dec, spec = tm.decode_step, tm.decode_step_spec
    caches = fresh()
    seq = []
    for i in range(t):
        lg, caches = dec(tp, caches, toks[:, i:i + 1], pos0 + i)
        seq.append(lg)
    got, spec_caches = spec(tp, fresh(), toks, pos0)
    assert got.shape == (B, t, 64)
    assert torch.equal(got, torch.stack(seq, dim=1))
    for key, leaf in caches["stack"].items():
        assert torch.equal(leaf, spec_caches["stack"][key]), key


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_grouping_spec_streams_bitwise_plain_engine(arch, layout):
    _, _, tm, tp = _pair(arch)
    trace = _trace(1, 4, max_new=12)
    kw = dict(batch_slots=2, max_len=S, **LAYOUTS[layout])
    plain = _serve(ServeEngine(tm, tp, ServeConfig(**kw)), trace)
    eng = ServeEngine(tm, tp, ServeConfig(draft_k=3, **kw))
    assert _serve(eng, trace) == plain
    st = eng.spec_stats()
    assert st["spec_ticks"] > 0 and st["proposed"] > 0


# ------------------------------------------------------------ kernel level
RNG = np.random.default_rng(17)


def _arr(*s):
    return RNG.normal(size=s).astype(np.float32)


# (KV, G, T): G * T = 20 (qwen2.5's verify block), 48 (granite, one
# token), 64 (qwen3-moe's verify block), 192 (granite's verify block)
ROWS = {20: (2, 5, 4), 48: (1, 48, 1), 64: (2, 16, 4), 192: (1, 48, 4)}


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("rows", list(ROWS))
def test_plain_decode_at_many_rows_matches_pallas(rows, window):
    kv, g, t = ROWS[rows]
    b, d, s = 3, 16, 64
    q, k, v = _arr(b, t, kv * g, d), _arr(b, s, kv, d), _arr(b, s, kv, d)
    pos = np.array([-1, 13, 59 - t], np.int32)
    want = decode_attention_tpu(
        *(jnp.asarray(a.swapaxes(1, 2)) for a in (q, k, v)),
        jnp.asarray(pos), window=window, block_k=16, interpret=True)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).swapaxes(1, 2),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    assert float(got[0].abs().max()) == 0.0  # the parked slot


@pytest.mark.parametrize("rows", list(ROWS))
def test_plain_paged_decode_at_many_rows_matches_pallas(rows):
    kv, g, t = ROWS[rows]
    b, d, mp = 3, 16, 8
    n_pages = 1 + b * mp
    kp, vp = _arr(n_pages, PS, kv, d), _arr(n_pages, PS, kv, d)
    pt = RNG.permutation(np.arange(1, n_pages))[:b * mp].reshape(
        b, mp).astype(np.int32)
    q = _arr(b, t, kv * g, d)
    pos = np.array([-1, 7, 59], np.int32)
    want = paged_decode_attention_tpu(
        jnp.asarray(q.swapaxes(1, 2)), jnp.asarray(kp.swapaxes(1, 2)),
        jnp.asarray(vp.swapaxes(1, 2)), jnp.asarray(pt), jnp.asarray(pos),
        window=0, interpret=True)
    got = ops.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, pt)),
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).swapaxes(1, 2),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("kv,g", [(2, 5), (1, 48)], ids=["g5", "g48"])
def test_plain_flash_attention_at_the_grouping_matches_pallas(kv, g, window):
    """The many-row kernel's function (#6) at G = 5 and 48, which do not
    divide its 64 rows; causal, window 0 and 24, S = 80 (five Pallas
    blocks of 16, and for the kernel one whole and one part tile)."""
    b, s, d = 2, 80, 16
    q, k, v = _arr(b, s, kv * g, d), _arr(b, s, kv, d), _arr(b, s, kv, d)
    want = flash_attention_tpu(
        *(jnp.asarray(a.swapaxes(1, 2)) for a in (q, k, v)), causal=True,
        window=window, block_q=16, block_k=16, interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).swapaxes(1, 2),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("kv,g", [(2, 5), (1, 48)], ids=["g5", "g48"])
def test_plain_paged_prefill_at_the_grouping_matches_pallas(kv, g):
    """#4 at G = 5 and 48: a 13-row chunk at offset 19 of a slot's page
    row, causal."""
    d, mp, c, off = 16, 8, 13, 19
    n_pages = 1 + mp
    kp, vp = _arr(n_pages, PS, kv, d), _arr(n_pages, PS, kv, d)
    row = RNG.permutation(np.arange(1, n_pages)).astype(np.int32)
    q = _arr(1, c, kv * g, d)
    want = paged_prefill_attention_tpu(
        jnp.asarray(q.swapaxes(1, 2)), jnp.asarray(kp.swapaxes(1, 2)),
        jnp.asarray(vp.swapaxes(1, 2)), jnp.asarray(row), off,
        interpret=True)
    got = ops.paged_prefill_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp)),
        torch.from_numpy(row[None]), 0, off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).swapaxes(1, 2),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


def test_launcher_serves_granite_and_qwen25_with_speculation(capsys):
    from repro_torch.launch import serve as launch

    for arch in ARCHS:
        for extra in ([], ["--cache", "paged", "--page-size", "8"]):
            launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "4", "--speculate",
                         "--draft-k", "3", *extra])
    assert capsys.readouterr().out.count("served 3 requests") == 4
