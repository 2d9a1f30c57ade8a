"""The port's sampler (``repro_torch.runtime.sampling``) against jax 0.9's
(``repro.runtime.sampling`` and ``jax.random``, partitionable threefry),
and the sampled serving engine on the CPU.

What is held bitwise and what is not, and why:

* threefry2x32 words, ``fold_in`` keys, ``random_bits`` words and the
  uniforms in [tiny, 1): pure integer and bit operations, and one exact
  f32 subtraction, scaling and max -- bitwise.
* Gumbel noise ``-log(-log(u))``: XLA's ``log`` and torch's differ in the
  last bit, and near g = 0 the outer ``log`` cancels (``-log(u)`` close to
  1), so there the gap is thousands of ulp of g while only ~5e-7 absolute
  (4.8e-7 measured on a 92,544-wide row).  A tolerance in ulp would be
  wrong; the bound is absolute, GUMBEL_ATOL.
* Sampled tokens: argmax of gumbel + logits, equal unless the top two
  perturbed scores lie within the noise's gap; no row here has such a
  near-tie, so they are asserted equal.
* top-k/top-p masks: the top-p cumsum sums in torch's order, not XLA's, so
  a row whose exclusive mass at some rank lies within CUMSUM_ATOL of
  ``top_p`` may keep one token more or fewer; every differing row must be
  such a boundary row, and they are counted and must be rare.
* Greedy rows (temperature 0) and ``sample_tokens_multi``'s rows against
  ``sample_tokens`` at ``pos + t``: bitwise, within the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.extend.random as jrandom_ext  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro.runtime import sampling as js  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.runtime import sampling as ts  # noqa: E402
from repro_torch.runtime.serve import (Request, SamplingParams,  # noqa: E402
                                       ServeConfig, ServeEngine)

GUMBEL_ATOL = 2e-6  # XLA's log against torch's (see the module docstring)
CUMSUM_ATOL = 1e-6  # top-p boundary mass summed in another order
TINY = float(np.finfo(np.float32).tiny)


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(
        np.uint32)


def _words(x):
    return ts.as_key_words(np.asarray(x, np.uint32))


# ------------------------------------------------------------ raw words
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry2x32_words_bitwise(seed):
    rng = np.random.default_rng(seed)
    key = _keys(seed, 1)[0]
    count = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jrandom_ext.threefry_2x32(jnp.asarray(key),
                                                jnp.asarray(count)))
    k = _words(key)
    c = _words(count)
    # threefry_2x32 hashes the first and second halves as word pairs
    w1, w2 = ts.threefry2x32(k[0], k[1], c[:32], c[32:])
    got = torch.cat([w1, w2]).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fold_in_keys_bitwise(seed):
    keys = _keys(seed, 16)
    data = np.random.default_rng(seed).integers(0, 2 ** 31, 16)
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k), int(d)))
                     for k, d in zip(keys, data)])
    got = ts.fold_in(_words(keys), torch.as_tensor(data)).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("v", [1, 7, 1000, 92544])
def test_random_bits_bitwise(v):
    key = _keys(v, 1)[0]
    want = np.asarray(jax.random.bits(jnp.asarray(key), (v,), jnp.uint32))
    got = ts.random_bits(_words(key)[None], v)[0].numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("v", [7, 1000, 92544])
def test_uniform_bitwise(v):
    for key in _keys(v + 1, 3):
        want = np.asarray(jax.random.uniform(jnp.asarray(key), (v,),
                                             minval=TINY, maxval=1.0))
        got = ts.uniform(_words(key)[None], v)[0].numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gumbel_within_stated_tolerance():
    """Not bitwise (``log``): within GUMBEL_ATOL absolute, on a full
    internlm2 vocabulary row."""
    v = 92544
    worst = 0.0
    for key in _keys(5, 3):
        want = np.asarray(jax.random.gumbel(jnp.asarray(key), (v,)))
        got = ts.gumbel(_words(key)[None], v)[0].numpy()
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= GUMBEL_ATOL, worst


# ------------------------------------------------------------- sampling
def _rows(seed, b, v):
    rng = np.random.default_rng(seed)
    return dict(
        logits=(rng.normal(size=(b, v)) * 3).astype(np.float32),
        pos=rng.integers(0, 200, b).astype(np.int32),
        temp=rng.choice([0.0, 0.7, 1.0, 1.6], b).astype(np.float32),
        top_k=rng.choice([0, 1, 5, 50], b).astype(np.int32),
        top_p=rng.choice([1.0, 0.9, 0.5], b).astype(np.float32),
        keys=rng.integers(0, 2 ** 31, (b, 2)).astype(np.uint32))


@pytest.mark.parametrize("seed,b,v", [(0, 256, 64), (1, 128, 1000),
                                      (2, 16, 92544)])
def test_sample_tokens_equal_jax(seed, b, v):
    """Tokens equal, row for row: a near-tie of the two highest perturbed
    scores (within the Gumbel gap) is the only way they could differ, and
    none of these rows has one."""
    r = _rows(seed, b, v)
    want = np.asarray(js.sample_tokens(*(jnp.asarray(r[k]) for k in (
        "logits", "pos", "temp", "top_k", "top_p", "keys"))))
    got = ts.sample_tokens(torch.from_numpy(r["logits"]), r["pos"],
                           r["temp"], r["top_k"], r["top_p"],
                           r["keys"]).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_topk_topp_masks_equal_jax_except_boundary_rows():
    b, v = 512, 200
    rng = np.random.default_rng(7)
    scaled = (rng.normal(size=(b, v)) * 2).astype(np.float32)
    top_k = rng.choice([0, 3, 40], b).astype(np.int32)
    top_p = rng.uniform(0.05, 1.0, b).astype(np.float32)
    want = np.asarray(js._topk_topp_mask(jnp.asarray(scaled),
                                         jnp.asarray(top_k),
                                         jnp.asarray(top_p)))
    got = ts._topk_topp_mask(torch.from_numpy(scaled),
                             torch.from_numpy(top_k).long(),
                             torch.from_numpy(top_p)).numpy()
    differ = np.flatnonzero((got != want).any(axis=-1))
    # a differing row must have an exclusive cumulative mass within
    # CUMSUM_ATOL of its top_p (f64 here, as neither side sums)
    srt = -np.sort(-scaled.astype(np.float64), axis=-1)
    probs = np.exp(srt - srt[:, :1])
    probs /= probs.sum(axis=-1, keepdims=True)
    excl = np.cumsum(probs, axis=-1) - probs
    boundary = (np.abs(excl - top_p[:, None]) <= CUMSUM_ATOL).any(axis=-1)
    assert boundary[differ].all(), differ
    assert differ.size <= b // 100, differ.size  # rare
    assert ((got == 0) | np.isneginf(got)).all()


@pytest.mark.parametrize("v", [33, 92544])
def test_temperature_zero_is_bitwise_argmax(v):
    rng = np.random.default_rng(v)
    b = 6
    logits = torch.from_numpy((rng.normal(size=(b, v)) * 4).astype(
        np.float32))
    out = ts.sample_tokens(logits, np.arange(b), np.zeros(b, np.float32),
                           rng.integers(0, v, b), rng.uniform(0.1, 1.0, b),
                           rng.integers(0, 2 ** 31, (b, 2)).astype(
                               np.uint32))
    assert torch.equal(out, torch.argmax(logits, -1).to(torch.int32))


def test_sample_tokens_multi_rows_are_sample_tokens_at_pos_plus_t():
    rng = np.random.default_rng(0)
    b, t, v = 3, 4, 32
    logits = torch.from_numpy((rng.normal(size=(b, t, v)) * 3).astype(
        np.float32))
    pos = rng.integers(0, 20, b).astype(np.int32)
    temp = np.array([0.0, 0.9, 1.7], np.float32)  # a greedy row too
    top_k = np.array([0, 5, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.8], np.float32)
    keys = rng.integers(0, 2 ** 31, (b, 2)).astype(np.uint32)
    multi = ts.sample_tokens_multi(logits, pos, temp, top_k, top_p, keys)
    assert multi.shape == (b, t) and multi.dtype == torch.int32
    for i in range(t):
        row = ts.sample_tokens(logits[:, i], pos + i, temp, top_k, top_p,
                               keys)
        assert torch.equal(multi[:, i], row)
    assert torch.equal(multi[0], torch.argmax(logits[0], -1).to(torch.int32))
    want = np.asarray(js.sample_tokens_multi(
        jnp.asarray(logits.numpy()), jnp.asarray(pos), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(keys)))
    assert np.array_equal(multi.numpy(), want)


def test_speculative_accept_longest_confirmed_prefix():
    assert ts.speculative_accept([], [4]) == 0
    assert ts.speculative_accept([4], [4, 9]) == 1
    assert ts.speculative_accept([4, 5, 6], [4, 5, 6, 7]) == 3
    assert ts.speculative_accept([4, 5, 6], [4, 9, 6, 7]) == 1
    assert ts.speculative_accept([3], [4, 3]) == 0


def test_key_data_is_jax_prng_key():
    for seed in (0, 1, 12345, 2 ** 31 - 1, 2 ** 31 + 5):
        sp = SamplingParams(seed=seed)
        want = np.asarray(jax.random.PRNGKey(seed % 2 ** 31), np.uint32)
        assert np.array_equal(sp.key_data(0), want)
    assert np.array_equal(SamplingParams().key_data(9),
                          np.asarray(jax.random.PRNGKey(9), np.uint32))


# ----------------------------------------------------------- the engine
def _port():
    _, jp = tiny_lm()
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    return model, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _trace(seed, n, max_new=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, size=int(rng.integers(1, 7)))
             .astype(np.int32), max_new) for _ in range(n)]


def _serve(eng, trace, sampling=None, req_cls=Request):
    for i, (prompt, max_new) in enumerate(trace):
        eng.submit(req_cls(i, prompt.copy(), max_new_tokens=max_new,
                           sampling=sampling or SamplingParams()))
    return {r.req_id: r.output for r in eng.run()}


def _engine(**kw):
    model, params = _port()
    return ServeEngine(model, params, ServeConfig(**kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_temp0_engine_bitwise_matches_greedy_dense_and_paged(seed):
    """The sampled step at temperature 0 rides along on a sampled
    neighbour's tick and still gives the greedy tokens, dense and paged;
    wave mode agrees."""
    trace = _trace(seed, 5)
    greedy = _serve(_engine(batch_slots=2, max_len=32, mode="wave"), trace)
    for kw in ({}, {"cache": "paged", "page_size": 8}):
        eng = _engine(batch_slots=3, max_len=32, **kw)
        # a sampled request in the third slot makes every tick sampled
        eng.submit(Request(99, np.array([1, 2], np.int32), max_new_tokens=12,
                           sampling=SamplingParams(temperature=1.0, seed=3)))
        for i, (prompt, max_new) in enumerate(trace):
            eng.submit(Request(i, prompt.copy(), max_new_tokens=max_new,
                               sampling=SamplingParams(temperature=0.0,
                                                       top_k=3, top_p=0.5)))
        got = {r.req_id: r.output for r in eng.run()}
        got.pop(99)
        assert got == greedy


def test_topk1_sampled_equals_greedy_end_to_end():
    trace = _trace(3, 4)
    greedy = _serve(_engine(batch_slots=2, max_len=32), trace)
    forced = _serve(_engine(batch_slots=2, max_len=32), trace,
                    SamplingParams(temperature=3.0, top_k=1))
    assert greedy == forced


def test_seeded_sampling_is_deterministic_and_slot_independent():
    prompt = np.array([3, 5, 7], np.int32)
    eng = _engine(batch_slots=2, max_len=32)
    for i, seed in enumerate([11, 11, 12]):
        eng.submit(Request(i, prompt.copy(), max_new_tokens=6,
                           sampling=SamplingParams(temperature=1.5,
                                                   seed=seed)))
    outs = {r.req_id: r.output for r in eng.run()}
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]
    paged = _engine(batch_slots=2, max_len=32, cache="paged", page_size=8)
    paged.submit(Request(0, prompt.copy(), max_new_tokens=6,
                         sampling=SamplingParams(temperature=1.5, seed=11)))
    assert paged.run()[0].output == outs[0]


@pytest.mark.parametrize("kv_dtype", ["", "int8", "fp8"])
def test_wave_and_paged_serve_sampled_requests_bitwise(kv_dtype):
    """A seeded sampled trace: wave mode (drawing from the wave logits)
    equals the continuous dense engine; a paged engine (f32 pools) equals
    it too, and the quantized pools equal themselves across placements."""
    trace = _trace(9, 4)
    sp = SamplingParams(temperature=1.3, top_k=6, top_p=0.9, seed=77)
    if not kv_dtype:
        wave = _serve(_engine(batch_slots=2, max_len=32, mode="wave"),
                      trace, sp)
        dense = _serve(_engine(batch_slots=2, max_len=32), trace, sp)
        assert wave == dense
    paged = _serve(_engine(batch_slots=2, max_len=64, cache="paged",
                           page_size=8, kv_dtype=kv_dtype), trace, sp)
    serial = _serve(_engine(batch_slots=1, max_len=64, cache="paged",
                            page_size=8, kv_dtype=kv_dtype), trace, sp)
    assert paged == serial
    if not kv_dtype:
        assert paged == dense


def test_sampled_prefill_draws_first_token_like_jax():
    """The first token of a sampled request comes from the prefill's last
    real row, folded at its position (prompt_len - 1); the port's engine
    and the JAX engine draw the same first and later tokens here (the
    logits agree to ~1e-6 and no draw is a near-tie)."""
    from repro.runtime.sampling import SamplingParams as JSamplingParams
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine

    jm, jp = tiny_lm()
    trace = _trace(4, 4, max_new=6)
    config = dict(batch_slots=2, max_len=32, prefill_chunk=4)
    want = {}
    jeng = JServeEngine(jm, jp, JServeConfig(**config))
    for i, (prompt, max_new) in enumerate(trace):
        jeng.submit(JRequest(i, prompt.copy(), max_new_tokens=max_new,
                             sampling=JSamplingParams(temperature=1.2,
                                                      top_p=0.95, seed=5)))
    want = {r.req_id: r.output for r in jeng.run()}
    got = _serve(_engine(**config), trace,
                 SamplingParams(temperature=1.2, top_p=0.95, seed=5))
    assert got == want


def test_launcher_samples_on_cpu(capsys):
    """``--temperature/--top-k/--top-p/--sample-seed``: a seeded sampled run
    repeats itself."""
    from repro_torch.launch import serve as launcher

    argv = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "5", "--temperature", "0.8",
            "--top-k", "50", "--top-p", "0.9", "--sample-seed", "4"]
    first = {r.req_id: r.output for r in launcher.main(argv)}
    again = {r.req_id: r.output for r in launcher.main(argv)}
    assert first == again and all(len(o) == 5 for o in first.values())
    assert "served 3 requests, 15 tokens" in capsys.readouterr().out
