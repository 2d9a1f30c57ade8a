"""Speculative decode in the port, on the CPU, against the JAX package and
within the port: the drafter (a copy of ``repro/runtime/draft.py``), the
plain multi-row decode attention against the Pallas kernels (interpret
mode), each row of a T-row block against the one-token call at its
position (bitwise), the model's verify block against sequential decode
(bitwise: dense, paged, int8 and fp8 pools), the quantized block write
against the reference's, and the engine: greedy speculative streams
bitwise the plain engine's and equal to the JAX engine's (dense, paged,
int8), across draft depths and slot placements, stop truncation, seeded
sampled replay, rollback composed with preemption, and the configuration
checks (SSM plans, wave mode, depth, the kernels' rows per KV head).

Bitwise checks compare two routes through the port's own code on one
device, so no tolerance applies to them.  Against the JAX package the
logits differ by f32 summation order (ATOL) and the greedy tokens are
equal."""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro.kernels.decode_attention import decode_attention_tpu  # noqa: E402
from repro.kernels.paged_attention import \
    paged_decode_attention_tpu  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.runtime.draft import (DRAFTERS, NgramDrafter,  # noqa: E402
                                       get_drafter)
from repro_torch.runtime.serve import (Request, SamplingParams,  # noqa: E402
                                       ServeConfig, ServeEngine)

# logits of 2 layers and the unembedding, f32 on both sides, summed in
# other orders
ATOL = 1e-4
# the plain multi-row attention against the Pallas kernel: f32 both
# sides, the kernel's blocked online softmax against one softmax
KERNEL_TOL = 1e-5
QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _pair(kv_quant=""):
    jm, jp = tiny_lm()
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32, kv_quant=kv_quant),
            device="cpu")
    return jm, jp, tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _engine(**kw):
    _, _, tm, tp = _pair()
    return ServeEngine(tm, tp, ServeConfig(**kw))


# ------------------------------------------------------------ drafter units
def test_drafter_registry_mirrors_policies():
    assert set(DRAFTERS) == {"ngram"}
    for name in DRAFTERS:
        assert get_drafter(name).name == name
    with pytest.raises(KeyError):
        get_drafter("small-model")


def test_ngram_drafter_proposes_continuation_of_tail_match():
    d = NgramDrafter(max_n=3, min_n=1)
    ctx = np.array([5, 6, 7, 8, 5, 6, 7], np.int32)
    assert d.propose(ctx, 2).tolist() == [8, 5]
    assert d.propose(np.array([1, 2, 3, 4, 5], np.int32), 2).size == 0
    assert d.propose(np.array([1], np.int32), 4).size == 0
    assert d.propose(ctx, 0).size == 0


def test_ngram_drafter_prefers_full_continuation_and_is_pure():
    d = NgramDrafter(max_n=3, min_n=1)
    ctx = np.array([1, 2] * 5, np.int32)
    assert d.propose(ctx, 3).tolist() == [1, 2, 1]
    assert d.propose(ctx, 3).tolist() == d.propose(ctx, 3).tolist()


# -------------------------------------------------------- kernel rows
RNG = np.random.default_rng(7)


def _arr(*s):
    return RNG.normal(size=s).astype(np.float32)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("tq", [2, 4])
def test_multi_token_plain_decode_matches_pallas(window, tq):
    """The port's plain decode with a T-row block against the Pallas
    kernel in interpret mode, including windowed rows fully masked inside
    a block another row needs; a parked slot gives zeros."""
    b, kv, g, d, s = 3, 2, 2, 16, 64
    q, k, v = _arr(b, tq, kv * g, d), _arr(b, s, kv, d), _arr(b, s, kv, d)
    for pos in (np.array([0, 13, 59 - tq], np.int32),
                np.array([-1, 5, 20], np.int32)):
        want = decode_attention_tpu(
            *(jnp.asarray(a.swapaxes(1, 2)) for a in (q, k, v)),
            jnp.asarray(pos), window=window, block_k=16, interpret=True)
        got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(pos), window=window)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).swapaxes(1, 2),
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL)
        if pos[0] < 0:
            assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("window", [0, 8])
def test_multi_token_plain_paged_decode_matches_pallas(window):
    b, kv, g, d, ps, mp, tq = 3, 2, 2, 16, 8, 8, 3
    n_pages = 1 + b * mp
    kp, vp = _arr(n_pages, ps, kv, d), _arr(n_pages, ps, kv, d)
    pt = RNG.permutation(np.arange(1, n_pages))[:b * mp].reshape(
        b, mp).astype(np.int32)
    q = _arr(b, tq, kv * g, d)
    pos = np.array([-1, 7, 50], np.int32)
    want = paged_decode_attention_tpu(
        jnp.asarray(q.swapaxes(1, 2)), jnp.asarray(kp.swapaxes(1, 2)),
        jnp.asarray(vp.swapaxes(1, 2)), jnp.asarray(pt), jnp.asarray(pos),
        window=window, interpret=True)
    got = ops.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, pt)),
        torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).swapaxes(1, 2),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("layout", ["dense", "paged", "int8", "fp8"])
@pytest.mark.parametrize("window", [0, 5])
def test_block_rows_equal_one_token_calls_bitwise(layout, window):
    """Row t of a T = 4 block equals the one-token call at pos + t,
    bitwise, in the plain versions the CPU runs (the kernels are held to
    the same on the card by chip_smoke phase 4d), across a parked slot
    and positions 0, 13 and 27 (rows up to 30 of 32)."""
    b, kv, g, d, s, t, ps = 4, 2, 2, 16, 32, 4, 4
    pos = np.array([-1, 0, 13, 27], np.int32)
    q = torch.from_numpy(_arr(b, t, kv * g, d))
    if layout == "dense":
        k, v = (torch.from_numpy(_arr(b, s, kv, d)) for _ in (0, 1))

        def call(qq, p):
            return ops.decode_attention(qq, k, v, p, window=window)
    else:
        n_pages = 1 + b * (s // ps)
        table = torch.from_numpy(RNG.permutation(np.arange(1, n_pages))
                                 .reshape(b, s // ps).astype(np.int32))
        k, v = (torch.from_numpy(_arr(n_pages, ps, kv, d)) for _ in (0, 1))
        sc = {}
        if layout in QUANT:
            (k, ks), (v, vs) = (tattn.quantize_kv(x, QUANT[layout])
                                for x in (k, v))
            sc = dict(k_scale=ks, v_scale=vs)

        def call(qq, p):
            return ops.paged_decode_attention(qq, k, v, table, p,
                                              window=window, **sc)
    block = call(q, torch.from_numpy(pos))
    active = torch.from_numpy(pos >= 0)
    for i in range(t):
        one = call(q[:, i:i + 1].contiguous(), torch.from_numpy(pos + i))
        one = torch.where(active[:, None, None, None], one, 0.0)
        assert torch.equal(block[:, i:i + 1], one), i


# -------------------------------------------- model-level verify (bitwise)
B, S, T, PS = 2, 32, 3, 8


def _seq_and_spec(tm, tp, paged):
    """Sequential one-token logits (B, T, V) and the verify block's, each
    on fresh caches; the verify's caches too."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 64, size=(B, T))
    pos0 = np.array([2, 9], np.int32)
    table = torch.arange(1, 1 + B * (S // PS), dtype=torch.int32).reshape(
        B, S // PS)
    n_pages = 1 + B * (S // PS)
    if paged:
        fresh = functools.partial(tm.init_cache_paged, n_pages, PS)
        dec = functools.partial(tm.decode_step_paged, page_idx=table,
                                page_size=PS)
        spec = functools.partial(tm.decode_step_spec_paged, page_idx=table,
                                 page_size=PS)
    else:
        fresh = functools.partial(tm.init_cache, B, S)
        dec, spec = tm.decode_step, tm.decode_step_spec
    caches = fresh()
    seq = []
    for t in range(T):
        lg, caches = dec(tp, caches, torch.from_numpy(toks[:, t:t + 1]),
                         pos0 + t)
        seq.append(lg)
    got, spec_caches = spec(tp, fresh(), torch.from_numpy(toks), pos0)
    return toks, pos0, table, torch.stack(seq, dim=1), got, caches, \
        spec_caches


@pytest.mark.parametrize("layout", ["dense", "paged", "int8", "fp8"])
def test_verify_step_logits_bitwise_equal_sequential_decode(layout):
    """One verify block gives, row by row, the exact f32 logits of
    sequential one-token decode at the same positions, and the same cache
    contents; the paged f32 route equals the dense one."""
    jm, jp, tm, tp = _pair(layout if layout in QUANT else "")
    paged = layout != "dense"
    _, _, _, seq, got, caches, spec_caches = _seq_and_spec(tm, tp, paged)
    assert got.shape == (B, T, 64) and got.dtype == torch.float32
    assert torch.equal(got, seq)
    for key, leaf in caches["stack"].items():
        assert torch.equal(leaf.view(torch.uint8) if leaf.element_size() == 1
                           else leaf,
                           spec_caches["stack"][key].view(torch.uint8)
                           if leaf.element_size() == 1
                           else spec_caches["stack"][key]), key
    if layout == "paged":
        _, _, _, dense, *_ = _seq_and_spec(tm, tp, False)
        assert torch.equal(seq, dense)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_logits_match_jax(paged):
    jm, jp, tm, tp = _pair()
    toks, pos0, table, _, got, _, _ = _seq_and_spec(tm, tp, paged)
    if paged:
        want, _ = jm.decode_step_spec_paged(
            jp, jm.init_cache_paged(1 + B * (S // PS), PS),
            jnp.asarray(toks, jnp.int32), jnp.asarray(pos0),
            jnp.asarray(table.numpy()), page_size=PS)
    else:
        want, _ = jm.decode_step_spec(jp, jm.init_cache(B, S),
                                      jnp.asarray(toks, jnp.int32),
                                      jnp.asarray(pos0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_verify_block_quant_write_matches_jax_bitwise(name):
    """``paged_cache_update_multi_quant``: a parked slot's rows and rows
    past the slot's mapped span go to the null page, values and scales;
    the rest land in the mapped pages, bitwise the reference's."""
    ps, mp, t = 4, 4, 3
    table = np.array([[3, 5, 0, 0], [7, 2, 9, 1], [4, 6, 0, 0]], np.int32)
    pos = np.array([-1, 14, 6], np.int32)  # slot 2's rows 8, 9 unmapped
    rng = np.random.default_rng(4)
    new = [rng.normal(size=(3, t, 2, 8)).astype(np.float32) for _ in (0, 1)]
    shape = (10, ps, 2, 8)
    jq = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[name]
    jpools = [jnp.zeros(shape, jq) for _ in (0, 1)] + \
        [jnp.zeros(shape[:-1] + (1,), jnp.float32) for _ in (0, 1)]
    tpools = [torch.zeros(shape, dtype=QUANT[name]) for _ in (0, 1)] + \
        [torch.zeros(shape[:-1] + (1,)) for _ in (0, 1)]
    jpools = jattn.paged_cache_update_multi_quant(
        *jpools, *(jnp.asarray(a) for a in new), jnp.asarray(pos),
        jnp.asarray(table), ps)
    tattn.paged_cache_update_multi_quant(
        *tpools, *(torch.from_numpy(a) for a in new), pos,
        torch.from_numpy(table), ps)
    for tpl, jpl in zip(tpools, jpools):
        want = np.asarray(jpl)
        if want.dtype.name == "float8_e4m3fn":  # no numpy arithmetic
            want = want.view(np.uint8)
        got = convert.paged_cache_to_numpy({"x": tpl})["x"]
        np.testing.assert_array_equal(got, want)
    # slot 1's rows 14, 15 (block 3: page 1) and 16 (past its span: the
    # null page); slot 2's rows 6, 7 (page 6) and 8 (unmapped: null page)
    landed = sorted({tuple(x) for x in (tpools[2].abs().sum(dim=(2, 3)) > 0)
                     .nonzero()[:, :1].tolist()})
    assert landed == [(0,), (1,), (6,)]


# -------------------------------------------------- configuration checks
def test_spec_decode_rejected_for_ssm_plans_and_bad_configs():
    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                              vocab_size=64)
    ssm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    params = ssm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="speculative"):
        ServeEngine(ssm, params, ServeConfig(batch_slots=1, max_len=32,
                                             draft_k=2))
    with pytest.raises(ValueError, match="continuous"):
        _engine(batch_slots=1, max_len=32, mode="wave", draft_k=2)
    with pytest.raises(ValueError):
        _engine(batch_slots=1, max_len=32, draft_k=-1)
    with pytest.raises(ValueError, match="too deep"):
        _engine(batch_slots=1, max_len=8, draft_k=8)


def test_verify_block_rows_checked_against_the_kernels_on_the_card():
    """The decode kernels take any G * (draft_k + 1) query rows per KV head
    (past the 16-row instance in row tiles), so on the card as on the CPU
    internlm2 (G = 2) takes draft_k = 7 (16 rows) and draft_k = 8 (18 rows,
    three tiles), and only the reference's own limit, max_len, refuses."""
    cfg = get_config("internlm2-1.8b")
    for device in ("cuda", "cpu"):
        model = types.SimpleNamespace(cfg=cfg, device=torch.device(device),
                                      supports_speculative=lambda: True)
        for draft_k in (7, 8):
            tserve._check_speculative(ServeConfig(max_len=64,
                                                  draft_k=draft_k), model)
        with pytest.raises(ValueError, match="too deep"):
            tserve._check_speculative(ServeConfig(max_len=9, draft_k=8),
                                      model)


# --------------------------------------------------- engine level (greedy)
def _trace(seed, n, max_new=10, vocab=64):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(1, 7)))
             .astype(np.int32), max_new) for _ in range(n)]


def _serve(eng, trace, sampling=None, req_cls=Request):
    for i, (prompt, max_new) in enumerate(trace):
        kw = {} if sampling is None else {"sampling": sampling}
        eng.submit(req_cls(i, prompt.copy(), max_new_tokens=max_new, **kw))
    return {r.req_id: r.output for r in eng.run()}


_BASE = {}


def _baseline(trace_seed, n, max_new=10, kv_dtype=""):
    key = (trace_seed, n, max_new, kv_dtype)
    if key not in _BASE:
        kw = ({"cache": "paged", "page_size": 8, "kv_dtype": kv_dtype}
              if kv_dtype else {})
        _BASE[key] = _serve(_engine(batch_slots=2, max_len=64, **kw),
                            _trace(trace_seed, n, max_new))
    return _BASE[key]


@pytest.mark.parametrize("cache_kw", [
    {}, {"cache": "paged", "page_size": 8},
    {"cache": "paged", "page_size": 8, "kv_dtype": "int8"},
    {"cache": "paged", "page_size": 8, "kv_dtype": "fp8"},
], ids=["dense", "paged", "int8", "fp8"])
@pytest.mark.parametrize("k", [1, 3])
def test_greedy_spec_engine_bitwise_matches_baseline(cache_kw, k):
    """Greedy speculative streams are bitwise the plain engine's, dense,
    paged and on int8 and fp8 pools, across draft depths, and the engine
    did speculate."""
    base = _baseline(0, 5, kv_dtype=cache_kw.get("kv_dtype", ""))
    eng = _engine(batch_slots=2, max_len=64, draft_k=k, **cache_kw)
    assert _serve(eng, _trace(0, 5)) == base
    st = eng.spec_stats()
    assert st["proposed"] > 0 and st["spec_ticks"] > 0
    assert 0.0 <= st["acceptance_rate"] <= 1.0
    assert st["tokens_per_tick"] >= 1.0
    assert eng.tm.registry.value("engine_spec_ticks", replica="0") \
        == st["spec_ticks"]


def test_greedy_spec_streams_equal_jax_engines():
    """The port's speculative streams equal the JAX engine's, plain and
    speculative (dense; paged with k = 3)."""
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine

    jm, jp, _, _ = _pair()
    trace = _trace(0, 5)
    want = _serve(JServeEngine(jm, jp, JServeConfig(batch_slots=2,
                                                    max_len=64, draft_k=3)),
                  trace, req_cls=JRequest)
    assert want == _serve(JServeEngine(jm, jp, JServeConfig(
        batch_slots=2, max_len=64)), trace, req_cls=JRequest)
    for kw in ({}, {"cache": "paged", "page_size": 8}):
        assert _serve(_engine(batch_slots=2, max_len=64, draft_k=3, **kw),
                      trace) == want


def test_spec_engine_bitwise_across_slot_placements():
    trace = _trace(4, 3, max_new=8)
    base = _baseline(4, 3, max_new=8)
    for slots in (1, 3):
        eng = _engine(batch_slots=slots, max_len=64, draft_k=2)
        assert _serve(eng, trace) == base
    eng = _engine(batch_slots=2, max_len=64, draft_k=2)
    for i, (prompt, max_new) in reversed(list(enumerate(trace))):
        eng.submit(Request(i, prompt.copy(), max_new_tokens=max_new))
    assert {r.req_id: r.output for r in eng.run()} == base


def test_draft_cap_respects_budget_window_and_page_span():
    eng = _engine(batch_slots=1, max_len=16, draft_k=4, cache="paged",
                  page_size=8, num_pages=5)
    req = Request(0, np.arange(1, 4, dtype=np.int32), max_new_tokens=20)
    eng.submit(req)
    eng.step()
    s = next(i for i, r in enumerate(eng.active) if r is req)
    cap = eng._draft_cap(s, req)
    assert cap <= req.max_new_tokens - len(req.output) - 1
    assert int(eng.pos[s]) + 1 + cap <= eng.max_len - 1
    assert int(eng.pos[s]) + cap <= eng.kv.slot_span(s) - 1
    out = eng.run()
    assert out[0].finish_reason == "length"
    assert eng.kv.pool.in_use == 0


def test_stop_sequences_truncate_accepted_drafts():
    trace = _trace(11, 1, max_new=10)
    base = _baseline(11, 1)[0]
    assert len(base) > 3
    stop = (tuple(base[1:3]),)
    ref = _serve(_engine(batch_slots=2, max_len=64), trace,
                 SamplingParams(stop=stop))
    got = _serve(_engine(batch_slots=2, max_len=64, draft_k=3), trace,
                 SamplingParams(stop=stop))
    assert got == ref
    assert len(got[0]) < len(base)
    assert tuple(got[0][-2:]) == stop[0]


# ------------------------------------------------- engine level (sampled)
def test_seeded_sampled_spec_replays_and_equals_plain_sampled():
    """Each verify row folds its absolute position into the request's key,
    so the sampled speculative engine replays deterministically and
    equals the plain sampled engine, dense and paged."""
    trace = _trace(8, 4)
    sp = SamplingParams(temperature=1.4, top_k=8, seed=123)
    base = _serve(_engine(batch_slots=2, max_len=64), trace, sp)
    eng = _engine(batch_slots=2, max_len=64, draft_k=3)
    first = _serve(eng, trace, sp)
    again = _serve(eng, trace, sp)
    assert first == again == base
    assert eng.spec_stats()["spec_ticks"] > 0
    paged = _serve(_engine(batch_slots=2, max_len=64, draft_k=3,
                           cache="paged", page_size=8), trace, sp)
    assert paged == base


# ------------------------------------------ rollback + preemption
_WEIGHTED = dict(policy="drf-fair", tenant_weights={"gold": 3, "free": 1},
                 preempt=True, victim_policy="lowest-weight-share-first")


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=int(rng.integers(2, 6)))
            .astype(np.int32) for _ in range(n)]


def _spec_flood(eng, prompts, *, n_gold, max_new=8):
    for i in range(n_gold):
        eng.submit(Request(i, prompts[i].copy(), max_new_tokens=max_new,
                           tenant="gold"))
    eng.step()
    eng.step()
    for i in range(n_gold, len(prompts)):
        eng.submit(Request(i, prompts[i].copy(), max_new_tokens=max_new,
                           tenant="free"))
    return {r.req_id: r for r in eng.run()}


def _solo(prompts):
    solo = _engine(batch_slots=1, max_len=64, draft_k=3)
    return [solo.submit(Request(i, p.copy(), max_new_tokens=8)).result()
            .output for i, p in enumerate(prompts)]


def test_paged_rollback_then_preempt_refcount_balanced_and_bitwise():
    prompts = _prompts(9, seed=3)
    ref = _solo(prompts)
    eng = _engine(batch_slots=4, max_len=64, cache="paged", page_size=8,
                  prefix_cache=False, draft_k=3, **_WEIGHTED)
    done = _spec_flood(eng, prompts, n_gold=7)
    assert eng.scheduler.preempted_total >= 1
    assert sum(r.preempt_count for r in done.values()) >= 1
    for i in range(len(prompts)):
        assert done[i].output == ref[i], i
    assert eng.kv.pool.in_use == 0
    assert not np.any(np.asarray(eng.kv.pool.ref[1:]))
    assert not np.any(eng.kv.page_table)
    assert all(v == 0.0 for v in eng.scheduler.shares().values())


def test_dense_spec_preemption_round_trip_bitwise():
    prompts = _prompts(8, seed=6)
    ref = _solo(prompts)
    eng = _engine(batch_slots=4, max_len=64, draft_k=3, **_WEIGHTED)
    done = _spec_flood(eng, prompts, n_gold=6)
    assert eng.scheduler.preempted_total >= 1
    for i in range(len(prompts)):
        assert done[i].output == ref[i]


# ----------------------------------------------- verify launches, counted
@pytest.mark.parametrize("paged", [False, True])
def test_verify_launches_are_counted_apart(paged, monkeypatch):
    """On a fake card (the library and the device check stubbed) a T = 4
    launch adds one to the wrapper's ``launches`` and ``verify_launches``,
    a T = 1 launch to ``launches`` only."""
    if paged:
        from test_torch_quant_kv import _card_shaped, _fake_card

        from repro_torch.kernels import paged_attention as tpaged
        _fake_card(monkeypatch, 0)
        q, k, v, ks, vs, table = _card_shaped("int8")
        wrapper = tpaged.paged_decode_attention_cuda

        def call(qq):
            return wrapper(qq, k, v, table, [3, 5], k_scale=ks, v_scale=vs)
    else:
        from test_torch_kernels import _card_shaped, _fake_card

        from repro_torch.kernels import decode_attention as tdecode
        _fake_card(monkeypatch, 0)
        q, k, v = _card_shaped(64, 1)
        wrapper = tdecode.decode_attention_cuda

        def call(qq):
            return wrapper(qq, k, v, [3, 5])
    q4 = q.expand(-1, 4, -1, -1).contiguous()
    before = (wrapper.launches, wrapper.verify_launches)
    call(q)
    assert (wrapper.launches, wrapper.verify_launches) == \
        (before[0] + 1, before[1])
    call(q4)
    assert (wrapper.launches, wrapper.verify_launches) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("cache", [["--cache", "dense"],
                                   ["--cache", "paged", "--page-size", "8",
                                    "--kv-dtype", "int8"]])
def test_launcher_speculates_and_preempts_on_cpu(cache, capsys):
    from repro_torch.launch import serve as launcher

    done = launcher.main(["--arch", "internlm2-1.8b", "--smoke", "--device",
                          "cpu", "--requests", "4", "--max-new", "6",
                          "--speculate", "--draft-k", "2", "--preempt",
                          "--policy", "drf-fair", "--tenants", "2",
                          "--tenant-weights", "tenant-0=3,tenant-1=1",
                          *cache])
    assert len(done) == 4 and all(len(r.output) == 6 for r in done)
    out = capsys.readouterr().out
    assert "speculative: draft_k=2" in out and "preemptions:" in out
    with pytest.raises(ValueError):
        launcher.parse_tenant_weights("gold=0")
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "internlm2-1.8b", "--smoke", "--device",
                       "cpu", "--kv-dtype", "int8"])  # needs --cache paged
