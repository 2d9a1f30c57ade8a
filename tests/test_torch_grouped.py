"""The grouped plan in the port (gemma3's local/global layers), on the CPU,
against the JAX package: the blocks' and caches' trees, prefill logits and
caches, ragged decode, chunked prefill and ``LM.loss`` on ``tiny_lm``'s
gemma3 and on an override with several inner layers per group and a
remainder stack; greedy engine streams equal to the JAX engine's (dense
continuous, wave, paged with a prefix hit, int8 paged) on prompts long
enough for the local window to bind; speculative and preempted streams
bitwise the port's plain ones; ``paged_cache_from_jax`` on grouped and
quantized pools; and, on a fake card, the
decode wrappers at the new groupings (G = 4 at T = 4 reaches the kernel
with 16 rows per KV head, G = 16 at T = 4 raises).

The engine helpers here serve the MoE archs too (``test_torch_moe.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro.runtime.serve import Request as JRequest  # noqa: E402
from repro.runtime.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.runtime.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.runtime.serve import (Request, ServeConfig,  # noqa: E402
                                       ServeEngine)

# f32 end to end on both sides (f32 caches), as test_torch_archs.py: the
# frameworks sum in other orders through a few layers and the unembedding
ATOL = 1e-5
B, S = 2, 48  # S past the gemma3 smoke config's local window of 32
GEMMA = "gemma3-27b"
# tiny_lm's 2 layers are one group (1 local + 1 global); this override
# has two groups of (2 local + 1 global) and a 1-layer remainder
DEEP = dict(num_layers=7, local_global_period=3)


def pair(arch, kv_quant="", **over):
    """(JAX model, JAX params, port model, port params): ``tiny_lm``'s
    weights carried across."""
    jm, jp = tiny_lm(arch, **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              **dict({"num_layers": 2, "vocab_size": 64},
                                     **over))
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32, kv_quant=kv_quant),
            device="cpu")
    return jm, jp, tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def assert_trees_close(got, want, atol=ATOL):
    """Port tree (converted to numpy) against a JAX tree: same keys and
    shapes, values within ``atol``."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_trees_close(got[k], want[k], atol)
        return
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)


def check_forward(arch, seed=31, s=S, **over):
    """Prefill logits and caches of ``s`` tokens, then a ragged decode step
    from those caches (slot 0 rewrites an early position, slot 1 the last
    row), and ``LM.loss`` with its metrics, against JAX."""
    jm, jp, tm, tp = pair(arch, **over)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 64, size=(B, s)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    assert_trees_close(convert.cache_to_numpy(tc), jc)
    step = rng.integers(0, 64, size=(B, 1))
    pos = np.array([9, s - 1], np.int32)
    jd, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(step, jnp.int32),
                                    jnp.asarray(pos))
    td, _ = tm.decode_step(tp, tc, torch.from_numpy(step), pos)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL,
                               rtol=ATOL)
    jloss, jmet = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks)})
    tloss, tmet = tm.loss(tp, {"tokens": toks})
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   atol=ATOL, rtol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=ATOL,
                               rtol=ATOL)
    return tmet


@pytest.mark.parametrize("over", [{}, DEEP], ids=["tiny", "deep"])
def test_grouped_forward_matches_jax(over):
    check_forward(GEMMA, **over)


@pytest.mark.parametrize("over", [{}, DEEP], ids=["tiny", "deep"])
def test_grouped_trees_are_the_references(over):
    """Blocks and dense and paged caches keep the reference's grouped
    trees, leaf for leaf: (G, P-1, ...) inner, (G, ...) outer and
    (R, ...) remainder stacks."""
    jm, jp, tm, tp = pair(GEMMA, **over)
    want = jax.tree.map(lambda a: a.shape, jp["blocks"])
    got = jax.tree.map(lambda t: tuple(t.shape), tp["blocks"])
    assert got == want
    plan = ttransformer.build_plan(tm.cfg)
    assert set(tp["blocks"]) == {"inner", "outer"} | (
        {"rem"} if plan.remainder else set())
    for make_t, make_j in ((lambda: tm.init_cache(B, S),
                            lambda: jm.init_cache(B, S)),
                           (lambda: tm.init_cache_paged(9, 8),
                            lambda: jm.init_cache_paged(9, 8))):
        tree = make_t()
        assert jax.tree.map(lambda t: tuple(t.shape), tree) == \
            jax.tree.map(lambda a: tuple(a.shape), make_j())
        assert tree["groups"]["inner"]["k"].shape[:2] == (
            plan.n_groups, plan.inner_per_group)
    # the layers run group by group, each under its plan window
    windows = [layer.window for layer in ttransformer._layers(plan, tm.cfg)]
    assert windows == [w for _ in range(plan.n_groups)
                       for w in [plan.inner_window] * plan.inner_per_group
                       + [0]] + [plan.inner_window] * plan.remainder
    assert plan.inner_window == tm.cfg.local_window > 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("over", [{}, DEEP], ids=["tiny", "deep"])
def test_grouped_prefill_chunks_then_decode_match_jax(over, paged):
    """Chunked prefill of two slots' prompts past the local window, then a
    ragged decode step, dense and paged, against JAX: chunk logits, the
    decode logits and every cache leaf."""
    jm, jp, tm, tp = pair(GEMMA, **over)
    rng = np.random.default_rng(7)
    ps, c = 8, 8
    table = np.arange(1, 1 + B * (S // ps), dtype=np.int32).reshape(B, -1)
    if paged:
        jc, tc = jm.init_cache_paged(1 + table.size, ps), \
            tm.init_cache_paged(1 + table.size, ps)
        extra = dict(page_size=ps)
        jchunk = lambda *a: jm.prefill_chunk_step_paged(  # noqa: E731
            *a, jnp.asarray(table), **extra)
        tchunk = lambda *a: tm.prefill_chunk_step_paged(  # noqa: E731
            *a, table, **extra)
        jdec = lambda *a: jm.decode_step_paged(  # noqa: E731
            *a, jnp.asarray(table), **extra)
        tdec = lambda *a: tm.decode_step_paged(*a, table,  # noqa: E731
                                               **extra)
    else:
        jc, tc = jm.init_cache(B, S), tm.init_cache(B, S)
        jchunk, tchunk = jm.prefill_chunk_step, tm.prefill_chunk_step
        jdec, tdec = jm.decode_step, tm.decode_step
    lens = (40, 24)
    for slot, n in enumerate(lens):
        toks = rng.integers(0, 64, size=(1, n)).astype(np.int32)
        for off in range(0, n, c):
            jl, jc = jchunk(jp, jc, jnp.asarray(toks[:, off:off + c]),
                            slot, off)
            tl, tc = tchunk(tp, tc, toks[:, off:off + c], slot, off)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=ATOL)
    step = rng.integers(0, 64, size=(B, 1))
    pos = np.array(lens, np.int32)
    jl, jc = jdec(jp, jc, jnp.asarray(step, jnp.int32), jnp.asarray(pos))
    tl, tc = tdec(tp, tc, torch.from_numpy(step), pos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    assert_trees_close(convert.cache_to_numpy(tc), jc)


@pytest.mark.parametrize("name", ["", "int8", "fp8"])
def test_paged_cache_from_jax_takes_grouped_pools(name):
    """JAX grouped pools (f32, or quantized with their scale leaves) carry
    across with their tree, dtypes and values; a pool dict with another
    key set raises."""
    jm, jp, tm, _ = pair(GEMMA, kv_quant=name, **DEEP)
    if name:
        from repro.models import RuntimeKnobs as JRuntimeKnobs
        from repro.models import LM as JLM

        jm = JLM(jm.cfg, JRuntimeKnobs(cache_dtype=jnp.float32,
                                       kv_quant=name))
    jpools = jm.init_cache_paged(5, 4)
    rng = np.random.default_rng(2)
    jpools = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape) * 3).astype(a.dtype),
        jpools)
    got = convert.paged_cache_from_jax(jax.tree.map(np.asarray, jpools))
    want = tm.init_cache_paged(5, 4)
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), got) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), want)
    back = convert.paged_cache_to_numpy(got)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jpools)):
        w = np.asarray(w)
        if w.dtype.name == "float8_e4m3fn":
            w = w.view(np.uint8)
        np.testing.assert_array_equal(g, w.astype(g.dtype))
    bad = jax.tree.map(np.asarray, jpools)
    bad["rem"]["extra"] = bad["rem"]["k"]
    with pytest.raises(ValueError, match="paged pools hold"):
        convert.paged_cache_from_jax(bad)


# ------------------------------------------------------------------ engines
PS = 8
ENGINE = dict(batch_slots=2, max_len=96, prefill_chunk=8)
LAYOUTS = {"dense": {}, "wave": {"mode": "wave"},
           "paged": {"cache": "paged", "page_size": PS},
           "int8": {"cache": "paged", "page_size": PS, "kv_dtype": "int8"}}


def shared_prefix_trace(n=5, shared_len=41, seed=5):
    """Every other prompt starts with one shared 41-token prefix (five
    whole pages a later request can reuse; its positions pass the gemma3
    smoke config's local window of 32), the rest are short and fresh."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 64, size=shared_len).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, 64, size=int(rng.integers(2, 6))).astype(
            np.int32)
        out.append((i, np.concatenate([shared, tail]) if i % 2 else tail))
    return out


def serve(eng, req_cls, trace, max_new=8):
    for i, prompt in trace:
        eng.submit(req_cls(i, prompt.copy(), max_new_tokens=max_new))
    done = eng.run()
    assert len(done) == len(trace)
    return {r.req_id: list(r.output) for r in done}


_JAX_STREAMS = {}


def check_engine_matches_jax(arch, layout):
    """The port's engine and the JAX engine, the same weights and the
    shared-prefix trace: equal greedy streams, and a prefix hit on a
    paged pool."""
    jm, jp, tm, tp = pair(arch)
    config = dict(ENGINE, **LAYOUTS[layout])
    key = (arch, layout)
    if key not in _JAX_STREAMS:
        jeng = JServeEngine(jm, jp, JServeConfig(**config))
        _JAX_STREAMS[key] = serve(jeng, JRequest, shared_prefix_trace())
    eng = ServeEngine(tm, tp, ServeConfig(**config))
    assert serve(eng, Request, shared_prefix_trace()) == _JAX_STREAMS[key]
    if eng.kv is not None:
        assert eng.kv.stats()["prefix_hits"] >= 1
    return eng


def check_spec_bitwise_plain(arch, layout):
    """Greedy speculative streams (draft_k = 3) bitwise the port's plain
    engine's, on the trace whose prompts repeat (the n-gram drafter finds
    continuations)."""
    _, _, tm, tp = pair(arch)
    rng = np.random.default_rng(9)
    trace = [(i, np.tile(rng.integers(0, 64, size=6).astype(np.int32), 7))
             for i in range(3)]
    config = dict(ENGINE, **LAYOUTS[layout])
    plain = serve(ServeEngine(tm, tp, ServeConfig(**config)), Request, trace,
                  max_new=12)
    eng = ServeEngine(tm, tp, ServeConfig(draft_k=3, **config))
    assert serve(eng, Request, trace, max_new=12) == plain
    assert eng.spec_stats()["spec_ticks"] > 0


def check_preemption_unchanged(arch, layout):
    """``policy="priority"`` with preemption: two high-priority requests
    arrive while low-priority ones hold both slots; every stream equals
    the run without preemption, and a paged pool keeps no page."""
    _, _, tm, tp = pair(arch)
    rng = np.random.default_rng(7)
    low = [rng.integers(0, 64, size=n).astype(np.int32) for n in (40, 35)]
    high = [rng.integers(0, 64, size=n).astype(np.int32) for n in (9, 12)]
    config = dict(ENGINE, policy="priority", **LAYOUTS[layout])
    if layout != "dense":
        config["prefix_cache"] = False

    def run(preempt):
        eng = ServeEngine(tm, tp, ServeConfig(preempt=preempt, **config))
        for i, p in enumerate(low):
            eng.submit(Request(i, p.copy(), max_new_tokens=10,
                               tenant="batch"))
        eng.step()
        eng.step()
        for i, p in enumerate(high):
            eng.submit(Request(10 + i, p.copy(), max_new_tokens=6,
                               tenant="interactive", priority=5))
        done = eng.run()
        return eng, {r.req_id: (list(r.output), r.preempt_count)
                     for r in done}

    _, want = run(False)
    eng, got = run(True)
    assert any(n for _, n in got.values())
    assert {i: o for i, (o, _) in got.items()} == \
        {i: o for i, (o, _) in want.items()}
    if eng.kv is not None:
        assert eng.kv.stats()["in_use_pages"] == 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grouped_engine_matches_jax_engine(layout):
    check_engine_matches_jax(GEMMA, layout)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_grouped_spec_engine_bitwise_plain(layout):
    check_spec_bitwise_plain(GEMMA, layout)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_grouped_preemption_streams_unchanged(layout):
    check_preemption_unchanged(GEMMA, layout)


def test_grouped_wave_reset_zeroes_every_leaf():
    """A new wave zeroes every leaf of the grouped tree, not only a
    uniform stack's."""
    _, _, tm, tp = pair(GEMMA, **DEEP)
    eng = ServeEngine(tm, tp, ServeConfig(**dict(ENGINE, mode="wave")))
    for leaf in ttransformer.tree_leaves(eng.caches):
        leaf.fill_(1.0)
    eng.submit(Request(0, np.arange(3, dtype=np.int32), max_new_tokens=1))
    eng._admit_wave()
    assert not any(leaf.any()
                   for leaf in ttransformer.tree_leaves(eng.caches))


def test_launcher_serves_the_grouped_and_moe_archs(capsys):
    from repro_torch.launch import serve as launch

    for arch in (GEMMA, "mixtral-8x7b", "qwen3-moe-235b-a22b"):
        launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "3", "--max-new", "3"])
    launch.main(["--arch", GEMMA, "--smoke", "--device", "cpu",
                 "--requests", "3", "--max-new", "3", "--cache", "paged",
                 "--page-size", "8", "--speculate"])
    assert capsys.readouterr().out.count("served 3 requests") == 4


# ------------------------------------------------- the groupings, fake card
def _fake_dense_card(monkeypatch):
    from test_torch_kernels import _fake_card

    return _fake_card(monkeypatch, 0)


def _fake_paged_card(monkeypatch):
    from test_torch_quant_kv import _fake_card

    return _fake_card(monkeypatch, 0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_four_query_heads_per_kv_head_reach_the_kernel_with_16_rows(
        paged, monkeypatch):
    """mixtral's grouping, G = 4, at the verify block's T = 4: the wrapper
    launches the chunked kernel once with H / KV * T = 16 rows per KV head
    (as many as the CUDA cores' MAX_ROWS instance holds; on the warp-mma
    route, ``decode_route``'s at G = 4, its 16-column instance in one
    tile), the scratch sized for them."""
    kv, t, d = 2, 4, 128
    q = torch.zeros((2, t, 4 * kv, d))
    if paged:
        lib = _fake_paged_card(monkeypatch)
        pool = torch.zeros((9, 8, kv, d))
        table = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
        out = tpaged.paged_decode_attention_cuda(q, pool, pool.clone(),
                                                 table, [3, 20])
    else:
        lib, scratch = _fake_dense_card(monkeypatch)
        cache = torch.zeros((2, 520, kv, d))
        out = tdecode.decode_attention_cuda(q, cache, cache.clone(), [3, 9])
        chunk, cps, ranges = tdecode.decode_chunks(520, 1, 1)
        (buf,) = scratch
        assert buf.numel() == 2 * kv * len(ranges) * 16 * (d + 2)
    (name, args), = lib.calls
    # (B, T, H, KV) follow the pointers (and, paged, the table's stride)
    assert (args[8:12] if paged else args[6:10]) == (2, t, 4 * kv, kv)
    assert out.shape == q.shape and 4 * t == tdecode.MAX_ROWS
    # the plan: instance rows, row tiles, route
    assert tdecode.decode_route(4, d, torch.float32) == "warp_mma"
    assert (args[19:22] if paged else args[15:18]) == (
        2 * tdecode.MMA_COLS, 1, tdecode.ROUTES.index("warp_mma"))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sixteen_query_heads_per_kv_head_refuse_a_4_row_block(paged,
                                                            monkeypatch):
    """qwen3-moe's grouping, G = 16: one token (16 rows) and the 4-row
    verify block (64 rows, refused no longer) both reach the kernel on the
    tensor-core route (``decode_route``), in one row tile of ``TC_ROWS``
    rows, with tickets for every (slot, KV head, tile)."""
    kv, d = 2, 128
    if paged:
        lib = _fake_paged_card(monkeypatch)
        pool = torch.zeros((9, 8, kv, d))
        table = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
        run = lambda q: tpaged.paged_decode_attention_cuda(  # noqa: E731
            q, pool, pool.clone(), table, [3, 20])
    else:
        lib, _ = _fake_dense_card(monkeypatch)
        cache = torch.zeros((2, 64, kv, d))
        run = lambda q: tdecode.decode_attention_cuda(  # noqa: E731
            q, cache, cache.clone(), [3, 9])
    tiles_at = 20 if paged else 16  # (instance rows, tiles) end here
    assert tdecode.decode_route(16, d, torch.float32) == "tensor_cores"
    run(torch.zeros((2, 1, 16 * kv, d)))
    assert len(lib.calls) == 1
    rt = tdecode.TC_ROWS
    assert lib.calls[0][1][tiles_at - 1:tiles_at + 1] == (rt, 1)
    out = run(torch.zeros((2, 4, 16 * kv, d)))
    assert len(lib.calls) == 2 and out.shape == (2, 4, 16 * kv, d)
    assert lib.calls[1][1][tiles_at - 1:tiles_at + 1] == (rt, 1)
    tickets = tdecode._TICKETS[(torch.device("cpu"), 0)]
    assert tickets.numel() >= 2 * kv and not tickets.any()


# ------------------------------------------------- the head dims, fake card
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("kind", ["decode", "splitk", "prefill", "flash"])
def test_paged_and_flash_wrappers_reach_the_library_of_each_head_dim(
        kind, d, monkeypatch):
    """The paged decode, split-K and prefill and the flash attention at
    head dims 64, 80 and 128: one launch each, through the library built
    for that head dim, with D among the entry point's arguments."""
    from repro_torch.kernels import flash_attention as tflash

    lib = _fake_paged_card(monkeypatch)
    monkeypatch.setattr(tflash, "_lib", lib.load)
    monkeypatch.setattr(tflash, "_check_device", lambda *a: None)
    kv = 2
    pool = torch.zeros((9, 8, kv, d))
    table = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    if kind == "flash":
        q = torch.zeros((2, 16, kv, d))
        out = tflash.flash_attention_cuda(q, q.clone(), q.clone())
        d_at = 9  # q, k, v, out, B, Sq, Sk, H, KV, D
    elif kind == "prefill":
        q = torch.zeros((1, 8, kv, d))
        out = tpaged.paged_prefill_attention_cuda(q, pool, pool.clone(),
                                                  table[1], 8)
        d_at = 9  # q, k, v, out, page_row, C, H, KV, page_size, D
    else:
        q = torch.zeros((2, 1, kv, d))
        fn = tpaged.paged_decode_attention_cuda if kind == "decode" else \
            functools.partial(tpaged.paged_decode_attention_splitk_cuda,
                              num_splits=2)
        out = fn(q, pool, pool.clone(), table, [3, 20])
        d_at = 14  # 7 pointers, pt_stride, B, T, H, KV, max_pages, ps, D
    (_, args), = lib.calls
    assert lib.head_dims == [d] and args[d_at] == d
    assert out.shape == q.shape


@pytest.mark.parametrize("kind", ["decode", "prefill", "flash"])
def test_paged_and_flash_wrappers_refuse_head_dim_96(kind, monkeypatch):
    from repro_torch.kernels import flash_attention as tflash

    lib = _fake_paged_card(monkeypatch)
    monkeypatch.setattr(tflash, "_lib", lib.load)
    monkeypatch.setattr(tflash, "_check_device", lambda *a: None)
    pool = torch.zeros((9, 8, 2, 96))
    table = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    call = {"decode": lambda: tpaged.paged_decode_attention_cuda(
                torch.zeros((2, 1, 2, 96)), pool, pool.clone(), table,
                [3, 20]),
            "prefill": lambda: tpaged.paged_prefill_attention_cuda(
                torch.zeros((1, 8, 2, 96)), pool, pool.clone(), table[1], 8),
            "flash": lambda: tflash.flash_attention_cuda(
                *(torch.zeros((2, 16, 2, 96)) for _ in range(3)))}[kind]
    with pytest.raises(ValueError, match="head_dim 96 not built"):
        call()
    assert not lib.calls and not lib.head_dims


def test_paged_decode_refuses_16_rows_at_head_dim_80(monkeypatch):
    """zamba2's and musicgen's G = 1 at T = 16: past the 8-row instance,
    the largest built at head dims 80 and 64, the 16 rows are no longer
    refused but go in two row tiles of it; T = 8 is one tile."""
    lib = _fake_paged_card(monkeypatch)
    pool = torch.zeros((9, 8, 2, 80))
    table = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    tpaged.paged_decode_attention_cuda(torch.zeros((2, 8, 2, 80)), pool,
                                       pool.clone(), table, [3, 20])
    out = tpaged.paged_decode_attention_cuda(torch.zeros((2, 16, 2, 80)),
                                             pool, pool.clone(), table,
                                             [3, 20])
    assert out.shape == (2, 16, 2, 80) and len(lib.calls) == 2
    # 7 pointers, pt_stride, B, T, H, KV, max_pages, ps, D, window, ns,
    # chunk, chunks per split, then instance rows and row tiles
    assert [args[19:21] for _, args in lib.calls] == [(8, 1), (8, 2)]


@pytest.mark.parametrize("arch,d,draft_k,ok", [
    ("musicgen-large", 64, 7, True), ("musicgen-large", 64, 8, False),
    ("musicgen-large", 80, 7, True), ("musicgen-large", 80, 8, False),
    ("internlm2-1.8b", 128, 7, True), ("internlm2-1.8b", 128, 8, False)])
def test_engine_checks_the_verify_rows_per_head_dim(arch, d, draft_k, ok):
    """The engine checks a verify block's rows as the reference does: not
    at all, on the card as on the CPU.  Past the largest instance at the
    model's head dim (``ok`` False: 9 rows at 64 and 80, 18 at 128) the
    block goes in row tiles, so every draft_k the reference takes passes;
    one too deep for max_len is refused on both devices."""
    import types

    from repro_torch.runtime import serve as tserve

    cfg = dataclasses.replace(get_config(arch), head_dim=d)
    g = cfg.num_heads // cfg.num_kv_heads
    assert (g * (draft_k + 1) <= tdecode.max_rows(d)) == ok
    for device in ("cuda", "cpu"):
        model = types.SimpleNamespace(cfg=cfg, device=torch.device(device),
                                      supports_speculative=lambda: True)
        tserve._check_speculative(ServeConfig(max_len=64, draft_k=draft_k),
                                  model)
        with pytest.raises(ValueError, match="too deep"):
            tserve._check_speculative(
                ServeConfig(max_len=draft_k + 1, draft_k=draft_k), model)
