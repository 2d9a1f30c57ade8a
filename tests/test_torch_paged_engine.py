"""The port's paged ServeEngine (on the CPU): held against the JAX paged
engine on a shared-prefix greedy trace (token streams, prefix-cache hits
and misses, every page returned), against the port's own dense engine, and
through back-pressure, submit-time rejection, the wave-mode refusal, the
split-K autotuner on a long prompt and the launcher."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import tiny_lm  # noqa: E402
from repro.runtime.serve import Request as JRequest  # noqa: E402
from repro.runtime.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.runtime.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.runtime.serve import (Request, ServeConfig,  # noqa: E402
                                       ServeEngine)

PAGED = dict(batch_slots=2, max_len=32, cache="paged", page_size=8,
             prefill_chunk=8)


def _port(decode_splits=0):
    jm, jp = tiny_lm()
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32,
                                 decode_splits=decode_splits), device="cpu")
    return model, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _shared_prefix_trace(n=7, shared_len=9, seed=5):
    """Every other prompt starts with one shared 9-token prefix (a full
    8-token page of it can be reused), the rest are short and fresh."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 64, size=shared_len).astype(np.int32)
    trace = []
    for i in range(n):
        tail = rng.integers(0, 64, size=int(rng.integers(1, 5))).astype(
            np.int32)
        trace.append((i, np.concatenate([shared, tail]) if i % 2 else tail))
    return trace


def _run(engine, req_cls, trace, max_new=4):
    for i, prompt in trace:
        engine.submit(req_cls(i, prompt.copy(), max_new_tokens=max_new))
    done = engine.run()
    assert len(done) == len(trace)
    return {r.req_id: list(r.output) for r in done}


def _kv(engine):
    st = engine.kv.stats()
    return (st["prefix_hits"], st["prefix_misses"], st["in_use_pages"],
            st["prefix_entries"])


def test_paged_engine_matches_jax_paged_engine():
    jm, jp = tiny_lm()
    jeng = JServeEngine(jm, jp, JServeConfig(**PAGED))
    want = _run(jeng, JRequest, _shared_prefix_trace())
    model, params = _port()
    eng = ServeEngine(model, params, ServeConfig(**PAGED))
    assert eng.prefill_chunk == jeng.prefill_chunk == 8
    got = _run(eng, Request, _shared_prefix_trace())
    assert got == want
    hits, misses, in_use, cached = _kv(eng)
    assert (hits, misses, in_use, cached) == _kv(jeng)
    assert hits >= 1
    assert eng.tm.registry.value("kv_prefix_hits", replica="0") == hits
    # after the drain no request holds a page: what is still in use is
    # held by the prefix cache alone, and evicting it empties the pool
    assert in_use == cached
    eng.kv.prefix.evict(cached)
    assert eng.kv.stats()["in_use_pages"] == 0


@pytest.mark.parametrize("decode_splits", [0, 2])
def test_paged_streams_equal_dense_streams(decode_splits):
    model, params = _port(decode_splits)
    outs = {}
    for cache in ("dense", "paged"):
        eng = ServeEngine(model, params,
                          ServeConfig(**dict(PAGED, cache=cache)))
        outs[cache] = _run(eng, Request, _shared_prefix_trace(seed=6))
    assert outs["paged"] == outs["dense"]


def test_small_pool_backpressures_and_drains():
    """8 usable pages of 8 hold at most two of the three slots' 3-page
    requests at once; the queue drains through back-pressure and every
    page comes back."""
    model, params = _port()
    eng = ServeEngine(model, params, ServeConfig(
        **dict(PAGED, batch_slots=3, num_pages=9, prefix_cache=False)))
    rng = np.random.default_rng(0)
    trace = [(i, rng.integers(0, 64, size=12).astype(np.int32))
             for i in range(6)]
    outs = _run(eng, Request, trace, max_new=6)
    assert all(len(out) == 6 for out in outs.values())
    assert eng.kv.pool.in_use == 0
    assert eng.tm.registry.value("serve_backpressure_total",
                                 replica="0") > 0


def test_request_the_pool_can_never_hold_raises_at_submit():
    model, params = _port()
    eng = ServeEngine(model, params, ServeConfig(
        **dict(PAGED, batch_slots=1, num_pages=3)))
    with pytest.raises(ValueError, match="more pages than the pool"):
        eng.submit(Request(0, np.ones(20, np.int32), max_new_tokens=8))
    assert not eng.queue


def test_paged_wave_mode_raises():
    model, params = _port()
    with pytest.raises(ValueError, match="continuous"):
        ServeEngine(model, params, ServeConfig(**dict(PAGED, mode="wave")))


def test_autotune_takes_paged_split_k_on_long_prompt():
    """A 4200-token prompt at max_len 8192 and 16-token pages makes the
    autotuner pick 2 splits (each a whole-page half of the table); the
    split path gives the same tokens as the single pass."""
    from repro_torch.runtime.steps import pick_decode_splits

    assert pick_decode_splits(4200, 1, max_len=8192, page_size=16) == 2
    prompt = np.random.default_rng(11).integers(0, 64, size=4200).astype(
        np.int32)
    outs = {}
    for splits in (0, 1):
        model, params = _port(splits)
        eng = ServeEngine(model, params, ServeConfig(
            batch_slots=2, max_len=8192, prefill_chunk=256, cache="paged",
            page_size=16))
        eng.submit(Request(0, prompt, max_new_tokens=3))
        outs[splits] = eng.run()[0].output
    assert outs[0] == outs[1]
    assert any(key[1].decode_splits == 2 and key[3] == "paged_serve"
               and key[5] == 16 for key in steps._STEP_CACHE)


def test_launcher_serves_paged_on_cpu(capsys):
    from repro_torch.launch import serve as launcher

    done = launcher.main(["--arch", "internlm2-1.8b", "--smoke", "--device",
                          "cpu", "--requests", "3", "--max-new", "4",
                          "--cache", "paged", "--page-size", "8",
                          "--page-policy", "spread"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    out = capsys.readouterr().out
    assert "cache=paged" in out and "served 3 requests, 12 tokens" in out
    assert "'in_use_pages': 0" in out


@pytest.mark.parametrize("page_size", [4, 8, 16, 32])
def test_pick_decode_splits_tiles_pages_as_reference(page_size):
    """The paged autotuner's fan-out divides the page count, as the
    reference's does, over positions, live slots, lengths and overrides."""
    import itertools

    from repro.runtime.steps import pick_decode_splits as want
    from repro_torch.runtime.steps import pick_decode_splits as got

    for max_pos, batch, max_len, override in itertools.product(
            (0, 2047, 2048, 4200, 8191, 16384), (1, 2, 4, 16),
            (96, 4096, 8192, 12288), (0, 3, 4, 8)):
        kw = dict(max_len=max_len, page_size=page_size, override=override)
        splits = got(max_pos, batch, **kw)
        assert splits == want(max_pos, batch, **kw), (max_pos, batch, kw)
        assert (max_len // page_size) % splits == 0
