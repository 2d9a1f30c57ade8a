"""The port's ServeEngine (on the CPU) against the JAX ServeEngine: the same
weights and the same greedy trace -- more requests than slots, prompts of
different lengths -- must give identical token streams, in continuous and
wave mode, with the split-K autotune on (decode_splits=0) and with a
static split-K fan-out (decode_splits=2)."""
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
from repro_torch.runtime.sampling import SamplingParams  # noqa: E402
from repro_torch.runtime.serve import (Request, ServeConfig,  # noqa: E402
                                       ServeEngine, ServeStalled)

TRACE_SEED = 3


def _trace(n=6):
    rng = np.random.default_rng(TRACE_SEED)
    return [(i, rng.integers(0, 64, size=int(rng.integers(1, 7))).astype(
        np.int32)) for i in range(n)]


def _port(decode_splits=0):
    jm, jp = tiny_lm()
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32,
                                 decode_splits=decode_splits), device="cpu")
    return model, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _run(engine, req_cls, n=6, max_new=5):
    for i, prompt in _trace(n):
        engine.submit(req_cls(i, prompt, max_new_tokens=max_new))
    done = engine.run()
    assert len(done) == n
    return {r.req_id: list(r.output) for r in done}


_JAX_STREAMS = {}


def _jax_streams(mode):
    if mode not in _JAX_STREAMS:
        jm, jp = tiny_lm()
        eng = JServeEngine(jm, jp, JServeConfig(batch_slots=2, max_len=32,
                                                mode=mode, prefill_chunk=4))
        _JAX_STREAMS[mode] = _run(eng, JRequest)
    return _JAX_STREAMS[mode]


@pytest.mark.parametrize("decode_splits", [0, 2])
@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_engine_matches_jax_engine(mode, decode_splits):
    model, params = _port(decode_splits)
    eng = ServeEngine(model, params, ServeConfig(
        batch_slots=2, max_len=32, mode=mode, prefill_chunk=4))
    assert _run(eng, Request) == _jax_streams(mode)


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_engine_bf16_cache_matches_jax_engine(mode):
    """Both engines on their default knobs (a bf16 cache): the dense
    chunked prefill multiplies the f32 queries with the bf16 stripe in f32,
    as the reference's einsum promotes them, and the streams agree."""
    from repro.models import LM as JLM
    from repro.models import RuntimeKnobs as JRuntimeKnobs

    jm, jp = tiny_lm()
    jm = JLM(jm.cfg, JRuntimeKnobs())
    model, params = _port()
    model = LM(model.cfg, RuntimeKnobs(), device="cpu")
    assert model.knobs.cache_dtype == torch.bfloat16
    config = dict(batch_slots=2, max_len=32, mode=mode, prefill_chunk=4)
    want = _run(JServeEngine(jm, jp, JServeConfig(**config)), JRequest)
    assert _run(ServeEngine(model, params, ServeConfig(**config)),
                Request) == want


@pytest.mark.parametrize("decode_splits", [0, 2])
def test_continuous_equals_wave_within_port(decode_splits):
    model, params = _port(decode_splits)
    outs = {mode: _run(ServeEngine(model, params, ServeConfig(
        batch_slots=2, max_len=32, mode=mode, prefill_chunk=4)), Request)
        for mode in ("continuous", "wave")}
    assert outs["continuous"] == outs["wave"]


def test_autotune_takes_split_k_on_long_prompt():
    """A ~4200-token prompt makes the autotuner pick 2 splits, as on the
    card; the split path gives the same tokens as the single pass."""
    from repro_torch.runtime import steps
    from repro_torch.runtime.steps import pick_decode_splits

    assert pick_decode_splits(4200, 1, max_len=8192) == 2
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 64, size=4200).astype(np.int32)
    outs = {}
    for splits in (0, 1):
        model, params = _port(splits)
        eng = ServeEngine(model, params, ServeConfig(
            batch_slots=2, max_len=8192, prefill_chunk=256))
        eng.submit(Request(0, prompt, max_new_tokens=3))
        outs[splits] = eng.run()[0].output
    assert outs[0] == outs[1]
    assert any(key[1].decode_splits == 2 and key[3] == "serve"
               for key in steps._STEP_CACHE)  # the autotuned split step


def test_engine_api_edges():
    model, params = _port()
    eng = ServeEngine(model, params, ServeConfig(batch_slots=1, max_len=16))
    with pytest.raises(ValueError):
        eng.submit(Request(0, np.zeros(0, np.int32)))
    with pytest.raises(ValueError):
        eng.submit(Request(1, np.zeros(16, np.int32)))
    sampled = eng.submit(Request(2, np.ones(3, np.int32), max_new_tokens=3,
                                 sampling=SamplingParams(temperature=0.7)))
    assert len(sampled.result().output) == 3  # sampled requests are served
    handle = eng.submit(Request(3, np.ones(3, np.int32), max_new_tokens=4))
    assert len(list(handle.tokens())) == 4
    assert handle.finish_reason == "length"
    assert set(handle.metrics()) == {"ttft_s", "tpot_s"}
    eng.submit(Request(4, np.ones(3, np.int32), max_new_tokens=8))
    with pytest.raises(ServeStalled):
        eng.run(max_ticks=2)


@pytest.mark.parametrize("field,value", [
    ("kv_dtype", "int8"), ("draft_k", 2), ("preempt", True),
    ("role", "prefill"), ("mesh_shape", (1, 2))])
def test_unported_serve_config_fields_raise(field, value):
    """Every field is ported: ``kv_dtype`` on the (default) dense cache
    raises the reference's ValueError, and so does ``mesh_shape`` in a
    process without a world of its size (the reference's "needs n
    devices"); ``draft_k``, ``preempt`` and ``role`` construct an
    engine."""
    model, params = _port()
    if field in ("draft_k", "preempt", "role"):
        eng = ServeEngine(model, params, ServeConfig(**{field: value}))
        assert getattr(eng.config, field) == value
        return
    error, match = ((ValueError, "cache='paged'") if field == "kv_dtype"
                    else (ValueError, "needs 2 devices, 1 visible"))
    with pytest.raises(error, match=match):
        ServeEngine(model, params, ServeConfig(**{field: value}))


@pytest.mark.parametrize("policy", ["fcfs", "priority", "sjf", "drf-fair"])
def test_admission_policies_drain(policy):
    model, params = _port()
    eng = ServeEngine(model, params, ServeConfig(batch_slots=2, max_len=32,
                                                 policy=policy))
    for i, prompt in _trace(5):
        eng.submit(Request(i, prompt, max_new_tokens=3, tenant=f"t{i % 2}",
                           priority=i % 3))
    done = eng.run()
    assert sorted(r.req_id for r in done) == list(range(5))
    assert eng.tm.registry.value("engine_tokens_total", replica="0") == 15


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_launcher_serves_on_cpu(mode, capsys):
    from repro_torch.launch import serve as launcher

    done = launcher.main(["--arch", "internlm2-1.8b", "--smoke", "--device",
                          "cpu", "--requests", "3", "--max-new", "4",
                          "--mode", mode])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
