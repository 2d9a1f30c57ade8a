"""The port's model on the smoke configs of the archs its plans accept
beside internlm2 (qwen2.5-32b: qkv bias; granite-20b: one KV head for 48
query heads; musicgen-large: head_dim 64, plain MLP; llava-next-mistral-7b:
embeddings input, full attention (window 0) and an untied unembedding),
held against the JAX model: the same weights (JAX ``LM.init``, carried
across with ``params_from_jax``) and the same numpy inputs must give the
same prefill logits and caches, and the same logits for a ragged decode
step from those caches.  llava's engines (served by token ids through the
untied embedding, as the reference serves it) give the JAX engines'
greedy streams, dense and paged, and its embeddings route of
``LM.prefill`` equals its token route when the embeddings are the
embedding table's rows."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402

# f32 end to end on both sides (f32 caches); the frameworks sum in other
# orders through 2 layers and the unembedding (measured <= 2.4e-7).
ATOL = 1e-5
B, S = 2, 16


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "granite-20b",
                                  "musicgen-large", "llava-next-mistral-7b"])
def test_arch_prefill_and_ragged_decode_match_jax(arch):
    jm, jp = tiny_lm(arch)
    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=2,
                              vocab_size=64)
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(31)
    batch = {"tokens": rng.integers(0, 64, size=(B, S)).astype(np.int32)}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    jl, jc = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    tl, tc = tm.prefill(tp, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    got = convert.cache_to_numpy(tc)
    for key in ("k", "v"):
        np.testing.assert_allclose(got["stack"][key],
                                   np.asarray(jc["stack"][key]), atol=ATOL,
                                   rtol=ATOL)
    # ragged decode from the prefill caches: slot 0 rewrites position 9,
    # slot 1 the last row
    toks = rng.integers(0, 64, size=(B, 1))
    pos = np.array([9, S - 1], np.int32)
    jl, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(pos))
    tl, _ = tm.decode_step(tp, tc, torch.from_numpy(toks), pos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)


LLAVA = "llava-next-mistral-7b"


def _llava_port():
    cfg = dataclasses.replace(get_config(LLAVA, smoke=True), num_layers=2,
                              vocab_size=64)
    _, jp = tiny_lm(LLAVA)
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    return tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("cache_kw", [
    dict(), dict(cache="paged", page_size=8)], ids=["dense", "paged"])
def test_llava_engine_streams_match_jax(cache_kw):
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine

    jm, jp = tiny_lm(LLAVA)
    tm, tp = _llava_port()
    assert tm.cfg.input_mode == "embeddings" and not tm.cfg.tie_embeddings
    kw = dict(batch_slots=2, max_len=64, prefill_chunk=8, **cache_kw)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, 64, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 20, size=5)]
    outs = []
    for eng, req in ((JServeEngine(jm, jp, JServeConfig(**kw)), JRequest),
                     (ServeEngine(tm, tp, ServeConfig(**kw)), Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(i, p.copy(), max_new_tokens=6))
        outs.append({r.req_id: list(r.output) for r in eng.run()})
    assert outs[0] == outs[1]
    assert all(len(v) == 6 for v in outs[1].values())


def test_llava_embeddings_route_equals_token_route():
    """The embedding table's rows as ``batch["embeds"]`` are an exact
    lookup, so ``LM.prefill`` on them gives the token route's logits and
    caches bitwise (the token route: the same weights in a model whose
    ``input_mode`` embeds the token ids itself, as the engines do)."""
    tm, tp = _llava_port()
    by_tokens = LM(dataclasses.replace(tm.cfg, input_mode="tokens"),
                   tm.knobs, device="cpu")
    tokens = np.random.default_rng(42).integers(0, 64, size=(B, S))
    tl, tc = by_tokens.prefill(tp, {"tokens": tokens.astype(np.int32)})
    el, ec = tm.prefill(tp, {"tokens": tokens.astype(np.int32),
                             "embeds": tp["embed"]["table"][
                                 torch.from_numpy(tokens)]})
    assert torch.equal(tl, el)
    for key in ("k", "v"):
        assert torch.equal(tc["stack"][key], ec["stack"][key])
