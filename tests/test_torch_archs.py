"""The port's model on the smoke configs of the archs its plans accept
beside internlm2 (qwen2.5-32b: qkv bias; granite-20b: one KV head for 48
query heads; musicgen-large: head_dim 64, plain MLP; llava-next-mistral-7b:
embeddings input and a sliding window), held against the JAX model: the
same weights (JAX ``LM.init``, carried across with ``params_from_jax``) and
the same numpy inputs must give the same prefill logits and caches, and the
same logits for a ragged decode step from those caches."""
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
