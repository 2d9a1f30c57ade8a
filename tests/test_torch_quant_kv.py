"""The port's quantized (int8 / fp8 e4m3) paged pools held against the JAX
package: the quantization itself and the quantized cache writes bitwise,
the plain quantized attention against the Pallas kernels (interpret mode,
as ``tests/test_quant_kv.py`` runs them), the paged model steps over
converted quantized pools, the engine's greedy streams, the conversion of
scale-carrying pools, and the dispatch: a quantized pool that is not on the
CPU goes to the CUDA kernels with its scales, or the call raises."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_lm  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention_splitk_tpu, paged_decode_attention_tpu,
    paged_prefill_attention_tpu)
from repro.models import LM as JLM  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.runtime.serve import Request as JRequest  # noqa: E402
from repro.runtime.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.runtime.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.runtime.serve import (Request, ServeConfig,  # noqa: E402
                                       ServeEngine)

NAMES = ["int8", "fp8"]
# f32 on both sides over the same quantized values: the sums run in other
# orders (the Pallas kernel page by page, the plain version in one softmax)
KERNEL_TOL = 1e-5
ATOL = 1e-4  # logits through 2 layers, as tests/test_torch_paged_model.py
PAGE, MAX_PAGES = 4, 8


def _bits(a):
    """An array as numpy for a bitwise comparison: fp8 (ml_dtypes e4m3,
    which has no numpy arithmetic) as its raw bytes, as the port's
    ``paged_cache_to_numpy`` gives its fp8 pools."""
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _t(a):
    """A JAX array as a torch tensor (fp8 through its raw bytes)."""
    return convert.cache_from_jax(np.asarray(a))


def _jq(name):
    return jattn.KV_QUANT_DTYPES[name]


def _tq(name):
    return tattn.KV_QUANT_DTYPES[name]


# -------------------------------------------------------- quantize / writes
def _rows():
    """Rows at four magnitudes, zero rows, and rows whose scaled values land
    on .5 exactly (row max 127, so int8's inv is 1): ties round to even."""
    rng = np.random.default_rng(23)
    xs = [rng.normal(size=(16, 3, 2, 32)).astype(np.float32) * s
          for s in (1e-3, 1.0, 10.0, 1e4)]
    ties = np.zeros((4, 32), np.float32)
    ties[:, 0] = 127.0
    ties[:, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5]
    return xs + [ties, np.zeros((3, 2, 32), np.float32)]


@pytest.mark.parametrize("name", NAMES)
def test_quantize_kv_matches_jax_bitwise(name):
    for x in _rows():
        jq, js = jattn.quantize_kv(jnp.asarray(x), _jq(name))
        tq, ts = tattn.quantize_kv(torch.from_numpy(x), _tq(name))
        assert tq.dtype == _tq(name) and ts.dtype == torch.float32
        np.testing.assert_array_equal(
            convert.paged_cache_to_numpy({"q": tq})["q"], _bits(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tattn.dequantize_kv(tq, ts).numpy(),
            np.asarray(jattn.dequantize_kv(jq, js)))
    zero = tattn.dequantize_kv(*tattn.quantize_kv(torch.zeros(3, 16),
                                                  _tq(name)))
    assert float(zero.abs().max()) == 0.0  # scale 0, exact zeros
    if name == "int8":  # ties to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        tq, _ = tattn.quantize_kv(torch.from_numpy(_rows()[4]), _tq(name))
        assert tq[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 4, 126]


def test_kv_quant_dtype_lookup():
    assert tattn.kv_quant_dtype("") is None
    assert tattn.kv_quant_dtype("int8") == torch.int8
    assert tattn.kv_quant_dtype("fp8") == torch.float8_e4m3fn
    with pytest.raises(KeyError):
        tattn.kv_quant_dtype("int4")


def _quant_pools(name, n, kv=2, d=8, seed=1):
    """Zeroed quantized pools and scale pools (P, PAGE, KV, *), as both
    frameworks hold them."""
    shape = (n, PAGE, kv, d)
    jp = [jnp.zeros(shape, _jq(name)) for _ in range(2)] + \
        [jnp.zeros(shape[:-1] + (1,), jnp.float32) for _ in range(2)]
    tp = [torch.zeros(shape, dtype=_tq(name)) for _ in range(2)] + \
        [torch.zeros(shape[:-1] + (1,)) for _ in range(2)]
    return jp, tp


def _assert_pools_equal(tp, jp):
    for t, j in zip(tp, jp):
        np.testing.assert_array_equal(
            convert.paged_cache_to_numpy({"x": t})["x"], _bits(j))


@pytest.mark.parametrize("name", NAMES)
def test_paged_cache_update_quant_matches_jax_bitwise(name):
    """A parked slot writes the null page, a mapped one its page and
    offset, a position past the table's span nothing: values and scales."""
    rng = np.random.default_rng(2)
    table = np.array([[3, 5, 0, 0, 0, 0, 0, 0], [7, 2, 9, 0, 0, 0, 0, 0],
                      [4, 6, 8, 1, 0, 0, 0, 0]], np.int32)
    new = [rng.normal(size=(3, 1, 2, 8)).astype(np.float32) for _ in (0, 1)]
    for pos in ([-1, 6, 12], [0, MAX_PAGES * PAGE, 3]):
        jp, tp = _quant_pools(name, 10)
        pos = np.array(pos, np.int32)
        jp = jattn.paged_cache_update_quant(
            *jp, *(jnp.asarray(a) for a in new), jnp.asarray(pos),
            jnp.asarray(table), PAGE)
        tattn.paged_cache_update_quant(
            *tp, *(torch.from_numpy(a) for a in new), pos,
            torch.from_numpy(table), PAGE)
        _assert_pools_equal(tp, jp)
    # the last writes: slot 0 at page 3 offset 0, slot 2 at page 4 offset
    # 3, slot 1's past the span dropped
    landed = (tp[2].abs().sum(dim=(2, 3)) > 0).nonzero().tolist()
    assert landed == [[3, 0], [4, 3]]


@pytest.mark.parametrize("name", NAMES)
def test_paged_prefill_chunk_update_quant_matches_jax_bitwise(name):
    """A 12-row chunk at offset 8 writes the three pages its row maps from
    block 2, values and scales."""
    rng = np.random.default_rng(3)
    table = np.array([[1, 2, 3, 0, 0, 0, 0, 0], [4, 5, 6, 7, 8, 9, 10, 11]],
                     np.int32)
    new = [rng.normal(size=(1, 12, 2, 8)).astype(np.float32) for _ in (0, 1)]
    jp, tp = _quant_pools(name, 12)
    jp = jattn.paged_prefill_chunk_update_quant(
        *jp, *(jnp.asarray(a) for a in new), 1, 8, jnp.asarray(table), PAGE)
    tattn.paged_prefill_chunk_update_quant(
        *tp, *(torch.from_numpy(a) for a in new), 1, 8,
        torch.from_numpy(table), PAGE)
    _assert_pools_equal(tp, jp)
    assert float(tp[3][6:9].abs().min()) > 0  # pages 6-8 hold the chunk


# ------------------------------------------ plain versions vs Pallas kernels
def _paged_case(name, b, kv=2, d=16, ps=16, mp=4, seed=0):
    """Random f32 pools (P, KV, ps, D) quantized by the JAX package, in its
    kernel layout, and a permuted table of every page but the null page."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * mp + 3
    pools = [jnp.asarray(rng.normal(size=(n_pages, kv, ps, d)), jnp.float32)
             for _ in (0, 1)]
    (kq, ks), (vq, vs) = (jattn.quantize_kv(p, _jq(name)) for p in pools)
    table = rng.permutation(np.arange(1, n_pages))[:b * mp].reshape(b, mp)
    return rng, kq, vq, ks, vs, table.astype(np.int32)


def _model_layout(*xs):
    """JAX kernel-layout arrays as the port's model-layout tensors."""
    return [_t(jnp.swapaxes(x, 1, 2)) for x in xs]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind,arg", [
    ("decode", 0), ("decode", 8), ("splitk", 2), ("splitk", 4),
    ("prefill", 0), ("prefill", 16)])
def test_plain_quant_attention_matches_pallas(kind, arg, name):
    """The port's plain quantized decode (windows 0 and 8), split-K (2 and
    4 splits) and fused prefill (offsets 0 and 16) against the Pallas
    kernels' scale branch, run in interpret mode on the same quantized
    pools: the cases of tests/test_quant_kv.py."""
    b = {"decode": 4, "splitk": 2, "prefill": 1}[kind]
    rng, kq, vq, ks, vs, table = _paged_case(name, b)
    kd, vd, ksd, vsd = _model_layout(kq, vq, ks, vs)
    scales = dict(k_scale=ksd, v_scale=vsd)
    if kind == "prefill":
        q = jnp.asarray(rng.normal(size=(1, 4, 16, 16)), jnp.float32)
        want = paged_prefill_attention_tpu(
            q, kq, vq, jnp.asarray(table[0]), arg, k_scale=ks, v_scale=vs,
            interpret=True)
        got = ops.paged_prefill_attention_plain(
            _t(jnp.swapaxes(q, 1, 2)), kd, vd, torch.from_numpy(table), 0,
            arg, **scales)
    else:
        q = jnp.asarray(rng.normal(size=(b, 4, 1, 16)), jnp.float32)
        pos = np.array([-1, 0, 31, 63][:b] if kind == "decode"
                       else [29, -1], np.int32)
        if kind == "decode":
            want = paged_decode_attention_tpu(
                q, kq, vq, jnp.asarray(table), pos, window=arg, k_scale=ks,
                v_scale=vs, interpret=True)
            kw = dict(window=arg)
        else:
            want = paged_decode_attention_splitk_tpu(
                q, kq, vq, jnp.asarray(table), pos, num_splits=arg,
                k_scale=ks, v_scale=vs, interpret=True)
            kw = dict(num_splits=arg)
        got = ops.paged_decode_attention_plain(
            _t(jnp.swapaxes(q, 1, 2)), kd, vd, torch.from_numpy(table),
            pos, **kw, **scales)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_quant_xla_paths_match_jax(name):
    """``paged_decode_attention_xla`` and ``gather_slot_pages`` with scales
    (model layout): the gathered views are the same f32 values, and the
    attention agrees."""
    rng, kq, vq, ks, vs, table = _paged_case(name, 4)
    jm = [jnp.swapaxes(x, 1, 2) for x in (kq, vq, ks, vs)]
    tm = _model_layout(kq, vq, ks, vs)
    q = rng.normal(size=(4, 1, 4, 16)).astype(np.float32)
    pos = np.array([-1, 0, 31, 63], np.int32)
    want = jattn.paged_decode_attention_xla(
        jnp.asarray(q), jm[0], jm[1], jnp.asarray(table), jnp.asarray(pos),
        k_scale=jm[2], v_scale=jm[3])
    got = tattn.paged_decode_attention_xla(
        torch.from_numpy(q), tm[0], tm[1], torch.from_numpy(table),
        torch.from_numpy(pos), k_scale=tm[2], v_scale=tm[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    jk, jv = jattn.gather_slot_pages(jm[0], jm[1], jnp.asarray(table),
                                     jnp.int32(2), k_scale=jm[2],
                                     v_scale=jm[3])
    tk, tv = tattn.gather_slot_pages(tm[0], tm[1], torch.from_numpy(table),
                                     2, k_scale=tm[2], v_scale=tm[3])
    assert tk.dtype == torch.float32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------- model steps
def _pair(name):
    jm, jp = tiny_lm()
    jm = JLM(jm.cfg, jm.knobs.with_(kv_quant=name))
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_layers=2, vocab_size=64)
    tm = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32, kv_quant=name),
            device="cpu")
    return jm, jp, tm, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _filled_quant_pools(jm, n_pages, seed):
    """Random pools quantized by the JAX package, as a JAX tree and the
    port's converted tree (fp8 through its raw bytes)."""
    rng = np.random.default_rng(seed)
    shape = jm.init_cache_paged(n_pages, PAGE)["stack"]["k"].shape
    qd = jattn.kv_quant_dtype(jm.knobs.kv_quant)
    (kq, ks), (vq, vs) = (jattn.quantize_kv(
        jnp.asarray(rng.normal(size=shape), jnp.float32), qd)
        for _ in (0, 1))
    jc = {"stack": {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}}
    tc = convert.paged_cache_from_jax(
        {"stack": {k: _bits(v) for k, v in jc["stack"].items()}})
    return jc, tc


def _assert_model_pools(tc, jc):
    """Values bitwise (the frameworks' fresh K/V rows agree to ~1e-7, which
    leaves every quantized value of these steps equal) and scales within
    f32 rounding of the same row maxima."""
    got = convert.paged_cache_to_numpy(tc)["stack"]
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key], _bits(jc["stack"][key]))
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(got[key], np.asarray(jc["stack"][key]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_paged_quant_matches_jax(name):
    """Ragged positions with a parked slot (-1) and the last row, through a
    shuffled table over quantized pools: logits, values and scales."""
    jm, jp, tm, tp = _pair(name)
    n_pages = 4 * MAX_PAGES + 1
    jc, tc = _filled_quant_pools(jm, n_pages, seed=6)
    assert tc["stack"]["k"].dtype == _tq(name)
    assert str(jc["stack"]["k"].dtype) == {"int8": "int8",
                                           "fp8": "float8_e4m3fn"}[name]
    rng = np.random.default_rng(7)
    table = (rng.permutation(n_pages - 1)[:4 * MAX_PAGES] + 1).reshape(
        4, MAX_PAGES).astype(np.int32)
    pos = np.array([-1, 0, 13, MAX_PAGES * PAGE - 1], np.int32)
    toks = rng.integers(0, 64, size=(4, 1))
    step = jax.jit(functools.partial(jm.decode_step_paged, page_size=PAGE))
    jl, jc = step(jp, jc, jnp.asarray(toks, jnp.int32), jnp.asarray(pos),
                  jnp.asarray(table))
    tl, tc = tm.decode_step_paged(tp, tc, torch.from_numpy(toks), pos,
                                  torch.from_numpy(table), page_size=PAGE)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    _assert_model_pools(tc, jc)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_chunk_step_paged_quant_matches_jax(name):
    """Two 8-row chunks of one slot: the second, at offset 8, reads the
    quantized pages (and scales) the first wrote."""
    jm, jp, tm, tp = _pair(name)
    c, slot, n_pages = 8, 1, 2 * MAX_PAGES + 1
    jc, tc = _filled_quant_pools(jm, n_pages, seed=9)
    table = np.zeros((2, MAX_PAGES), np.int32)
    table[0, :5] = [3, 9, 12, 4, 15]
    table[1, :4] = [7, 1, 14, 10]
    prompt = np.random.default_rng(10).integers(0, 64, size=(1, 2 * c))
    step = jax.jit(functools.partial(jm.prefill_chunk_step_paged,
                                     page_size=PAGE))
    for ci in range(2):
        chunk = prompt[:, ci * c:(ci + 1) * c]
        jl, jc = step(jp, jc, jnp.asarray(chunk, jnp.int32), jnp.int32(slot),
                      jnp.int32(ci * c), jnp.asarray(table))
        tl, tc = tm.prefill_chunk_step_paged(
            tp, tc, torch.from_numpy(chunk), slot, ci * c,
            torch.from_numpy(table), page_size=PAGE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL)
    _assert_model_pools(tc, jc)


@pytest.mark.parametrize("name", NAMES)
def test_paged_cache_round_trip_with_scale_leaves(name):
    """The reference's quantized pools (its dtype checked) cross to the
    port and back unchanged; the port's own init has the same leaves."""
    jm, _, tm, _ = _pair(name)
    jc, tc = _filled_quant_pools(jm, 5, seed=4)
    assert jc["stack"]["k"].dtype == _jq(name)
    assert jc["stack"]["k_scale"].dtype == jnp.float32
    back = convert.paged_cache_to_numpy(tc)["stack"]
    for key, leaf in jc["stack"].items():
        np.testing.assert_array_equal(back[key], _bits(leaf))
    own = tm.init_cache_paged(5, PAGE)["stack"]
    assert {k: (v.dtype, tuple(v.shape)) for k, v in own.items()} == {
        k: (v.dtype, tuple(v.shape)) for k, v in tc["stack"].items()}
    assert own["k_scale"].shape == own["k"].shape[:-1] + (1,)


# ------------------------------------------------------------------ engine
_PAGED = dict(batch_slots=2, max_len=64, cache="paged", page_size=8,
              prefill_chunk=16)


def _reqs(n=6, max_new=6, seed=3):
    """tests/test_quant_kv.py's trace: every other prompt extends an
    18-token shared prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 60, size=18).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(1, 60, size=int(rng.integers(2, 6))).astype(
            np.int32)
        out.append((i, np.concatenate([shared, tail]) if i % 2 else tail))
    return out


def _serve(engine, req_cls, max_new=6):
    handles = [engine.submit(req_cls(i, p.copy(), max_new_tokens=max_new))
               for i, p in _reqs()]
    engine.run()
    return [list(h.output) for h in handles]


_JAX_STREAMS = {}


@pytest.mark.parametrize("name", NAMES)
def test_quant_engine_matches_jax_engine(name):
    """int8 and fp8 engines serve the shared-prefix trace with prefix hits
    and the JAX engine's greedy streams; the pools are quantized, with f32
    scale pools, and hold fewer bytes than the f32 pools."""
    jm, jp, tm, tp = _pair(name)
    if name not in _JAX_STREAMS:
        jeng = JServeEngine(tiny_lm()[0], jp,
                            JServeConfig(**_PAGED, kv_dtype=name))
        _JAX_STREAMS[name] = _serve(jeng, JRequest)
        assert jeng.kv.stats()["prefix_hits"] > 0
    plain = LM(tm.cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cpu")
    eng = ServeEngine(plain, tp, ServeConfig(**_PAGED, kv_dtype=name))
    assert eng.model.knobs.kv_quant == name
    assert _serve(eng, Request) == _JAX_STREAMS[name]
    assert eng.kv.stats()["prefix_hits"] > 0
    pools = eng.caches["stack"]
    assert pools["k"].dtype == _tq(name)
    assert pools["v_scale"].dtype == torch.float32
    base = ServeEngine(plain, tp, ServeConfig(**_PAGED))
    assert eng.kv_reserved_bytes() < base.kv_reserved_bytes() / 2


@pytest.mark.parametrize("name", NAMES)
def test_quant_prefix_hit_reads_the_shared_scales(name):
    """Prefix sharing needs no code of its own: a shared page's scales sit
    at the same page id in the scale pools, so a request that hits the
    prefix cache reads the values and scales its donor wrote, and gives
    the stream it gives with the prefix cache off."""
    _, _, tm, tp = _pair(name)
    outs, hits = {}, {}
    for prefix_cache in (True, False):
        eng = ServeEngine(tm, tp, ServeConfig(**_PAGED, kv_dtype=name,
                                              prefix_cache=prefix_cache))
        outs[prefix_cache] = _serve(eng, Request)
        hits[prefix_cache] = eng.kv.stats()["prefix_hits"]
    assert hits[True] > 0 and hits[False] == 0
    assert outs[True] == outs[False]


def test_kv_dtype_validation():
    _, _, tm, tp = _pair("int8")
    with pytest.raises(ValueError, match="cache='paged'"):
        ServeEngine(tm, tp, ServeConfig(batch_slots=1, max_len=32,
                                        kv_dtype="int8"))
    with pytest.raises(ValueError, match="int8/fp8"):
        ServeEngine(tm, tp, ServeConfig(batch_slots=1, max_len=32,
                                        cache="paged", kv_dtype="int4"))


# --------------------------------------------------------------- dispatch
def _card_shaped(name, device="cpu", c=0):
    """Quantized pools at the kernels' head_dim (128) with their scales,
    q (2, 1, 4, 128) or a chunk (1, c, 4, 128), and a (2, 4) table."""
    kw = dict(device=device)
    q = torch.zeros((1, c, 4, 128) if c else (2, 1, 4, 128), **kw)
    k = torch.zeros((9, PAGE, 2, 128), **kw).to(_tq(name))
    ks = torch.zeros((9, PAGE, 2, 1), **kw)
    table = torch.arange(1, 9, dtype=torch.int32, device=device).reshape(2, 4)
    return q, k, k.clone(), ks, ks.clone(), table


_CALLS = {
    "decode": lambda q, k, v, ks, vs, t: ops.paged_decode_attention(
        q, k, v, t, [3, 5], k_scale=ks, v_scale=vs),
    "splitk": lambda q, k, v, ks, vs, t: ops.paged_decode_attention(
        q, k, v, t, [3, 5], num_splits=2, k_scale=ks, v_scale=vs),
    "prefill": lambda q, k, v, ks, vs, t: ops.paged_prefill_attention(
        q, k, v, t, 1, 0, k_scale=ks, v_scale=vs),
}


# the CUDA wrappers the calls above reach for a CUDA tensor
_CUDA_CALLS = {
    "decode": lambda q, k, v, ks, vs, t: tpaged.paged_decode_attention_cuda(
        q, k, v, t, [3, 5], k_scale=ks, v_scale=vs),
    "splitk": lambda q, k, v, ks, vs, t:
        tpaged.paged_decode_attention_splitk_cuda(
            q, k, v, t, [3, 5], num_splits=2, k_scale=ks, v_scale=vs),
    "prefill": lambda q, k, v, ks, vs, t: tpaged.paged_prefill_attention_cuda(
        q, k, v, t[1], 0, k_scale=ks, v_scale=vs),
}


@pytest.mark.parametrize("kind", list(_CALLS))
def test_quant_pool_off_the_cpu_never_reaches_a_plain_version(kind,
                                                              monkeypatch):
    """Tensors that are not on the CPU never reach a plain version or a
    dequantized f32 pool.  On the meta device (the dry run) the wrapper
    computes nothing: it returns q's shape on meta and records the
    kernel's work, the int8 pool's scales counted (4 bytes a key and KV
    head beside its 1-byte values); the CUDA wrapper, which a CUDA tensor
    reaches, raises for a device it cannot launch on (meta stands in for
    the card)."""
    from repro_torch.kernels import cost

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran for a non-CPU tensor")

    for fn in ("paged_decode_attention_plain",
               "paged_prefill_attention_plain"):
        monkeypatch.setattr(ops, fn, refuse)
    for fn in ("dequantize_ref", "paged_decode_attention_quant_ref",
               "paged_decode_attention_splitk_quant_ref",
               "paged_prefill_attention_quant_ref"):
        monkeypatch.setattr(ref, fn, refuse)
    args = _card_shaped("int8", "meta", c=8 if kind == "prefill" else 0)
    got = []
    with cost.recording(lambda name, work: got.append(work)):
        out = _CALLS[kind](*args)
    assert out.device.type == "meta" and out.shape == args[0].shape
    (work,) = got
    keys = 8 if kind == "prefill" else 4 + 6  # the chunk; slots at 3 and 5
    assert work.bytes_read >= 2 * keys * 2 * (128 + 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _CUDA_CALLS[kind](*args)


class _FakeLib:
    """Stands in for the built library: records each entry point's
    arguments and returns the error code it is given; ``head_dims`` lists
    the head dim of each library the wrappers asked for."""

    def __init__(self, err):
        self.err, self.calls, self.head_dims = err, [], []
        for name in ("paged_decode_attention_fwd",
                     "paged_prefill_attention_fwd", "flash_attention_fwd"):
            setattr(self, name, self._entry(name))

    def load(self, head_dim):
        """The wrappers' ``_lib(head_dim)``: the library of that head dim
        (recorded)."""
        self.head_dims.append(head_dim)
        return self

    def _entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.err
        call.__name__ = name
        return call


def _fake_card(monkeypatch, err):
    """Run the wrappers on CPU tensors up to the launch: the device check,
    the stream and the SM count are stubbed, the library is ``_FakeLib``."""
    lib = _FakeLib(err)
    monkeypatch.setattr(tpaged, "_lib", lib.load)
    monkeypatch.setattr(tpaged, "_check_device", lambda *a: None)
    monkeypatch.setattr(tflash, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    return lib


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["decode", "splitk", "prefill"])
def test_quant_wrappers_hand_the_scales_to_the_kernel(kind, name,
                                                      monkeypatch):
    """The wrappers pass a quantized pool to its kernel with the pool's
    dtype code (int8 2, fp8 3) and both scale pools' pointers; a kernel
    that refuses the launch (cudaErrorInvalidValue, 1) makes the wrapper
    raise and count no launch."""
    q, k, v, ks, vs, table = _card_shaped(name,
                                          c=8 if kind == "prefill" else 0)
    call = {
        "decode": lambda: tpaged.paged_decode_attention_cuda(
            q, k, v, table, [3, 5], k_scale=ks, v_scale=vs),
        "splitk": lambda: tpaged.paged_decode_attention_splitk_cuda(
            q, k, v, table, [3, 5], num_splits=2, k_scale=ks, v_scale=vs),
        "prefill": lambda: tpaged.paged_prefill_attention_cuda(
            q, k, v, table[1], 0, k_scale=ks, v_scale=vs)}[kind]
    wrapper = {"decode": tpaged.paged_decode_attention_cuda,
               "splitk": tpaged.paged_decode_attention_splitk_cuda,
               "prefill": tpaged.paged_prefill_attention_cuda}[kind]
    code = {"int8": 2, "fp8": 3}[name]
    lib = _fake_card(monkeypatch, 0)
    before = wrapper.launches
    call()
    (fn, args), = lib.calls
    assert args[-3:-1] == (0, code)  # q f32, the pool's code
    assert ks.data_ptr() in args and vs.data_ptr() in args
    assert wrapper.launches == before + 1
    lib.err = 1
    with pytest.raises(RuntimeError, match="launch failed"):
        call()
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("case,match", [
    ("no_scales", "takes both scale pools"),
    ("one_scale", "takes both scale pools"),
    ("scales_on_f32", "takes no scale pools"),
    ("scale_shape", "k_scale must be float32"),
    ("scale_dtype", "v_scale must be float32")])
def test_quant_wrapper_refuses_bad_scales(case, match):
    q, k, v, ks, vs, table = _card_shaped("int8")
    if case == "no_scales":
        ks = vs = None
    elif case == "one_scale":
        vs = None
    elif case == "scales_on_f32":
        k, v = k.float(), v.float()
    elif case == "scale_shape":
        ks = ks[:, :2]
    elif case == "scale_dtype":
        vs = vs.double()
    for fn in (tpaged.paged_decode_attention_cuda,
               tpaged.paged_decode_attention_splitk_cuda):
        with pytest.raises(ValueError, match=match):
            fn(q, k, v, table, [3, 5], k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match=match):
        tpaged.paged_prefill_attention_cuda(
            torch.zeros((1, 8, 4, 128)), k, v, table[1], 0, k_scale=ks,
            v_scale=vs)
