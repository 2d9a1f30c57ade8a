"""The port's serving sharding rules against the reference's, in-process
and without devices: the specs of every arch's parameters and caches on
abstract meshes, the batch spec, the mesh's errors, and ``shard_params``
with the seams' gather rebuilding the full tensors bitwise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.compat import AxisType, abstract_mesh  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import RuntimeKnobs as JKnobs  # noqa: E402
from repro.sharding import serve_batch_sharding as j_batch  # noqa: E402
from repro.sharding import serve_cache_shardings as j_cache  # noqa: E402
from repro.sharding import serve_param_shardings as j_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.models.moe import moe_init  # noqa: E402
from repro_torch.sharding import (head_layout, model_cuts,  # noqa: E402
                                  serve_batch_sharding,
                                  serve_cache_shardings,
                                  serve_param_shardings, shard_params)
from repro_torch.sharding.rules import _param_spec  # noqa: E402

MESHES = [(1, 2), (2, 2), (2, 4), (16, 16), (2, 16, 16)]


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _jmesh(shape):
    axes = _axes(shape)
    return abstract_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def _sizes(shape):
    return dict(zip(_axes(shape), shape))


def _jflat(tree):
    """{path: spec tuple} of a tree of NamedShardings, paths as the
    reference's ``_path_str`` writes them."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(s.spec)
    return out


def _pflat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_pflat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


_MODELS = {}


def _models(arch, kv_quant=""):
    """(JAX LM, port LM on the meta device) of the arch's full config."""
    key = (arch, kv_quant)
    if key not in _MODELS:
        _MODELS[key] = (
            JLM(get_config(arch), JKnobs(kv_quant=kv_quant)),
            LM(get_config(arch), RuntimeKnobs(kv_quant=kv_quant),
               device="meta"))
    return _MODELS[key]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(arch, shape):
    jm, pm = _models(arch)
    cfg = get_config(arch)
    want = _jflat(j_params(_jmesh(shape), jm.cfg, jm.param_specs()))
    params = pm.init(torch.Generator())
    got = _pflat(serve_param_shardings(_sizes(shape), cfg, params))
    assert got == want


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_reference(arch, shape):
    """Dense caches, and (attention plans) f32 and int8 paged pools with
    their scale leaves."""
    jm, pm = _models(arch)
    mesh, sizes = _jmesh(shape), _sizes(shape)
    dense = jax.eval_shape(lambda: jm.init_cache(32, 64))
    assert (_pflat(serve_cache_shardings(sizes, pm.init_cache(32, 64)))
            == _jflat(j_cache(mesh, dense)))
    if not pm.supports_paged_cache():
        return
    for quant in ("", "int8"):
        jq, pq = _models(arch, quant)
        paged = jax.eval_shape(lambda: jq.init_cache_paged(64, 16))
        got = _pflat(serve_cache_shardings(
            sizes, pq.init_cache_paged(64, 16), paged=True))
        assert got == _jflat(j_cache(mesh, paged, paged=True))
        if quant:
            assert any(k.endswith("k_scale") for k in got)


@pytest.mark.parametrize("shape,batch", [
    ((1, 2), 4), ((2, 2), 4), ((2, 2), 3), ((4, 1), 2), ((2, 2, 2), 8),
    ((2, 2, 2), 6), ((16, 16), 32), ((16, 16), 8)])
def test_batch_spec_divisibility(shape, batch):
    want = j_batch(_jmesh(shape), batch)
    got = serve_batch_sharding(_sizes(shape), batch)
    assert got == (None if want is None else tuple(want.spec))


def test_make_serve_mesh_errors(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_job_mesh, make_serve_mesh

    for bad in ((2,), (0, 2), (1, 2, 3, 4), (2, -1)):
        with pytest.raises(ValueError, match="mesh shape must be"):
            make_serve_mesh(bad)
    with pytest.raises(ValueError, match=r"needs 2 devices, 1 visible"):
        make_serve_mesh((1, 2))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match=r"needs 4 devices, 1 visible"):
            make_serve_mesh((2, 2))
        mesh = make_serve_mesh((1, 1))
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert tuple(make_job_mesh(1).mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match=r"needs 2 devices, 1 visible"):
            make_job_mesh(2)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("pods,chips,want", [
    ((0,), (4, 4), (1, 8)), ((0, 1), (8, 8), (2, 1, 8)),
    ((0, 1), (16, 16), (2, 1, 16)), ((0,), (4, 4, 4), (3, 4)),
    ((0, 1), (4, 2), (2, 3, 1)), ((0, 1), (4, 3), (7, 1)),
    ((0,), (64,), (4, 16))])
def test_placement_mesh_shape(pods, chips, want):
    """The reference's placement-to-mesh rule: the pods a gang spans
    become the "pod" axis (flat when the gang does not divide over them),
    the model axis the largest power of two up to 16 per pod."""
    from types import SimpleNamespace as NS

    from repro_torch.launch.mesh import placement_mesh_shape

    hosts = {f"a{i}": NS(agent=NS(pod_id=pods[i % len(pods)]))
             for i in range(len(chips))}
    placement = NS(assignment={f"a{i}": c for i, c in enumerate(chips)})
    assert placement_mesh_shape(placement, NS(hosts=hosts)) == want


def _smoke(arch, **over):
    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=2,
                              vocab_size=64, **over)
    model = LM(cfg, RuntimeKnobs(), device="cpu")
    return cfg, model.init(torch.Generator().manual_seed(0))


def _ranks(shape):
    sizes = _sizes(shape)
    axes = _axes(shape)
    for idx in np.ndindex(*shape):
        yield dict(zip(axes, idx)), sizes


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x7b",
                                  "qwen2.5-32b"])
def test_shards_gather_back_bitwise(arch, shape):
    """Every rank's shard of a leaf, cut by its spec, concatenated in the
    model axis's rank order (what the seams' all-gather does) rebuilds the
    leaf bitwise; a data coordinate cuts nothing."""
    cfg, params = _smoke(arch, num_heads=8, num_kv_heads=4)
    full = _pflat(params)
    shards = {}
    for coord, sizes in _ranks(shape):
        if coord.get("data", 0):
            local = _pflat(shard_params(params, sizes, coord=coord))
            base = _pflat(shard_params(params, sizes, coord=dict(
                coord, data=0)))
            assert all(torch.equal(local[k], base[k]) for k in local)
            continue
        shards[coord["model"]] = _pflat(shard_params(params, sizes,
                                                     coord=coord))
    m = shape[-1]
    for key, leaf in full.items():
        spec = _param_spec(_sizes(shape), key, leaf.shape)
        parts = [shards[i][key] for i in range(m)]
        if "model" in spec:
            got = torch.cat(parts, dim=spec.index("model"))
        else:
            got = parts[0]
            assert all(p is leaf for p in parts), key
        assert torch.equal(got, leaf), key


@pytest.mark.parametrize("m", [2, 4])
def test_seam_gathers_rebuild_activations_bitwise(m):
    """The seams' gather of local products equals the unsharded product:
    q heads (``attn_out`` gathers what the heads give), MLP up columns
    (``mlp_up``) and per-expert outputs (``moe_expert_out``)."""
    cfg, params = _smoke("internlm2-1.8b", num_heads=8, num_kv_heads=4)
    sizes = {"data": 1, "model": m}
    x = torch.randn(4, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    full = params["blocks"]["stack"]
    locs = [shard_params(params, sizes, cfg, coord={"data": 0, "model": i})
            ["blocks"]["stack"] for i in range(m)]
    q = torch.einsum("bsd,dhk->bshk", x, full["attn"]["wq"][0])
    assert torch.equal(torch.cat([torch.einsum(
        "bsd,dhk->bshk", x, loc["attn"]["wq"][0]) for loc in locs], 2), q)
    up = x @ full["mlp"]["w_up"][0]
    assert torch.equal(torch.cat([x @ loc["mlp"]["w_up"][0]
                                  for loc in locs], -1), up)
    moe_cfg = get_config("mixtral-8x7b", smoke=True).moe
    moe = moe_init(torch.Generator().manual_seed(2), cfg.d_model, moe_cfg)
    e = moe_cfg.num_experts
    xin = torch.randn(e, 6, cfg.d_model)
    want = torch.bmm(torch.bmm(xin, moe["w_up"]), moe["w_down"])
    parts = []
    for i in range(m):
        loc = shard_params({"moe": moe}, sizes, coord={"data": 0,
                                                       "model": i})["moe"]
        el = e // m
        parts.append(torch.bmm(torch.bmm(xin[i * el:(i + 1) * el],
                                         loc["w_up"]), loc["w_down"]))
    assert torch.equal(torch.cat(parts, 0), want)


@pytest.mark.parametrize("h,kv,m", [(8, 1, 2), (8, 1, 4), (8, 2, 4),
                                    (12, 3, 2), (8, 4, 2)])
def test_head_layout_maps_each_query_head_to_its_kv_head(h, kv, m):
    """Where KV does not divide the model axis (granite's KV = 1), ``wk``
    stays replicated and a rank keeps the KV heads its query heads read:
    its local attention equals the unsharded attention's heads, bitwise."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              num_heads=h, num_kv_heads=kv)
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 1, h, 16, generator=g)
    k = torch.randn(2, 32, kv, 16, generator=g)
    v = torch.randn(2, 32, kv, 16, generator=g)
    pos = torch.tensor([20, 31], dtype=torch.int32)
    want = ops.decode_attention(q, k, v, pos)
    sizes = {"data": 1, "model": m}
    cuts = model_cuts(sizes, LM(cfg, RuntimeKnobs(), device="meta").init(
        torch.Generator()))
    if (h // m) % (h // kv) and (h // kv) % (h // m):
        with pytest.raises(ValueError, match="ragged share"):
            head_layout(cfg, sizes, 0, cuts)
        return
    for i in range(m):
        (h0, h1), (k0, k1) = head_layout(cfg, sizes, i, cuts)
        got = ops.decode_attention(q[:, :, h0:h1].contiguous(),
                                   k[:, :, k0:k1].contiguous(),
                                   v[:, :, k0:k1].contiguous(), pos)
        assert torch.equal(got, want[:, :, h0:h1]), i


def test_serve_shard_fn_gathers_only_sharded_seams():
    """A (1, 1) mesh's hook is the identity at every seam; the rules'
    gather decisions follow divisibility."""
    from repro_torch.sharding import ServeShardFn

    class Mesh1:
        mesh_dim_names = ("data", "model")
        mesh = torch.zeros(1, 1)

        def get_coordinate(self):
            return [0, 0]

    cfg = get_config("internlm2-1.8b", smoke=True)
    cuts = model_cuts({"data": 1, "model": 1}, LM(
        cfg, RuntimeKnobs(), device="meta").init(torch.Generator()))
    fn = ServeShardFn(Mesh1(), cuts)
    x = torch.randn(2, 1, 4, 16)
    for name in ("attn_q", "attn_kv", "attn_out", "mlp_up", "hidden",
                 "moe_expert_in", "moe_expert_out"):
        assert fn(name, x) is x
    assert fn == ServeShardFn(fn.mesh, cuts)
    assert hash(fn) == hash(ServeShardFn(fn.mesh, cuts))
    assert fn != ServeShardFn(fn.mesh, dict(cuts, ff=not cuts["ff"]))


@pytest.mark.parametrize("shape", [(1, 2), (2, 4), (16, 16)])
@pytest.mark.parametrize("arch", list_archs())
def test_model_cuts_follow_reference_param_specs(arch, shape):
    """Where a rank's heads, MLP columns and experts are cut, and so where
    the seams gather, is what the reference's spec of wq, wk, w_up (dense
    MLP) and the MoE's w_gate says."""
    jm, pm = _models(arch)
    want = _jflat(j_params(_jmesh(shape), jm.cfg, jm.param_specs()))
    got = model_cuts(_sizes(shape), pm.init(torch.Generator()))
    for kind, leaf in (("heads", "/attn/wq"), ("kv_heads", "/attn/wk"),
                       ("ff", "/mlp/w_up"), ("experts", "/moe/w_gate")):
        specs = [s for k, s in want.items() if k.endswith(leaf)]
        assert got[kind] == any("model" in s for s in specs), kind
