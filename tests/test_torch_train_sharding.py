"""The port's training sharding rules against the reference's, in-process
and without devices: the specs of every arch's parameters (FSDP on and
off, layouts "tp" and "dp"), optimizer state and gradient accumulator,
the batch and cache specs and the seams' constraints of
``make_shard_fn``, on the abstract meshes of ``test_torch_sharding.py``.
The reference's seams are read by catching the
``with_sharding_constraint`` its hook calls."""
import types

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import list_archs  # noqa: E402
from repro.sharding import batch_shardings as j_batch  # noqa: E402
from repro.sharding import cache_shardings as j_cache  # noqa: E402
from repro.sharding import grad_shardings as j_grad  # noqa: E402
from repro.sharding import make_shard_fn as j_make_shard_fn  # noqa: E402
from repro.sharding import opt_state_shardings as j_opt  # noqa: E402
from repro.sharding import param_shardings as j_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.sharding import (batch_shardings, cache_shardings,  # noqa: E402,E501
                                  grad_shardings, opt_state_shardings,
                                  param_shardings, train_seam_spec)
from test_torch_sharding import (MESHES, _jflat, _jmesh, _models,  # noqa: E402,E501
                                 _pflat, _sizes)

_SPECS = {}


def _specs(arch):
    """(the reference's abstract params, the port's meta params) of the
    arch's full config, once per arch."""
    if arch not in _SPECS:
        jm, pm = _models(arch)
        _SPECS[arch] = (jm.param_specs(), pm.init(torch.Generator()))
    return _SPECS[arch]


@pytest.mark.parametrize("layout", ["tp", "dp"])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_train_param_specs_equal_reference(arch, shape, fsdp, layout):
    jspecs, params = _specs(arch)
    cfg = get_config(arch)
    want = _jflat(j_params(_jmesh(shape), cfg, jspecs, fsdp=fsdp,
                           layout=layout))
    got = _pflat(param_shardings(_sizes(shape), cfg, params, fsdp=fsdp,
                                 layout=layout))
    assert got == want


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_opt_state_specs_equal_reference(arch, shape):
    """ZeRO: the FSDP dim over (pod, data); the same under "dp"."""
    jspecs, params = _specs(arch)
    cfg = get_config(arch)
    for layout in ("tp", "dp"):
        want = _jflat(j_opt(_jmesh(shape), cfg, jspecs, fsdp=False,
                            layout=layout))
        got = _pflat(opt_state_shardings(_sizes(shape), cfg, params,
                                         fsdp=False, layout=layout))
        assert got == want


def _axes_of(spec):
    out = []
    for a in spec:
        if isinstance(a, (tuple, list)):
            out.extend(a)
        elif a is not None:
            out.append(a)
    return out


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_grad_specs_equal_reference_and_never_pod(arch, shape):
    """ZeRO-2's accumulator over "data" only (the twin of
    ``tests/test_perf_knobs.py``'s pod check, on every arch and mesh)."""
    jspecs, params = _specs(arch)
    cfg = get_config(arch)
    got = _pflat(grad_shardings(_sizes(shape), cfg, params))
    assert got == _jflat(j_grad(_jmesh(shape), cfg, jspecs))
    assert all("pod" not in _axes_of(s) for s in got.values())


@pytest.mark.parametrize("layout", ["tp", "dp"])
@pytest.mark.parametrize("shape", MESHES)
def test_train_batch_specs_equal_reference(shape, layout):
    shapes = {"tokens": (256, 128), "odd": (6, 128), "one": (1, 64),
              "embeds": (32, 16, 64), "pos": ()}
    specs = {k: jax.ShapeDtypeStruct(v, jax.numpy.int32)
             for k, v in shapes.items()}
    leaves = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    want = _jflat(j_batch(_jmesh(shape), specs, layout=layout))
    got = _pflat(batch_shardings(_sizes(shape), leaves, layout=layout))
    assert got == want


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_train_cache_specs_equal_reference(arch, shape):
    """Caches at batch 32 (batch over the data axes) and batch 1 (the
    sequence over "data": long-context decode)."""
    jm, pm = _models(arch)
    mesh, sizes = _jmesh(shape), _sizes(shape)
    for batch in (32, 1):
        want = _jflat(j_cache(mesh, jax.eval_shape(
            lambda: jm.init_cache(batch, 4096))))
        got = _pflat(cache_shardings(sizes, pm.init_cache(batch, 4096)))
        assert got == want


SEAMS = [("hidden", (8, 128, 64)), ("hidden", (1, 4096, 2048)),
         ("hidden", (6, 30, 64)), ("microbatch", (2, 32, 128)),
         ("microbatch", (4, 3, 128)),
         ("moe_expert_in", (2, 1, 8, 4, 64)),
         ("moe_expert_out", (8, 4, 8, 256, 64)),
         ("moe_expert_in", (16, 2, 128, 64, 4096)),
         ("attn_q", (8, 128, 32, 128)), ("attn_q", (8, 128, 40, 128)),
         ("attn_kv", (8, 128, 8, 128)), ("attn_kv", (8, 128, 1, 128)),
         ("attn_out", (8, 128, 32, 128)), ("mlp_up", (8, 128, 512))]


@pytest.mark.parametrize("layout", ["tp", "dp"])
@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_seam_specs_equal_reference(shape, sp, layout, monkeypatch):
    """``train_seam_spec`` is the constraint the reference's
    ``make_shard_fn`` puts on each seam (None where it leaves the
    activation alone), for every seam of the model."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    mesh = _jmesh(shape)
    fn = j_make_shard_fn(mesh, get_config("internlm2-1.8b"), sp=sp,
                         layout=layout)
    for name, dims in SEAMS:
        seen.clear()
        fn(name, types.SimpleNamespace(shape=dims))
        want = seen[0] if seen else None
        got = train_seam_spec(_sizes(shape), name, dims, sp=sp,
                              layout=layout)
        assert got == want, (name, dims)
