"""Sharded serving in the port: a ``ServeEngine`` over a mesh of ranks
(processes over gloo on the CPU) must give token streams bitwise equal to
the unsharded port engine's, greedy and seeded-sampled alike.

The twin of ``tests/test_sharded_serve.py``: its tiny internlm2 (d_model
64, four query heads on two KV heads, JAX init) and its mixed requests.
Each world is spawned once per module through ``torch_worlds`` (the
port's one harness of spawned worlds) and runs every case of its shape,
rank 0 writing each case's record as it finishes; the tests compare those
records with engines run here.  A case whose world failed before it fails
with the world's error; the cases it finished still count."""
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, RuntimeKnobs  # noqa: E402
from repro_torch.runtime.serve import (Request, SamplingParams,  # noqa: E402
                                       ServeConfig, ServeEngine)
from torch_worlds import WorldFailed, read_records, spawn_world  # noqa: E402

TINY = dict(num_layers=2, vocab_size=64, d_model=64, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128)


def tiny_cfg(arch="internlm2-1.8b"):
    over = dict(TINY) if arch == "internlm2-1.8b" else dict(
        num_layers=2, vocab_size=64)
    return dataclasses.replace(get_config(arch, smoke=True), **over)


def requests(n=6, max_new=12, cls=Request, sampling_cls=SamplingParams):
    """The reference test's request set: prompts of 3-19 tokens, every
    other request seeded-sampled."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        p = rng.integers(1, 64, size=int(rng.integers(3, 20)))
        sp = (sampling_cls() if i % 2 == 0 else
              sampling_cls(temperature=0.8, top_k=20, seed=i))
        out.append(cls(req_id=i, prompt=p.astype(np.int32),
                       max_new_tokens=max_new, sampling=sp))
    return out


def streams(done):
    return {str(r.req_id): [list(map(int, r.output)), r.finish_reason]
            for r in done}


def run_engine(model, params, mesh=None, **kw):
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=64,
                                                 **kw), mesh=mesh)
    for r in requests():
        eng.submit(r)
    return streams(eng.run(max_ticks=500)), [eng]


FLOOD = dict(policy="drf-fair", tenant_weights={"gold": 3, "free": 1},
             preempt=True, victim_policy="lowest-weight-share-first")


def run_flood(model, params, mesh=None, **kw):
    """The preemption flood of ``tests/test_torch_preemption.py``: six
    gold requests, then two free ones two ticks later, which preempt gold
    slots; the victims resume in whichever slot frees first."""
    eng = ServeEngine(model, params, ServeConfig(
        batch_slots=4, max_len=64, **FLOOD, **kw), mesh=mesh)
    reqs = requests(8)
    for r in reqs:
        r.tenant = "gold" if r.req_id < 6 else "free"
    for r in reqs[:6]:
        eng.submit(r)
    eng.step()
    eng.step()
    for r in reqs[6:]:
        eng.submit(r)
    return streams(eng.run(max_ticks=500)), [eng]


def run_disagg(model, params, mesh=None, **kw):
    """A prefill engine handing off to two decode engines, every engine
    over the same mesh.  The router runs on every rank, so its straggler
    watchdog (each rank's wall clock) is off: its decisions must agree."""
    from repro_torch.runtime.disagg import DisaggRouter

    roles = ["prefill", "decode", "decode"]
    base = ServeConfig(batch_slots=4, max_len=64, **kw)
    engines = []

    def make(rid):
        engines.append(ServeEngine(model, params, dataclasses.replace(
            base, role=roles[rid]), mesh=mesh))
        return engines[-1]

    router = DisaggRouter(make, 3, roles=roles)
    for rh in router.replicas:
        rh.watchdog.threshold = float("inf")
    for r in requests():
        router.submit(r)
    return streams(router.run(max_ticks=500)), engines


def run_tight(model, params, mesh=None, **kw):
    """A prefill engine handing off to one decode engine on a pool tight
    enough that a handed-off chain lands on the data row with more free
    pages while the decode slot that frees first lies on the other row,
    which has too few: the request must wait for a slot of a row that can
    hold its chain (unsharded, any slot can)."""
    from repro_torch.runtime.disagg import DisaggRouter

    roles = ["prefill", "decode"]
    base = ServeConfig(batch_slots=4, max_len=64, **kw)
    engines = []

    def make(rid):
        engines.append(ServeEngine(model, params, dataclasses.replace(
            base, role=roles[rid]), mesh=mesh))
        return engines[-1]

    router = DisaggRouter(make, 2, roles=roles)
    for rh in router.replicas:
        rh.watchdog.threshold = float("inf")
    for r in requests(max_new=30):
        router.submit(r)
    return streams(router.run(max_ticks=500)), engines


RUNNERS = {"run": run_engine, "flood": run_flood, "disagg": run_disagg,
           "tight": run_tight}

# (case name, arch, ServeConfig kwargs, runner); each world runs its cases
# at its mesh shapes
CASES = {
    "dense": ("internlm2-1.8b", {"cache": "dense"}, "run"),
    "paged": ("internlm2-1.8b", {"cache": "paged"}, "run"),
    "spec": ("internlm2-1.8b", {"cache": "paged", "draft_k": 3}, "run"),
    "moe": ("mixtral-8x7b", {"cache": "dense"}, "run"),
    "moe_paged": ("mixtral-8x7b", {"cache": "paged"}, "run"),
    "ssm": ("mamba2-1.3b", {"cache": "dense"}, "run"),
    "preempt": ("internlm2-1.8b", {"cache": "dense"}, "flood"),
    "preempt_paged": ("internlm2-1.8b", {"cache": "paged", "page_size": 8},
                      "flood"),
    "disagg": ("internlm2-1.8b", {"cache": "dense"}, "disagg"),
    "disagg_paged": ("internlm2-1.8b", {"cache": "paged"}, "disagg"),
    "tight": ("internlm2-1.8b", {"cache": "paged", "page_size": 8,
                                 "num_pages": 24}, "tight"),
}
WORLDS = {
    4: [((2, 2), "dense"), ((2, 2), "paged"), ((2, 2), "spec"),
        ((2, 1, 2), "paged"), ((2, 2), "preempt"), ((2, 2), "preempt_paged"),
        ((2, 2), "disagg"), ((2, 2), "disagg_paged"), ((2, 2), "tight")],
    2: [((1, 2), "dense"), ((1, 2), "paged"), ((1, 2), "moe"),
        ((1, 2), "moe_paged"), ((2, 1), "ssm"), ((2, 1), "paged")],
}

WORKER = """
def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


from test_torch_sharded_serve import CASES, RUNNERS, WORLDS, tiny_cfg
from test_torch_sharded_serve import requests
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import LM, RuntimeKnobs

for shape, name in WORLDS[world]:
    arch, kw, runner = CASES[name]
    params = torch.load(os.path.join(os.environ["PARAMS"], arch + ".pt"))
    model = LM(tiny_cfg(arch), RuntimeKnobs(cache_dtype=torch.float32),
               device="cpu")
    got, engs = RUNNERS[runner](model, params, mesh=make_serve_mesh(shape),
                                **kw)
    eng = engs[0]
    rec = {"streams": got, "heads": eng.model.cfg.num_heads,
           "kv_heads": eng.model.cfg.num_kv_heads,
           "slots": eng._hi - eng._lo, "hosts": eng._num_hosts,
           "moved": sum(e.moved_across_rows for e in engs),
           "preempted": sum(e.scheduler.preempted_total for e in engs),
           "deferred": sum(getattr(e.scheduler, "row_deferrals", 0)
                           for e in engs),
           "pool_pages": None if eng.kv is None else eng.kv.pool.num_pages,
           "cache_shapes": {
               k: list(v.shape) for k, v in _flat(eng.caches).items()}}
    if eng.kv is not None and runner == "run":
        off = eng.offer()
        rec["offer"] = off
        rec["pages_local"] = int(eng.caches["stack"]["k"].shape[1])
        for r in requests(4):
            r.req_id += 100
            eng.submit(r)
        eng.step()
        rec["chains_local"] = all(
            eng.kv.pool.host_of(pg) == eng.kv.slot_host(s)
            for s in range(eng.slots) for pg in eng.kv._held[s]
        ) if eng.kv.num_hosts > 1 else None
        eng.run(max_ticks=500)
    if rank == 0:
        write_record(out_dir, "x".join(map(str, shape)) + "_" + name, rec)
dist.destroy_process_group()
"""


def _port_params(arch):
    if arch == "internlm2-1.8b":
        import jax
        import jax.numpy as jnp
        from repro.models import LM as JLM
        from repro.models import RuntimeKnobs as JKnobs
        from repro_torch import convert
        jm = JLM(tiny_cfg(arch), JKnobs(cache_dtype=jnp.float32, q_chunk=16))
        jp = jm.init(jax.random.PRNGKey(0))
        return convert.params_from_jax(jax.tree.map(np.asarray, jp)), jm, jp
    model = LM(tiny_cfg(arch), RuntimeKnobs(cache_dtype=torch.float32),
               device="cpu")
    return model.init(torch.Generator().manual_seed(0)), None, None


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' records, the unsharded port engine's streams of every
    case, and the JAX engine's."""
    tmp = tmp_path_factory.mktemp("sharded")
    params, jax_model = {}, None
    for arch in {a for a, _, _ in CASES.values()}:
        params[arch], jm, jp = _port_params(arch)
        torch.save(params[arch], tmp / f"{arch}.pt")
        if jm is not None:
            jax_model = (jm, jp)
    torch.set_num_threads(1)
    base = {}
    for name, (arch, kw, runner) in CASES.items():
        model = LM(tiny_cfg(arch), RuntimeKnobs(cache_dtype=torch.float32),
                   device="cpu")
        base[name], _ = RUNNERS[runner](model, params[arch], **kw)
    recs, errors = {}, {}
    for n in WORLDS:
        out = tmp / f"world{n}"
        out.mkdir()
        try:
            spawn_world(n, out, WORKER, env={"PARAMS": str(tmp)},
                        name=f"serve-world{n}")
        except WorldFailed as e:
            errors[n] = str(e)
        recs.update({k.replace("_", "/", 1): v
                     for k, v in read_records(out).items()})
    return {"recs": _Records(recs, errors), "base": base, "jax": jax_model,
            "tmp": tmp}


class _Records(dict):
    """The worlds' records by "shape/case"; a case missing because its
    world failed fails the test with that world's error."""

    def __init__(self, recs, errors):
        super().__init__(recs)
        self.errors = errors

    def __missing__(self, key):
        pytest.fail(f"no record of {key}: "
                    + ("\n".join(self.errors.values()) or "no world failed"))


def _cases():
    return [("x".join(map(str, s)), name) for n in WORLDS
            for s, name in WORLDS[n]]


@pytest.mark.parametrize("shape,name", _cases())
def test_sharded_streams_bitwise_unsharded(worlds, shape, name):
    """Dense and paged at (1, 2) and (2, 2), speculative paged at (2, 2),
    paged over a (pod, data, model) mesh, mixtral's expert seams at (1,
    2), mamba2's state and conv over data at (2, 1), preemption and the
    disaggregated handoff (dense and paged) at (2, 2): greedy and
    seeded-sampled streams, token for token."""
    got = worlds["recs"][f"{shape}/{name}"]["streams"]
    assert got == worlds["base"][name]
    assert any(r.sampling.temperature > 0 for r in requests())


def test_sharded_ranks_hold_local_shapes(worlds):
    """A rank holds its share: two query heads on one KV head at model 2,
    two slots at data 2, half the pool (and its sink page) per host."""
    recs = worlds["recs"]
    r = recs["2x2/paged"]
    assert (r["heads"], r["kv_heads"], r["slots"], r["hosts"]) == (2, 1, 2, 2)
    pages = -(-(4 * 64 // 16 + 1) // 2) * 2
    assert r["pages_local"] == pages // 2 + 1
    r = recs["1x2/dense"]
    assert (r["heads"], r["kv_heads"], r["slots"], r["hosts"]) == (2, 1, 4, 1)
    r = recs["2x1/ssm"]
    assert (r["slots"], r["hosts"]) == (2, 2)
    r = recs["2x1x2/paged"]  # pod x data: two hosts
    assert (r["heads"], r["kv_heads"], r["slots"], r["hosts"]) == (2, 1, 2, 2)


def test_sharded_offer_reports_per_host_pages(worlds):
    """offer()'s per-host split sums to the free pages, and every page of
    a live chain lies in its slot's host sub-pool."""
    r = worlds["recs"]["2x2/paged"]
    off = r["offer"]
    assert len(off["free_pages_by_host"]) == 2
    assert sum(off["free_pages_by_host"]) == off["free_pages"]
    assert r["chains_local"] is True
    assert worlds["recs"]["1x2/paged"]["chains_local"] is None


def test_unsharded_engine_offers_no_split():
    model = LM(tiny_cfg(), RuntimeKnobs(cache_dtype=torch.float32),
               device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=64,
                                                 cache="paged"))
    assert "free_pages_by_host" not in eng.offer()
    assert eng.mesh is None


def test_sharded_greedy_streams_equal_jax_engine(worlds):
    """The greedy requests of the sharded engines equal the JAX unsharded
    engine's on the same weights."""
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import SamplingParams as JSamplingParams
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import ServeEngine as JServeEngine

    jm, jp = worlds["jax"]
    for cache in ("dense", "paged"):
        eng = JServeEngine(jm, jp, JServeConfig(batch_slots=4, max_len=64,
                                                cache=cache))
        for r in requests(cls=JRequest, sampling_cls=JSamplingParams):
            eng.submit(r)
        want = {str(r.req_id): list(map(int, r.output))
                for r in eng.run(max_ticks=500)
                if r.sampling.temperature == 0}
        for shape in ("1x2", "2x2"):
            got = worlds["recs"][f"{shape}/{cache}"]["streams"]
            assert {k: got[k][0] for k in want} == want, (cache, shape)


def test_launcher_tp2_runs_in_a_two_rank_world(worlds):
    """``--tp 2`` under a 2-rank world: rank 0 prints the report with the
    mesh, rank 1 prints nothing."""
    tmp = worlds["tmp"] / "launcher"
    tmp.mkdir()
    outs = spawn_world(2, tmp, argv=[
        sys.executable, "-m", "repro_torch.launch.serve", "--arch",
        "internlm2-1.8b", "--smoke", "--device", "cpu", "--tp", "2",
        "--requests", "4", "--cache", "paged", "--page-size", "8",
        "--dist-init", f"file://{tmp}/launcher.rendezvous"],
        name="serve-launcher")
    assert "mesh=1x2 served 4 requests" in outs[0], outs[0]
    assert outs[1] == ""


def test_sharded_engine_refusals():
    """The reference's refusal (wave mode), before any collective; what
    the reference accepts under a mesh (preemption, the disaggregated
    roles) passes."""
    from repro_torch.runtime.serve import _check_mesh

    with pytest.raises(ValueError, match="requires mode='continuous'"):
        _check_mesh(ServeConfig(mode="wave"))
    _check_mesh(ServeConfig(preempt=True))
    _check_mesh(ServeConfig(role="prefill"))
    _check_mesh(ServeConfig(role="decode", cache="paged"))


def test_sharded_checkpoints_move_across_data_rows(worlds):
    """At (2, 2) the flood preempts requests that resume on the other data
    row, and the handoffs land on the other row: dense snapshots are
    broadcast there and page chains copied into its sub-pool, and the
    streams stay bitwise (``test_sharded_streams_bitwise_unsharded``)."""
    recs = worlds["recs"]
    for name in ("preempt", "preempt_paged"):
        assert recs[f"2x2/{name}"]["preempted"] >= 1, name
        assert recs[f"2x2/{name}"]["moved"] >= 1, name
    for name in ("disagg", "disagg_paged"):
        assert recs[f"2x2/{name}"]["moved"] >= 1, name


@pytest.mark.parametrize("shape,name", [("1x2", "dense"), ("2x2", "dense"),
                                        ("1x2", "paged"), ("2x2", "paged")])
def test_sharded_caches_follow_reference_cache_specs(worlds, shape, name):
    """A rank's cache leaves are the full caches cut by the reference's
    ``serve_cache_shardings``, each cut dim divided by its axis size, and
    one page more (the rank's null page) where the pool is cut over data
    rows."""
    import jax
    from repro.compat import AxisType, abstract_mesh
    from repro.sharding import serve_cache_shardings as j_cache

    rec = worlds["recs"][f"{shape}/{name}"]
    jm, _ = worlds["jax"]
    dims = tuple(int(d) for d in shape.split("x"))
    mesh = abstract_mesh(dims, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    sizes = dict(zip(("data", "model"), dims))
    paged = name == "paged"
    full = jax.eval_shape(
        (lambda: jm.init_cache_paged(rec["pool_pages"], 16)) if paged
        else (lambda: jm.init_cache(4, 64)))
    specs = j_cache(mesh, full, paged=paged)
    want = {}
    for (path, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(full)[0],
            jax.tree_util.tree_flatten_with_path(specs)[0]):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        local = [d // (sizes[a] if a else 1)
                 for d, a in zip(leaf.shape, tuple(sh.spec))]
        if paged and rec["hosts"] > 1:
            local[-4] += 1
        want[key] = local
    assert rec["cache_shapes"] == want


def test_tight_pool_resumes_only_onto_rows_with_room(worlds):
    """A handed-off chain whose decode slot's data row has too few free
    pages, even after evicting that row's prefix pages, waits for a slot
    of a row that can hold it instead of raising (the parent raised at
    the first such handoff), and the streams stay bitwise the unsharded
    router's."""
    rec = worlds["recs"]["2x2/tight"]
    assert rec["streams"] == worlds["base"]["tight"]
    assert rec["deferred"] >= 1
    assert all(len(v[0]) for v in rec["streams"].values())


C8_ARGS = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
           "--replicas", "2", "--requests", "8", "--max-new", "16",
           "--fault-schedule", "9:stall:1:0.2:2"]

# rank 0's clock alone sees replica 1's 8th step take a second longer
C8_WORKER = """
import time
import repro_torch.launch.serve as L

routers = []
make = L._make_router


def grab(*a):
    routers.append(make(*a))
    eng = routers[-1].replicas[1].engine
    plain, n = eng.step, [0]

    def step():
        out = plain()
        n[0] += 1
        if n[0] == 8 and rank == 0:
            time.sleep(1.0)
        return out

    eng.step = step
    return routers[-1]


L._make_router = grab
done = L.main(json.loads(os.environ["ARGS"]))
write_record(out_dir, "launcher", {
    "streams": {str(r.req_id): list(map(int, r.output)) for r in done},
    "times": [rh.watchdog.times for rh in routers[0].replicas],
    "flags": [[f[0] for f in rh.watchdog.flagged]
              for rh in routers[0].replicas]}, rank)
"""


def test_launcher_replicas_under_a_mesh_flag_the_same_steps(worlds):
    """``--replicas 2 --mesh-shape 1,2`` with a fault schedule that stalls
    replica 1: every replica is sharded over the mesh and every rank runs
    the router.  Rank 0 alone sleeps a second after one of replica 1's
    steps (its clock sees that step slow, rank 1's the next one); the
    watchdog records rank 0's step times on both ranks, so both flag the
    same step.  The streams equal the unsharded router's.  (A scheduled
    stall sleeps before the watchdog's start, so the watchdog does not
    time it.)"""
    import repro_torch.launch.serve as L

    tmp = worlds["tmp"] / "c8"
    tmp.mkdir()
    spawn_world(2, tmp, C8_WORKER, env={"ARGS": json.dumps(
        C8_ARGS + ["--mesh-shape", "1,2", "--dist-init",
                   f"file://{tmp}/launcher.rendezvous"])},
        name="serve-replicas")
    ranks = [read_records(tmp, r)["launcher"] for r in range(2)]
    done = L.main(C8_ARGS)
    want = {str(r.req_id): list(map(int, r.output)) for r in done}
    for rec in ranks:
        assert rec["streams"] == want
    assert ranks[0]["times"] == ranks[1]["times"]
    assert ranks[0]["flags"] == ranks[1]["flags"]
    assert ranks[0]["flags"][1], ranks[0]["times"]
