"""The Scylla core the port copies (``repro_torch.core``: jobs, cluster,
cost model, policies, the gang scheduler and the job simulator), held
against the reference's ``repro.core`` on the same seeded scenarios: the
same offers, placements, schedules, evictions, layouts and simulated
makespans, value for value.  ``tests/test_scheduler.py`` and
``tests/test_simulator.py`` hold the paper's claims on the reference; a
scenario that agrees here makes the same claims of the copy."""
import dataclasses
import enum
import importlib

import numpy as np
import pytest


def _core(pkg):
    return importlib.import_module(f"{pkg}.core")


def _plain(x):
    """Scenario output -> plain values (dataclasses as dicts, enums by
    value), so the two packages' objects compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _job(c, jid, chips, policy="spread", arch="internlm2-1.8b", **kw):
    return c.JobSpec(jid, arch, "train_4k", chips=chips, policy=policy, **kw)


SMALL = dict(n_pods=2, hosts_per_pod=4)


def offers_and_policies(c):
    cluster = c.Cluster(c.ClusterSpec(**SMALL))
    first = next(iter(cluster.hosts))
    cluster.allocate("other", {first: 3})
    offers = cluster.advertise()
    out = [[(o.agent.agent_id, o.available.chips) for o in offers]]
    for chips in (1, 5, 8, 16, 29, 33):
        for name in ("spread", "minhost", "auto"):
            pl = c.get_policy(name).place(_job(c, "j", chips), offers,
                                          cluster)
            out.append(None if pl is None else sorted(pl.assignment.items()))
    return out


def scheduler_sequence(c):
    out = []
    for co in (True, False):
        sched = c.ScyllaScheduler(c.Cluster(c.ClusterSpec(**SMALL)),
                                  co_schedule=co)
        for i, (chips, fw) in enumerate(((16, "alice"), (8, "bob"),
                                         (8, "bob"), (4, "carol"))):
            sched.submit(_job(c, f"j{i}", chips, framework=fw), 0.0)
        for t in range(4):
            started = sched.try_schedule(float(t))
            out.append([(js.spec.job_id, sorted(js.assignment.items()),
                         js.layout) for js in started])
            if sched.running:
                sched.finish(sorted(sched.running)[0], float(t) + 0.5)
        out.append(sched.cluster.utilization())
    return out


def host_failure_kill_sequence(c):
    """The reference's seeded kill/heal/finish/submit sequences; every
    gang's placement and the DRF shares after each op."""
    rng = np.random.default_rng(1234)
    out = []
    for _ in range(3):
        sched = c.ScyllaScheduler(c.Cluster(c.ClusterSpec(**SMALL)),
                                  co_schedule=True)
        hosts = sorted(sched.cluster.hosts)
        ops = [("submit", int(rng.integers(1, 17))) for _ in range(4)]
        for _ in range(12):
            kind = ("kill", "heal", "finish", "submit")[int(
                rng.integers(0, 4))]
            arg = int(rng.integers(0, 16))
            ops.append((kind, arg if kind != "submit" else max(1, arg % 12)))
        now = 0.0
        for i, (kind, arg) in enumerate(ops):
            now += 1.0
            if kind == "submit":
                sched.submit(_job(c, f"j{i}", arg, framework=f"fw{arg % 3}"),
                             now)
                sched.try_schedule(now)
            elif kind == "kill":
                victims = sched.on_host_failure(hosts[arg % len(hosts)], now)
                out.append([(v.spec.job_id, v.steps_done, v.restarts)
                            for v in victims])
            elif kind == "heal":
                sched.cluster.heal_host(hosts[arg % len(hosts)])
                sched.try_schedule(now)
            elif sched.running:
                sched.finish(sorted(sched.running)[arg % len(sched.running)],
                             now)
            out.append(sorted((jid, sorted(js.assignment.items()))
                              for jid, js in sched.running.items()))
            out.append({f: sched.drf.dominant_share(f)
                        for f in sorted(sched.drf.accounts)})
    return out


def stragglers_and_overheads(c):
    sched = c.ScyllaScheduler(c.Cluster(c.ClusterSpec(**SMALL)),
                              straggler_threshold=2.0, compile_cache=True)
    sched.submit(_job(c, "j0", 32), 0.0)
    sched.try_schedule(0.0)
    fast = sched.step_time_s(sched.running["j0"])
    sched.cluster.set_straggler(next(iter(sched.cluster.hosts)), 3.0)
    spec = _job(c, "j1", 8)
    return [fast, sched.step_time_s(sched.running["j0"]),
            sched.stragglers_to_migrate(), sched.launch_overhead_s(spec),
            sched.launch_overhead_s(dataclasses.replace(spec, job_id="j2"))]


def layouts_and_profiles(c):
    from importlib import import_module

    cm = import_module(f"{c.__name__}.costmodel")
    out = []
    for arch in ("internlm2-1.8b", "mamba2-1.3b", "qwen3-moe-235b-a22b",
                 "qwen2.5-32b", "gemma3-27b", "llava-next-mistral-7b"):
        out.append((cm.recommended_layout(arch), cm.compile_overhead_s(arch),
                    _plain(c.analytic_profile(arch, "train_4k"))))
    return out


def _sim_jobs(c, n, chips=16, policy="spread", steps=200):
    return [_job(c, f"j{i}", chips, policy=policy, steps=steps)
            for i in range(n)]


def simulator_co_scheduling(c):
    out = []
    for co in (False, True):
        sim = c.Simulator(c.ClusterSpec(n_pods=2, hosts_per_pod=8),
                          co_schedule=co)
        for j in _sim_jobs(c, 6):
            sim.submit_at(0.0, j)
        out.append(sim.run())
    return out


def simulator_policies(c):
    prof = c.RooflineProfile(flops=1e15, hbm_bytes=1e12, ici_bytes=5e12)
    out = []
    for pol in ("spread", "minhost", "auto"):
        sim = c.Simulator(c.ClusterSpec(n_pods=2, hosts_per_pod=8))
        sim.submit_at(0.0, _job(c, "c", 32, policy=pol,
                                arch="qwen3-moe-235b-a22b", steps=50,
                                profile=prof))
        for j in _sim_jobs(c, 3, chips=8, policy=pol, steps=100):
            sim.submit_at(1.0, j)
        out.append(sim.run())
    return out


def simulator_faults(c):
    out = []
    sim = c.Simulator(c.ClusterSpec(n_pods=2, hosts_per_pod=8))
    sim.submit_at(0.0, _job(c, "f", 32, steps=500, checkpoint_every=50))
    sim.fail_host_at(200.0, "pod0/host000")
    out.append(sim.run())
    for migrate in (False, True):
        sim = c.Simulator(c.ClusterSpec(n_pods=2, hosts_per_pod=8),
                          migrate_stragglers=migrate)
        sim.submit_at(0.0, _job(c, "s", 16, policy="minhost", steps=2000,
                                checkpoint_every=100))
        sim.straggle_at(100.0, "pod0/host000", 10.0)
        out.append(sim.run())
    sim = c.Simulator(c.ClusterSpec(n_pods=1, hosts_per_pod=5))
    sim.submit_at(0.0, _job(c, "e", 16, steps=300, checkpoint_every=50))
    sim.fail_host_at(50.0, "pod0/host000")
    out.append(sim.run())
    sim = c.Simulator(c.ClusterSpec(n_pods=2, hosts_per_pod=8))
    for j in _sim_jobs(c, 4):
        sim.submit_at(0.0, j)
    sim.straggle_at(5.0, "pod0/host000", 2.0)
    sim.fail_host_at(10.0, "pod0/host001")
    sim.heal_host_at(20.0, "pod0/host001")
    out.append(sim.run())
    out.append(sim.util_trace)
    return out


SCENARIOS = [offers_and_policies, scheduler_sequence,
             host_failure_kill_sequence, stragglers_and_overheads,
             layouts_and_profiles, simulator_co_scheduling,
             simulator_policies, simulator_faults]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_core_copy_matches_reference(scenario):
    want = _plain(scenario(_core("repro")))
    got = _plain(scenario(_core("repro_torch")))
    assert got == want


def test_simulator_claims_hold_on_the_copy():
    """The paper's headline claim on the copy: co-scheduling roughly halves
    the makespan and lifts utilization."""
    plain, co = simulator_co_scheduling(_core("repro_torch"))
    assert co["makespan"] < 0.6 * plain["makespan"]
    assert co["avg_utilization"] > 1.4 * plain["avg_utilization"]
