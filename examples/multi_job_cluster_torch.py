"""Scylla in action over the PyTorch port: a multi-tenant 2-pod cluster
serving a mixed job queue.

The twin of ``examples/multi_job_cluster.py`` over ``repro_torch.core``:
DRF offer negotiation, policy-driven placement (Spread / MinHost /
cost-model Auto), co-scheduling, a host failure with checkpoint-rollback
restart, and a straggler migration, over the assigned (arch x shape)
workloads, using the port's dry-run profiles when
artifacts/roofline_torch.json exists (``python -m
repro_torch.launch.dryrun --all``).

    PYTHONPATH=src python examples/multi_job_cluster_torch.py
"""
from repro_torch.core import ClusterSpec, JobSpec, Simulator
from repro_torch.core.costmodel import load_dryrun_profiles


def main():
    profiles = load_dryrun_profiles("artifacts/roofline_torch.json")
    if profiles:
        print(f"loaded {len(profiles)} exact dry-run profiles")
    sim = Simulator(ClusterSpec(n_pods=2, hosts_per_pod=8),
                    co_schedule=True, dryrun_profiles=profiles,
                    compile_cache=True, migrate_stragglers=True)

    workload = [
        (0.0, JobSpec("train-moe", "mixtral-8x7b", "train_4k", chips=32,
                      policy="auto", steps=400, framework="research")),
        (0.0, JobSpec("serve-27b", "gemma3-27b", "decode_32k", chips=16,
                      policy="minhost", steps=5000, framework="serving")),
        (10.0, JobSpec("train-small", "internlm2-1.8b", "train_4k",
                       chips=8, policy="spread", steps=800,
                       framework="research")),
        (20.0, JobSpec("long-ctx", "mamba2-1.3b", "long_500k", chips=4,
                       policy="minhost", steps=2000, framework="serving")),
        (30.0, JobSpec("train-vlm", "llava-next-mistral-7b", "train_4k",
                       chips=16, policy="auto", steps=300,
                       framework="research")),
    ]
    for t, spec in workload:
        sim.submit_at(t, spec)
    sim.fail_host_at(500.0, "pod0/host002")
    sim.straggle_at(800.0, "pod1/host001", 5.0)

    results = sim.run()
    print(f"\n{'job':12s} {'policy':14s} {'hosts':>5s} {'wait_s':>8s} "
          f"{'run_s':>9s} {'restarts':>8s}")
    for jid, j in sorted(results["jobs"].items()):
        print(f"{jid:12s} {j.spec.policy:14s} {j.n_hosts:5d} "
              f"{max(0, j.start_time - j.submit_time):8.1f} "
              f"{j.finish_time - j.start_time:9.1f} {j.restarts:8d}")
    print(f"\nmakespan          {results['makespan']:.0f}s")
    print(f"avg utilization   {results['avg_utilization'] * 100:.0f}%")
    print(f"total restarts    {results['restarts']}")
    print("\nevent log (first 20):")
    for t, kind, jid in sim.events_log[:20]:
        print(f"  t={t:8.1f}  {kind:8s} {jid}")


if __name__ == "__main__":
    main()
