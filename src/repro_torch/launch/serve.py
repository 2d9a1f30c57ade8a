"""Serving launcher: seeded random weights for an arch, then the batched
decode engine over a synthetic request stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --requests 8 --device cuda

Runs on the card by default; ``--device cpu`` runs the same path with the
kernels' plain versions.  ``--smoke`` takes the arch's reduced config.
``--mode continuous`` (default) admits per slot with chunked prefill;
``--mode wave`` runs the lockstep baseline.  ``--cache paged`` swaps the
dense per-slot stripes for the paged pool (``--page-size``,
``--num-pages``, ``--page-policy pack|spread``, ``--no-prefix-cache``);
admission then reserves only the pages a request can touch and a shared
prompt prefix is read from the pages that hold it.  ``--policy`` picks the
admission policy and ``--tenants N`` spreads the requests round-robin
over N tenants.  ``--arch gemma3-27b`` serves the grouped plan (local
layers under their window, global ones without), ``--arch mixtral-8x7b``
and ``--arch qwen3-moe-235b-a22b`` the MoE FFN; every cache layout and
``--speculate`` apply to them as to the uniform archs, and to granite-20b
(48 query heads on one KV head) and qwen2.5-32b (5 per KV head) on the
CPU.  On the card the launcher serves neither of these two: at full
depth their f32 weights (80 and 131 GB) do not fit one card, and their
``--smoke`` configs have head dim 16, which no kernel is built for.
``chip_smoke.py`` serves both at full width and a cut depth through
``ServeEngine`` (its phases 11 and 12).
``--arch mamba2-1.3b`` serves the SSM plan and ``--arch zamba2-2.7b``
the hybrid plan (mamba2 layers and a shared attention block): their
prompts are fed token by token and a slot's state (and zamba2's K/V
stripes) is zeroed on admission; they take no ``--cache paged`` and no
``--speculate``.
``--kv-dtype int8|fp8`` (with ``--cache paged``) stores the pools
quantized.  Weights come from the port's own
init (``torch.Generator`` seeded with ``--seed``), f32 params and f32
cache as in the reference launcher.

``--temperature/--top-k/--top-p/--sample-seed`` set the per-request
sampling params (temperature 0 = greedy; ``--sample-seed`` is the
reference launcher's ``--seed``, which here names the weight seed).
``--speculate`` turns on speculative decode (``--draft-k N`` tokens per
slot per tick, ``--drafter`` from ``runtime.draft.DRAFTERS``) and prints
the draft acceptance rate.  ``--preempt`` lets the scheduler revoke slots
(``--victim-policy``), and ``--tenant-weights "tenant-0=3,tenant-1=1"``
maps SLO tiers onto weighted-DRF shares.

``--replicas N`` (N > 1, or any ``--fault-schedule``) fronts N engine
replicas (one model and its weights, shared) with a
``runtime.cluster.ClusterRouter``: requests are placed through
``--router-policy pack|spread`` offers, a lost replica is found by
heartbeat (``--miss-threshold``) and its requests are replayed on the
survivors (``--retry-budget`` replays a request).  ``--fault-schedule``
injects chaos, as ``TICK:ACTION:REPLICA[:ARG[:TICKS]]`` entries (e.g.
``"6:kill:1,14:rejoin:1"``) or ``"seed=SEED"``; the run asserts that no
request was lost.  ``--roles "prefill=N,decode=M[,unified=K]"`` splits the
pool by role (the counts sum to ``--replicas``) behind a
``runtime.disagg.DisaggRouter``, which hands each finished prefill's K/V
to a decode slot; ``--autoscale-policy queue-depth|slo-backlog`` attaches
a ``runtime.autoscale.Autoscaler`` (``--min-replicas``/``--max-replicas``
per role, ``--scale-cooldown``; a ``--max-replicas`` above a role's count
adds cold spares).  ``--trace-out PATH`` writes the run's Chrome trace,
``--metrics-out PATH`` the final metrics (``.prom``: Prometheus text,
else JSON), and ``--flight-recorder N`` dumps the last N trace events to
``artifacts/`` when a replica is fenced.  On the card the cluster serves
the full configs (``--smoke`` configs have head dim 16, which no kernel is
built for):

    python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --replicas 2 --cache paged --fault-schedule "6:kill:1,14:rejoin:1"

``--tp N`` shards the engine over N ranks (tensor parallel, the mesh
``(1, N)``); ``--mesh-shape D,M`` (or ``P,D,M``) gives the whole mesh,
whose leading data axes shard the decode slots and the KV page pool.  The
launcher then runs under ``torchrun``, one process per rank::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch internlm2-1.8b --tp 2

On the card every rank takes a card of its own (``cuda:LOCAL_RANK``,
NCCL), and a world larger than the visible cards raises; ``--device cpu``
runs the ranks over gloo.  ``--dist-init`` names the process group's
rendezvous (default ``env://``, which torchrun sets).  Rank 0 prints the
report.  ``--replicas``, ``--roles`` and ``--fault-schedule`` build every
replica over the mesh, and every rank runs the router; its straggler
watchdog reads rank 0's clock (``runtime.serve.MeshWatchdog``), so the
ranks flag the same steps and place alike.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import leave_world
from repro_torch.models import LM, RuntimeKnobs
from repro_torch.runtime.autoscale import AUTOSCALE_POLICIES, Autoscaler
from repro_torch.runtime.cluster import ROUTER_POLICIES, ClusterRouter
from repro_torch.runtime.disagg import ROLES, DisaggRouter
from repro_torch.runtime.draft import DRAFTERS
from repro_torch.runtime.fault import ReplicaFaultInjector
from repro_torch.runtime.scheduler import ADMISSION_POLICIES, VICTIM_POLICIES
from repro_torch.runtime.serve import (Request, SamplingParams, ServeConfig,
                                       ServeEngine, mesh_watchdogs)
from repro_torch.runtime.telemetry import Telemetry


def parse_tenant_weights(spec: str) -> dict:
    """``"gold=3,free=1"`` -> ``{"gold": 3.0, "free": 1.0}``; a malformed
    entry or a weight <= 0 raises ``ValueError`` (an argparse usage
    error)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, w = part.partition("=")
        name = name.strip()
        if not eq or not name:
            raise ValueError(f"expected TENANT=WEIGHT, got {part!r}")
        weight = float(w)
        if weight <= 0:
            raise ValueError(f"weight for {name!r} must be > 0, "
                             f"got {weight}")
        out[name] = weight
    return out


def parse_roles(spec: str) -> dict:
    """``"prefill=2,decode=1"`` -> ``{"prefill": 2, "decode": 1}``; an
    unknown role, a duplicate or a count <= 0 raises ``ValueError`` (an
    argparse usage error)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        role, eq, n = part.partition("=")
        role = role.strip()
        if not eq or role not in ROLES:
            raise ValueError(f"expected ROLE=COUNT with ROLE in "
                             f"{'/'.join(ROLES)}, got {part!r}")
        if role in out:
            raise ValueError(f"role {role!r} listed twice")
        count = int(n)
        if count <= 0:
            raise ValueError(f"count for {role!r} must be > 0, "
                             f"got {count}")
        out[role] = count
    if not out:
        raise ValueError("empty --roles spec")
    return out


def parse_mesh_shape(spec: str) -> tuple:
    """``"2,4"`` -> ``(2, 4)``: a (data, model) or (pod, data, model)
    mesh shape.  Raises ``ValueError`` (an argparse usage error) on junk
    so bad shapes fail at the CLI, not at engine construction."""
    try:
        shape = tuple(int(p) for p in spec.split(","))
    except ValueError:
        raise ValueError(f"expected comma-separated ints, got {spec!r}")
    if len(shape) not in (2, 3) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape must be D,M or P,D,M of positive "
                         f"ints, got {spec!r}")
    return shape


def _init_mesh_world(args, n: int) -> str:
    """Join the process group of an ``n``-rank mesh (``RANK`` and
    ``WORLD_SIZE`` from the environment, as torchrun sets them): NCCL with
    a card per rank, gloo on the CPU.  Returns the rank's device.  A world
    larger than the visible cards raises: no rank moves to another
    backend or to the CPU."""
    import torch.distributed as dist

    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = args.device
    if args.device == "cuda":
        visible = torch.cuda.device_count()
        if max(world, n) > visible:
            raise ValueError(f"mesh shape needs {max(world, n)} devices, "
                             f"{visible} visible (one card per rank)")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if args.device == "cuda" else "gloo",
            init_method=args.dist_init, rank=rank, world_size=world)
    return device


def _check_cluster_args(ap, args) -> None:
    """The reference launcher's checks of the cluster flags."""
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1 (got {args.replicas})")
    if args.roles is not None:
        total = sum(args.roles.values())
        if total != args.replicas:
            ap.error(f"--roles counts sum to {total} but --replicas is "
                     f"{args.replicas}; pass --replicas {total}")
        have = set(args.roles)
        if not have & {"prefill", "unified"}:
            ap.error("--roles needs a prefill-capable role "
                     "(prefill or unified)")
        if not have & {"decode", "unified"}:
            ap.error("--roles needs a decode-capable role "
                     "(decode or unified)")
        if args.mode != "continuous":
            ap.error(f"--roles needs --mode continuous "
                     f"(got {args.mode!r})")
    elif args.autoscale_policy is not None:
        ap.error("--autoscale-policy needs --roles")
    if args.autoscale_policy is None:
        for flag, val in (("--min-replicas", args.min_replicas),
                          ("--max-replicas", args.max_replicas),
                          ("--scale-cooldown", args.scale_cooldown)):
            if val is not None:
                ap.error(f"{flag} needs --autoscale-policy")
        return
    min_r = 1 if args.min_replicas is None else args.min_replicas
    if min_r < 1:
        ap.error(f"--min-replicas must be >= 1 (got {min_r})")
    if min_r > min(args.roles.values()):
        ap.error(f"--min-replicas {min_r} exceeds the smallest initial "
                 f"role count {min(args.roles.values())}")
    if (args.max_replicas is not None
            and args.max_replicas < max(args.roles.values())):
        ap.error(f"--max-replicas {args.max_replicas} is below the "
                 f"largest initial role count {max(args.roles.values())}")
    if args.scale_cooldown is not None and args.scale_cooldown < 0:
        ap.error(f"--scale-cooldown must be >= 0 "
                 f"(got {args.scale_cooldown})")


def _make_router(args, model, params, serve_cfg, tm):
    """The reference launcher's router (and autoscaler) over
    ``ServeEngine`` replicas of one model, or None for a single engine."""
    injector = (ReplicaFaultInjector.parse(args.fault_schedule)
                if args.fault_schedule else None)
    common = dict(policy=args.router_policy,
                  miss_threshold=args.miss_threshold,
                  retry_budget=args.retry_budget,
                  tenant_weights=args.tenant_weights or {},
                  injector=injector, telemetry=tm)
    if args.roles is None:
        if args.replicas == 1 and not args.fault_schedule:
            return None
        return ClusterRouter(lambda rid: ServeEngine(model, params,
                                                     serve_cfg),
                             args.replicas, **common)
    # the role of each rid; indices past a role's initial count are cold
    # DOWN spares the autoscaler can rejoin under load
    cap = (args.max_replicas if args.autoscale_policy
           and args.max_replicas is not None else None)
    role_list, start_down = [], []
    for role, count in args.roles.items():
        for i in range(max(count, cap or 0)):
            if i >= count:
                start_down.append(len(role_list))
            role_list.append(role)

    def make_role_engine(rid):
        return ServeEngine(model, params, dataclasses.replace(
            serve_cfg, role=role_list[rid]))

    router = DisaggRouter(make_role_engine, len(role_list), roles=role_list,
                          start_down=start_down, **common)
    if args.autoscale_policy:
        router.autoscaler = Autoscaler(
            router, args.autoscale_policy,
            min_replicas=(1 if args.min_replicas is None
                          else args.min_replicas),
            max_replicas=cap,
            cooldown=(10 if args.scale_cooldown is None
                      else args.scale_cooldown),
            telemetry=tm)
    return router


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--mode", choices=("continuous", "wave"),
                    default="continuous")
    ap.add_argument("--cache", choices=("dense", "paged"), default="dense")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool size (default: dense-equivalent capacity)")
    ap.add_argument("--page-policy", choices=("pack", "spread"),
                    default="pack")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--kv-dtype", choices=("", "int8", "fp8"), default="",
                    help="quantized paged pools (with --cache paged)")
    ap.add_argument("--policy", choices=sorted(ADMISSION_POLICIES),
                    default="fcfs", help="admission policy")
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread requests over N tenants (round-robin)")
    ap.add_argument("--tenant-weights", type=parse_tenant_weights,
                    default=None,
                    help="weighted-DRF SLO tiers, e.g. 'tenant-0=3,"
                         "tenant-1=1' (unlisted tenants weigh 1)")
    ap.add_argument("--preempt", action="store_true",
                    help="enable slot preemption (checkpoint/restore)")
    ap.add_argument("--victim-policy", choices=sorted(VICTIM_POLICIES),
                    default="youngest-first")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=None,
                    help="per-request sampling seed (default: request id)")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative multi-token decode (see --draft-k)")
    ap.add_argument("--draft-k", type=int, default=3,
                    help="draft tokens per slot per tick (with --speculate)")
    ap.add_argument("--drafter", choices=sorted(DRAFTERS), default="ngram")
    ap.add_argument("--replicas", type=int, default=1,
                    help="front N engine replicas with a ClusterRouter")
    ap.add_argument("--router-policy", choices=sorted(ROUTER_POLICIES),
                    default="spread",
                    help="replica placement policy (with --replicas > 1)")
    ap.add_argument("--roles", type=parse_roles, default=None,
                    metavar="ROLE=N,...",
                    help="disaggregate the pool: 'prefill=N,decode=M"
                         "[,unified=K]' (counts must sum to --replicas)")
    ap.add_argument("--autoscale-policy",
                    choices=sorted(AUTOSCALE_POLICIES), default=None,
                    help="attach an elastic autoscaler (needs --roles)")
    ap.add_argument("--min-replicas", type=int, default=None,
                    help="per-role floor for scale-down (default 1)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="per-role ceiling; above a role's initial count "
                         "this provisions cold spares for scale-up")
    ap.add_argument("--scale-cooldown", type=int, default=None,
                    help="ticks a role is frozen after a scale event "
                         "(default 10)")
    ap.add_argument("--fault-schedule", default=None,
                    metavar="T:ACT:R[,...]|seed=N",
                    help="inject chaos: 'TICK:ACTION:REPLICA[:ARG[:TICKS]]"
                         ",...' or 'seed=SEED' (forces the router path)")
    ap.add_argument("--miss-threshold", type=int, default=3,
                    help="heartbeat misses before a replica is LOST")
    ap.add_argument("--retry-budget", type=int, default=3,
                    help="recovery replays per request before it fails")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's Chrome trace-event JSON here")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the final metrics snapshot here "
                         "(.prom = Prometheus text, else JSON)")
    ap.add_argument("--flight-recorder", type=int, default=0, metavar="N",
                    help="arm the flight recorder: dump the last N trace "
                         "events + metrics to artifacts/ on replica fence")
    ap.add_argument("--tp", type=int, default=1,
                    help="shard the engine over N ranks (tensor parallel; "
                         "shorthand for --mesh-shape 1,N)")
    ap.add_argument("--mesh-shape", type=parse_mesh_shape, default=None,
                    metavar="D,M",
                    help="the engine's mesh 'data,model' (or "
                         "'pod,data,model'); data axes shard the decode "
                         "slots + KV page pool across hosts")
    ap.add_argument("--dist-init", default="env://",
                    help="process group rendezvous of a mesh's ranks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="weight init seed")
    args = ap.parse_args(argv)
    if args.speculate and args.draft_k <= 0:
        ap.error(f"--speculate needs --draft-k >= 1 (got {args.draft_k})")
    if args.kv_dtype and args.cache != "paged":
        ap.error(f"--kv-dtype {args.kv_dtype} needs --cache paged")
    _check_cluster_args(ap, args)
    if args.tp < 1:
        ap.error(f"--tp must be >= 1 (got {args.tp})")
    if args.tp > 1 and args.mesh_shape is not None:
        ap.error("--tp is shorthand for --mesh-shape 1,N — pass one "
                 "or the other")
    mesh_shape = (args.mesh_shape if args.mesh_shape is not None
                  else ((1, args.tp) if args.tp > 1 else None))
    if mesh_shape is not None and args.mode != "continuous":
        ap.error(f"--mesh-shape/--tp need --mode continuous "
                 f"(got {args.mode!r})")
    if mesh_shape is None:
        return _serve(args, args.device, None)
    import torch.distributed as dist

    device = _init_mesh_world(args, int(np.prod(mesh_shape)))
    try:
        if int(os.environ.get("RANK", "0")) == 0:
            return _serve(args, device, mesh_shape)
        with contextlib.redirect_stdout(io.StringIO()):
            return _serve(args, device, mesh_shape)
    except BaseException:  # on success the world stays: leave_world
        dist.destroy_process_group()
        raise


def _serve(args, device, mesh_shape):
    """Build the model and the engine (or the router), serve the request
    stream and print the report."""
    cfg = get_config(args.arch, smoke=args.smoke)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device=device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    serve_cfg = ServeConfig(
        batch_slots=args.slots, max_len=args.max_len, mode=args.mode,
        prefill_chunk=args.prefill_chunk, cache=args.cache,
        page_size=args.page_size, num_pages=args.num_pages,
        page_policy=args.page_policy, kv_dtype=args.kv_dtype,
        prefix_cache=not args.no_prefix_cache, policy=args.policy,
        tenant_weights=args.tenant_weights, preempt=args.preempt,
        victim_policy=args.victim_policy,
        draft_k=args.draft_k if args.speculate else 0,
        drafter=args.drafter, mesh_shape=mesh_shape)
    tm = Telemetry(trace=bool(args.trace_out) or args.flight_recorder > 0,
                   flight=args.flight_recorder, flight_dir="artifacts")
    router = _make_router(args, model, params, serve_cfg, tm)
    if router is not None and mesh_shape is not None:
        # every rank runs the router: its straggler flags follow rank 0's
        # clock, so that the ranks place alike
        mesh_watchdogs(router, model.device)
    if router is None:
        engine = ServeEngine(model, params, serve_cfg, telemetry=tm)
    front = router if router is not None else engine
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.sample_seed)
    rng = np.random.default_rng(0)
    handles = []
    for i in range(args.requests):
        plen = int(rng.integers(1, 6))
        handles.append(front.submit(Request(
            i, rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new, sampling=sampling,
            tenant=f"tenant-{i % max(args.tenants, 1)}", priority=i % 3)))
    t0 = time.perf_counter()
    done = front.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    ttft = [t for t in (h.metrics().get("ttft_s") for h in handles)
            if t is not None]
    mesh_note = (f" mesh={'x'.join(map(str, mesh_shape))}"
                 if mesh_shape else "")
    print(f"arch={args.arch} mode={args.mode} cache={args.cache} "
          f"device={model.device} policy={args.policy}{mesh_note} "
          f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s)")
    if router is not None:
        _print_cluster(args, router, done)
    if args.preempt and router is None:
        print(f"preemptions: {engine.scheduler.preempted_total} "
              f"(requests preempted >=1x: "
              f"{sum(1 for r in done if r.preempt_count)})")
    if args.speculate and router is None:
        st = engine.spec_stats()
        print(f"speculative: draft_k={st['draft_k']} "
              f"acceptance {st['acceptance_rate']:.2f} "
              f"({st['accepted']}/{st['proposed']}), "
              f"{st['tokens_per_tick']:.2f} tok/tick")
    if ttft:
        print(f"ttft p50 {np.percentile(ttft, 50) * 1e3:.0f}ms / "
              f"p99 {np.percentile(ttft, 99) * 1e3:.0f}ms "
              f"(finish reasons: "
              f"{sorted({r.finish_reason for r in done})})")
    if router is None and engine.kv is not None:
        print(f"kv stats: {engine.kv_stats()}")
    if args.trace_out:
        path = tm.write_trace(args.trace_out)
        print(f"trace: {tm.trace.total} events ({tm.trace.dropped} "
              f"dropped) -> {path} (open at https://ui.perfetto.dev)")
    if args.metrics_out:
        print(f"metrics: {len(tm.registry.names())} series -> "
              f"{tm.write_metrics(args.metrics_out)}")
    if tm.flight_dumps:
        print(f"flight-recorder dumps: {tm.flight_dumps}")
    return done


def _print_cluster(args, router, done) -> None:
    """The router's lines (and the autoscaler's); no request may be lost
    despite recovery."""
    st = router.stats()
    print(f"cluster: replicas={args.replicas} "
          f"router-policy={args.router_policy} ticks={st['ticks']} "
          f"lost={st['replicas_lost']} recoveries={st['recoveries']} "
          f"brownout-ticks={st['brownout_ticks']} "
          f"finished={len(done)}/{args.requests}")
    lost = [r.req_id for r in done if r.finish_reason == "failed"]
    assert not lost, f"requests lost despite recovery: {lost}"
    if args.roles is not None:
        roles = ",".join(f"{r}={n}" for r, n in args.roles.items())
        print(f"disagg: roles={{{roles}}} "
              f"handoffs={st['handoffs_done']} "
              f"backpressure={st['handoff_backpressure']} "
              f"in-transit={st['handoffs_in_transit']}")
    if getattr(router, "autoscaler", None) is not None:
        asst = router.autoscaler.stats()
        print(f"autoscale: policy={asst['policy']} "
              f"ups={asst['scale_ups']} downs={asst['scale_downs']} "
              f"retiring={asst['retiring']}")


if __name__ == "__main__":
    main()
    leave_world()
