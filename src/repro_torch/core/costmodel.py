"""Roofline cost model: job step-time as a function of placement.

This is where the paper's Spread-vs-MinHost tension becomes quantitative on
TPU (DESIGN.md §2):

* **Comm locality** — collectives on the "pod" axis pay DCN (12.5 GB/s/host)
  instead of ICI (50 GB/s/chip).  Packing (MinHost) keeps traffic on ICI.
* **Host contention** — chips are dedicated, but the *host* CPU (input
  pipeline) and the host DCN NIC are shared by co-located jobs.  Spreading
  onto whole, otherwise-idle hosts avoids it.
* **Stragglers** — a gang runs at the pace of its slowest host.

Profiles come from the dry-run artifact when available (exact HLO numbers,
see launch/roofline.py) and from ``analytic_profile`` otherwise.

step_time = max(compute, memory, infeed) + (ici + dcn) * (1 - overlap)
(overlap=0 is the paper-faithful baseline; compute/comm overlap is a
beyond-paper optimization recorded separately in EXPERIMENTS.md §Perf.)
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

from . import hw
from .jobs import JobSpec, RooflineProfile

INFEED_BW_PER_HOST = 2e9  # bytes/s of host-CPU input pipeline


# ---------------------------------------------------------------- profiles
def analytic_profile(arch: str, shape: str) -> RooflineProfile:
    """Closed-form roofline estimate for one (arch, shape) cell."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config(arch)
    sh = SHAPES[shape]
    n_active = cfg.param_count(active_only=True)
    n_total = cfg.param_count()
    b, s = sh.global_batch, sh.seq_len
    lk = cfg.layer_kinds()
    n_attn = sum(1 for k in lk if k in ("attn", "moe", "local", "global"))

    def attn_flops(tokens_q, tokens_k):
        return 4.0 * n_attn * cfg.num_heads * cfg.head_dim * tokens_q * tokens_k

    if sh.kind == "train":
        tokens = b * s
        flops = 6.0 * n_active * tokens + 3 * attn_flops(tokens, s / 2)
        hbm = 30.0 * n_total + 4.0 * tokens * cfg.d_model * 2
        # DP gradient all-reduce (~2x payload, bf16) + per-layer TP collectives
        ici = 4.0 * n_total * 2.0 + 4.0 * tokens * cfg.d_model * 2
        infeed = tokens * 4.0
        if cfg.input_mode == "embeddings":  # vlm: patch embeds stream in
            infeed = tokens * cfg.d_model * 2.0
    elif sh.kind == "prefill":
        tokens = b * s
        flops = 2.0 * n_active * tokens + attn_flops(tokens, s / 2)
        hbm = 2.0 * n_total + 4.0 * tokens * cfg.d_model * 2
        ici = 2.0 * tokens * cfg.d_model * 2
        infeed = tokens * 4.0
        if cfg.input_mode == "embeddings":
            infeed = tokens * cfg.d_model * 2.0
    else:  # decode: one token per sequence against a seq_len cache
        tokens = b
        kv_bytes = (2 * n_attn * cfg.num_kv_heads * cfg.head_dim * s * b * 2.0
                    if cfg.num_heads else 0.0)
        if cfg.ssm is not None:
            nh = cfg.ssm.n_heads(cfg.d_model)
            kv_bytes += (cfg.num_layers * b * nh * cfg.ssm.head_dim
                         * cfg.ssm.d_state * 4.0)
        flops = 2.0 * n_active * tokens + 2.0 * kv_bytes  # cache dot ~ 2F/byte
        hbm = 2.0 * n_total + kv_bytes
        ici = 2.0 * tokens * cfg.d_model * 2.0
        infeed = tokens * 4.0
    return RooflineProfile(flops=flops, hbm_bytes=hbm, ici_bytes=ici,
                           dcn_bytes=0.0), infeed


def load_dryrun_profiles(path: str) -> dict:
    """Optional exact profiles from the dry-run artifact (roofline.json)."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        rows = json.load(f)
    out = {}
    for r in rows:
        if (r.get("skipped") or r.get("error")
                or r.get("tag", "baseline") != "baseline"
                or r.get("mesh") != "single"):
            continue
        key = (r["arch"], r["shape"])
        out[key] = RooflineProfile(
            flops=r["hlo_flops"], hbm_bytes=r["hlo_bytes"],
            ici_bytes=r["collective_bytes"], dcn_bytes=0.0)
    return out


# --------------------------------------------------------------- step time
@dataclass(frozen=True)
class PlacementView:
    """What the cost model needs to know about where a job landed."""

    chips: int
    n_hosts: int
    n_pods: int
    max_host_slowdown: float = 1.0
    # mean number of jobs sharing this job's hosts (>=1)
    host_sharing: float = 1.0


def step_time(profile: RooflineProfile, infeed_bytes: float,
              view: PlacementView, *, overlap: float = 0.0,
              dp_fraction_cross_pod: float | None = None) -> dict:
    """Returns the roofline terms (seconds) and the combined step time."""
    chips = max(view.chips, 1)
    compute = profile.flops / (chips * hw.PEAK_FLOPS_BF16)
    memory = profile.hbm_bytes / (chips * hw.HBM_BW)
    ici = profile.ici_bytes / (chips * hw.ICI_BW)
    # DCN: the DP gradient/activation sync that crosses pods.  By default,
    # spanning P pods sends the (P-1)/P share of the DP all-reduce over DCN.
    dcn_bytes = profile.dcn_bytes
    if view.n_pods > 1:
        frac = ((view.n_pods - 1) / view.n_pods
                if dp_fraction_cross_pod is None else dp_fraction_cross_pod)
        dcn_bytes = max(dcn_bytes, profile.ici_bytes * frac)
    dcn = dcn_bytes / max(view.n_hosts, 1) / (hw.DCN_BW_PER_HOST
                                              / max(view.host_sharing, 1.0))
    infeed = (infeed_bytes * view.host_sharing
              / (max(view.n_hosts, 1) * INFEED_BW_PER_HOST))
    comm = (ici + dcn) * (1.0 - overlap)
    t = (max(compute, memory, infeed) + comm) * view.max_host_slowdown
    return {"compute_s": compute, "memory_s": memory, "infeed_s": infeed,
            "ici_s": ici, "dcn_s": dcn, "step_s": t,
            "bottleneck": max(
                [("compute", compute), ("memory", memory),
                 ("infeed", infeed), ("collective", ici + dcn)],
                key=lambda kv: kv[1])[0]}


def job_profile(spec: JobSpec, dryrun_profiles: dict | None = None):
    """(profile, infeed_bytes) for a job, preferring dry-run numbers."""
    _, infeed = analytic_profile(spec.arch, spec.shape)
    if spec.profile is not None:
        return spec.profile, infeed
    if dryrun_profiles:
        p = dryrun_profiles.get((spec.arch, spec.shape))
        if p is not None:
            return p, infeed
    return analytic_profile(spec.arch, spec.shape)[0], infeed


def recommended_layout(arch: str, *, tokens_per_step: float = 1e6) -> str:
    """Pick the parallelism layout from the job profile (§Perf H3).

    Napkin: pure-DP pays one grad all-reduce (~4·N bytes/step) while TP
    pays per-layer activation all-reduces (~4·L·tokens·d_model·2 bytes,
    measured 240 GB/dev on internlm2). DP wins while params are small
    relative to the activation stream — measured crossover ~4B params for
    1M-token steps (internlm2 1.7B: 7.0× faster under dp).
    """
    from repro_torch.configs import get_config

    n = get_config(arch).param_count()
    return "dp" if n < 4e9 * (tokens_per_step / 1e6) else "tp"


def compile_overhead_s(arch: str) -> float:
    """XLA compile + dispatch setup — the container-creation analogue."""
    from repro_torch.configs import get_config

    n = get_config(arch).param_count() / 1e9
    return hw.COMPILE_BASE_S + hw.COMPILE_PER_GPARAM_S * n
