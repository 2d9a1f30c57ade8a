"""Multi-pod dry run: trace one rank's step of every (arch x shape) cell on
the production meshes and count its roofline terms on H100 constants.

The counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell ahead of time on placeholder devices and reads the
partitioned HLO; here a fake world of 256 or 512 ranks
(``launch/mesh.fake_world``) gives the production mesh, and rank 0 runs
the port's real step once on the meta device under ``TraceCounter``
(``launch/roofline.py``): nothing is allocated, no collective moves a
byte, no kernel runs (the wrappers' meta branch records each kernel's
work) and no card is needed.  The counts are taken from the traced ops,
not from HLO; the row keeps the keys the copied scheduler reads
(``core/costmodel.load_dryrun_profiles``: ``hlo_flops``, ``hlo_bytes``,
``collective_bytes``), so it consumes the port's rows unchanged.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch internlm2-1.8b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Rows go to ``artifacts/roofline_torch.json`` (never the reference's
``artifacts/roofline.json``), written after each cell; a cell that fails
is recorded with its error and the run goes on.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import SHAPES, get_config, list_archs
from ..core import h100
from ..models import LM, RuntimeKnobs
from ..optim import AdamWConfig
from ..runtime.steps import (init_train_state, make_prefill_step,
                             make_serve_step, make_train_step)
from ..sharding.rules import (batch_shardings, grad_shardings, head_layout,
                              local_caches, local_cfg, make_shard_fn,
                              mesh_coord, mesh_sizes, param_shapes,
                              shard_block, shard_params,
                              train_state_shardings)
from .mesh import fake_world, make_production_mesh
from .roofline import TraceCounter, model_flops, roofline

REFERENCE_OUT = os.path.join("artifacts", "roofline.json")
DEFAULT_OUT = os.path.join("artifacts", "roofline_torch.json")

# The reference's: <25B ZeRO-1 (params replicated over data, opt
# sharded); >=25B FSDP (the params cut over "data" too).
FSDP_THRESHOLD = 25e9

# The reference's per-arch overrides of the baseline: qwen2.5's 40 heads
# do not divide the 16-way model axis, so smaller microbatches and
# tighter attention/CE chunks.
ARCH_OVERRIDES = {
    "qwen2.5-32b": {"grad_accum": 16, "q_chunk": 256, "ce_chunk": 512},
}


def _dp_size(mesh) -> int:
    sizes = mesh_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def build_knobs(cfg, mesh, args) -> RuntimeKnobs:
    """The reference's knobs: bf16 params, compute and cache, the chunks,
    remat, ``causal_skip`` and the mesh's seams (``sp``, ``layout``)."""
    return RuntimeKnobs(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16, q_chunk=args.q_chunk,
        ce_chunk=args.ce_chunk, remat=not args.no_remat,
        causal_skip=getattr(args, "causal_skip", False),
        shard_fn=make_shard_fn(mesh, cfg, sp=getattr(args, "sp", False),
                               layout=getattr(args, "layout", "tp")))


def _meta_inputs(cfg, b: int, s: int) -> dict:
    """A (b, s) batch on the meta device: tokens, and embeddings for an
    embeddings-input arch."""
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                   device="meta")}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = torch.empty((b, s, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    return batch


def _rank_rows(batch, mesh, layout):
    """This rank's rows of ``batch`` (``batch_shardings``): views."""
    specs = batch_shardings(mesh, batch, layout)
    sizes, coord = mesh_sizes(mesh), mesh_coord(mesh)
    return {k: shard_block(v, specs[k], sizes, coord)
            for k, v in batch.items()}


def _nbytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values())


def lower_cell(cfg, sh, mesh, args, counter: TraceCounter) -> dict:
    """Run one step of ``cfg`` at shape ``sh`` as this rank of ``mesh``
    runs it, on the meta device under ``counter`` (its ``args`` counted
    first).  Returns the cell's settings (``fsdp``, ``grad_accum``, ...).
    Train: ``ShardedTrainStep`` over the ZeRO shardings (FSDP above
    ``FSDP_THRESHOLD``; bf16 moments and accumulators above 100B params),
    the global batch given, the rank's rows counted; prefill:
    ``make_prefill_step`` on the rank's rows; decode: ``make_serve_step``,
    one token against a ``seq_len`` cache at the serving rules' shard
    shapes, every slot at the last row."""
    layout = getattr(args, "layout", "tp")
    knobs = build_knobs(cfg, mesh, args)
    fsdp = cfg.param_count() > FSDP_THRESHOLD
    huge = cfg.param_count() > 100e9
    meta = {"fsdp": fsdp, "grad_accum": 1}
    b, s = sh.global_batch, sh.seq_len
    if sh.kind == "train":
        grad_accum = args.grad_accum
        if grad_accum <= 0:
            grad_accum = (32 if huge else 8) if sh.global_batch >= 64 else 1
        grad_accum = min(grad_accum, sh.global_batch // _dp_size(mesh)) or 1
        meta["grad_accum"] = grad_accum
        moments = torch.bfloat16 if huge else torch.float32
        accum = (torch.bfloat16 if huge or getattr(args, "accum_bf16", False)
                 else torch.float32)
        meta["moments_dtype"] = str(moments).replace("torch.", "")
        model = LM(cfg, knobs, device="meta")
        shapes = param_shapes(cfg)
        specs = train_state_shardings(mesh, cfg, shapes, fsdp=fsdp,
                                      layout=layout)
        state = init_train_state(model, torch.Generator(), moments,
                                 shardings=specs)
        step = make_train_step(model, AdamWConfig(), grad_accum,
                               accum_dtype=accum,
                               grad_shardings=grad_shardings(mesh, cfg,
                                                             shapes),
                               state_shardings=specs)
        batch = _meta_inputs(cfg, b, s)
        counter.track_args(state, batch)
        # the step takes the global batch on every rank: only the rank's
        # rows are its argument bytes
        counter.args_bytes += (_nbytes(_rank_rows(batch, mesh, layout))
                               - _nbytes(batch))
        with counter:
            step(state, batch)
        return meta
    sizes, coord = mesh_sizes(mesh), mesh_coord(mesh)
    fn = knobs.shard_fn
    local = LM(local_cfg(cfg, sizes, coord.get("model", 0), fn.cuts)
               if sizes.get("model", 1) > 1 else cfg, knobs, device="meta")
    full = LM(cfg, knobs, device="meta")
    params = shard_params(full.init(torch.Generator()), mesh, cfg)
    if sh.kind == "prefill":
        batch = _rank_rows(_meta_inputs(cfg, b, s), mesh, "tp")
        batch = {k: v.contiguous() for k, v in batch.items()}
        counter.track_args(params, batch)
        with counter:
            make_prefill_step(local)(params, batch)
        return meta
    rows = _rank_rows({"tokens": torch.empty((b, 1), dtype=torch.int32,
                                             device="meta")}, mesh, "tp")
    kv = head_layout(cfg, sizes, coord.get("model", 0), fn.cuts)[1]
    caches = local_caches(mesh, full.init_cache(b, s), paged=False,
                          kv_heads=kv[1] - kv[0], device="meta")
    tokens = rows["tokens"].contiguous()
    counter.track_args(params, caches, tokens)
    with counter:
        make_serve_step(local)(params, caches, tokens, s - 1)
    return meta


def _apply_overrides(arch, args):
    ov = ARCH_OVERRIDES.get(arch, {})
    if ov and getattr(args, "tag", "baseline") == "baseline":
        d = vars(args).copy()
        d.update(ov)
        args = argparse.Namespace(**d)
    return args


def trace_cell(cfg, sh, mesh, args, *, pod_size: int = 0) -> dict:
    """The row fields of one traced cell (everything ``run_cell`` adds
    after the arch, shape and mesh names)."""
    n_dev = mesh.size()
    counter = TraceCounter(pod_size=pod_size)
    t0 = time.perf_counter()
    meta = lower_cell(cfg, sh, mesh, args, counter)
    trace_s = time.perf_counter() - t0
    c = counter.summary()
    terms = roofline(c["flops_by_class"], c["hbm_bytes"], c)
    mf = model_flops(cfg, sh)
    hbm = c["mem_args_bytes"] + c["mem_temp_bytes"]
    row = dict(
        n_devices=n_dev, trace_s=round(trace_s, 1), n_ops=c["n_ops"],
        **meta,
        hlo_flops_per_dev=c["flops"], hlo_bytes_per_dev=c["hbm_bytes"],
        hlo_flops=c["flops"] * n_dev, hlo_bytes=c["hbm_bytes"] * n_dev,
        flops_by_class=c["flops_by_class"],
        matmul_flops_per_dev=c["matmul_flops"], kernels=c["kernels"],
        collective_bytes=c["collective_bytes"] * n_dev,
        collective_bytes_per_dev=c["collective_bytes"],
        nvlink_bytes_per_dev=c["nvlink_bytes"],
        network_bytes_per_dev=c["network_bytes"],
        per_kind=c["per_kind"], by_span=c["by_span"],
        n_collectives=c["n_collectives"],
        model_flops=mf,
        useful_flops_ratio=round(mf / max(c["flops"] * n_dev, 1.0), 4),
        mem_args_bytes=c["mem_args_bytes"],
        mem_temp_bytes=c["mem_temp_bytes"],
        mem_saved_bytes=c["mem_saved_bytes"],
        hbm_per_dev_gb=round(hbm / 1e9, 3),
        fits_hbm=bool(hbm <= h100.HBM_BYTES),
        **{k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in terms.items()},
    )
    return row


def run_cell(arch: str, shape_name: str, mesh_kind: str, args) -> dict:
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if shape_name == "long_500k" and not cfg.supports_long_context:
        row["skipped"] = ("pure full-attention arch "
                          "(DESIGN.md §Arch-applicability)")
        return row
    multi = mesh_kind == "multipod"
    args = _apply_overrides(arch, args)
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi)
        row.update(trace_cell(cfg, sh, mesh, args,
                              pod_size=256 if multi else 0))
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--ce-chunk", type=int, default=1024)
    ap.add_argument("--grad-accum", type=int, default=-1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel residual stream")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp"],
                    help="dp = replicate weights, all axes to batch")
    ap.add_argument("--causal-skip", action="store_true",
                    help="recursive causal block-skip attention")
    ap.add_argument("--accum-bf16", action="store_true",
                    help="bf16 gradient accumulators")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(REFERENCE_OUT):
        ap.error(f"{REFERENCE_OUT} is the reference's dry-run artifact; "
                 f"the port writes its own (default {DEFAULT_OUT})")
    return args


def main(argv=None):
    args = parse_args(argv)
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    selected = {(a, s, m, args.tag) for a in archs for s in shapes
                for m in meshes}
    if args.force:  # re-run ONLY the selected cells; keep everything else
        rows = [r for r in rows
                if (r["arch"], r["shape"], r["mesh"],
                    r.get("tag", "baseline")) not in selected]
    done = {(r["arch"], r["shape"], r["mesh"], r.get("tag", "baseline"))
            for r in rows}
    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                if (arch, shape, mesh_kind, args.tag) in done:
                    continue
                try:
                    row = run_cell(arch, shape, mesh_kind, args)
                except Exception as e:  # record the failure, keep going
                    row = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                row["tag"] = args.tag
                rows.append(row)
                with open(args.out, "w") as f:
                    json.dump(rows, f, indent=1, default=str)
                status = ("SKIP" if row.get("skipped") else
                          ("FAIL" if row.get("error") else "ok"))
                extra = ""
                if status == "ok":
                    extra = (f"flops/dev={row['hlo_flops_per_dev']:.3e} "
                             f"bneck={row['bottleneck']} "
                             f"hbm={row['hbm_per_dev_gb']}GB "
                             f"trace={row['trace_s']}s")
                elif status == "FAIL":
                    extra = row["error"][:160]
                print(f"[{status}] {arch} x {shape} x {mesh_kind} {extra}",
                      flush=True)
    print(f"[done] {len(rows)} rows in {args.out}, "
          f"{time.perf_counter() - t_all:.1f}s", flush=True)
    return rows


if __name__ == "__main__":
    main()
