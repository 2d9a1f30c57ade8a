"""The port's dry run (``repro_torch.launch.dryrun``): one rank's real
step traced on the meta device under a fake world.

A smoke config's train, prefill and decode cells at rank 0 of a fake
(2, 4) world, the prefill's flops against a hand count of its products
and the flash kernel's causal count; the sequence-parallel residual's
saved layer boundaries at (1, 4); one full-width cell on the real
production mesh (internlm2-1.8b x decode_32k, 256 ranks) through the
command line; its rows read by the port's ``load_dryrun_profiles``; and
``examples/multi_job_cluster_torch.py`` against the reference's example.
Every fake world runs in a subprocess of its own."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

CELLS = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import parse_args, trace_cell
    from repro_torch.launch.mesh import fake_world, make_serve_mesh

    cfg = get_config("internlm2-1.8b", smoke=True)
    out = {}
    args = parse_args(["--q-chunk", "16", "--ce-chunk", "16"])
    for kind in ("train", "prefill", "decode"):
        with fake_world(8):
            out[kind] = trace_cell(cfg, ShapeSpec(kind, 64, 8, kind),
                                   make_serve_mesh((2, 4)), args)
    deep = dataclasses.replace(cfg, num_layers=8)
    for sp in (False, True):
        a = parse_args(["--q-chunk", "64", "--ce-chunk", "64",
                        "--grad-accum", "1"] + (["--sp"] if sp else []))
        with fake_world(4):
            out["sp" if sp else "tp"] = trace_cell(
                deep, ShapeSpec("sp", 256, 4, "train"),
                make_serve_mesh((1, 4)), a)
    json.dump(out, sys.stdout)
""")


@pytest.fixture(scope="module")
def cells():
    res = subprocess.run([sys.executable, "-c", CELLS], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


def test_smoke_cells_trace_on_a_fake_world(cells):
    """Train (ZeRO over the fake (2, 4) mesh: gathers, reduce-scatters
    and all-reduces), prefill and decode (the seams' all-gathers) each
    count flops, bytes, collectives and memory; prefill reaches the flash
    kernel and decode the dense decode kernel, once a layer."""
    for kind in ("train", "prefill", "decode"):
        row = cells[kind]
        assert row["n_devices"] == 8 and row["hlo_flops_per_dev"] > 0
        assert row["hlo_bytes_per_dev"] > 0 and row["mem_args_bytes"] > 0
        assert row["mem_temp_bytes"] > 0 and row["fits_hbm"]
        assert row["per_kind"]["all-gather"] > 0
        assert row["bottleneck"] in ("compute", "memory", "collective")
        assert row["step_s"] == pytest.approx(
            max(row["compute_s"], row["memory_s"]) + row["collective_s"],
            abs=2e-6)
        assert row["nvlink_bytes_per_dev"] == row["collective_bytes_per_dev"]
    assert set(cells["train"]["per_kind"]) >= {"all-gather", "all-reduce",
                                               "reduce-scatter"}
    assert cells["train"]["kernels"] == {}
    assert cells["train"]["mem_saved_bytes"] > 0
    assert cells["prefill"]["kernels"]["flash_attention"]["calls"] == 4
    assert cells["decode"]["kernels"]["decode_attention"]["calls"] == 4


def test_prefill_flops_equal_a_hand_count(cells):
    """internlm2's smoke config (d 64, 4 heads on 2 KV heads of 16, ff
    128, vocab 256, 4 layers) at rank 0 of (2, 4): 4 rows of 64 tokens
    (batch 8 over "data" 2), one query head, one KV head (several ranks
    read each) and 32 MLP columns a rank; ``wo``, ``w_down`` and the head
    whole (the gather form), the head at the last position only.  The
    products' flops are 2 rows in out each; the flash kernel's its causal
    pairs' 4 hd each."""
    d, hd, h, ff, v, layers = 64, 16, 4, 128, 256, 4
    rows, s = 4, 64
    t = rows * s
    per_layer = (2 * t * d * hd  # q: the rank's head
                 + 2 * 2 * t * d * hd  # k, v: its KV head
                 + 2 * t * h * hd * d  # wo, whole
                 + 2 * 2 * t * d * (ff // 4)  # gate, up: its columns
                 + 2 * t * ff * d)  # w_down, whole
    head = 2 * rows * d * v
    row = cells["prefill"]
    assert row["matmul_flops_per_dev"] == layers * per_layer + head
    attention = layers * 4 * hd * rows * 1 * s * (s + 1) // 2
    assert row["kernels"]["flash_attention"]["flops"] == attention
    assert row["hlo_flops_per_dev"] == layers * per_layer + head + attention


def test_sp_cuts_the_saved_layer_boundaries_by_the_model_axis(cells):
    """The sequence-parallel residual at (1, 4), 8 layers of (4, 256, 64)
    bf16 boundaries: what the forward keeps for the backward shrinks by
    exactly 3/4 of the boundaries (each rank keeps its quarter of the
    sequence), so the step's peak temp falls too; the flops fall (``wo``
    and ``w_down`` run on a quarter of the rows) and all-to-alls
    appear."""
    tp, sp = cells["tp"], cells["sp"]
    boundaries = 8 * 4 * 256 * 64 * 2
    cut = tp["mem_saved_bytes"] - sp["mem_saved_bytes"]
    assert cut == pytest.approx(0.75 * boundaries, rel=1e-3)
    assert sp["mem_temp_bytes"] < 0.6 * tp["mem_temp_bytes"]
    assert sp["hlo_flops_per_dev"] < tp["hlo_flops_per_dev"]
    assert "all-to-all" in sp["per_kind"] and "all-to-all" not in \
        tp["per_kind"]


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "rows.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)], env=ENV, cwd=ROOT, capture_output=True,
        text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    return out, res.stdout


def test_full_width_cell_on_the_production_mesh(production):
    """internlm2-1.8b x decode_32k on the (16, 16) mesh of 256 fake ranks:
    128 slots over "data" (8 a rank), one query head a rank reading one
    of the 8 KV heads, the 32k bf16 cache of its slots and KV head; the
    decode kernel once a layer; the model axis of 16 spans two hosts of
    8, so its gathers go over the network."""
    out, stdout = production
    assert "[ok] internlm2-1.8b x decode_32k x single" in stdout
    (row,) = json.loads(out.read_text())
    assert row["n_devices"] == 256 and row["tag"] == "baseline"
    assert row["kernels"]["decode_attention"]["calls"] == 24
    cache = 24 * 2 * 8 * 32768 * 1 * 128 * 2
    assert row["mem_args_bytes"] > cache
    assert row["nvlink_bytes_per_dev"] == 0
    assert row["network_bytes_per_dev"] == row["collective_bytes_per_dev"] > 0
    assert row["hlo_flops"] == row["hlo_flops_per_dev"] * 256
    assert row["fits_hbm"] and row["bottleneck"] == "memory"


def test_rows_read_by_the_ports_scheduler(production):
    from repro_torch.core.costmodel import load_dryrun_profiles

    out, _ = production
    row = json.loads(out.read_text())[0]
    prof = load_dryrun_profiles(str(out))[("internlm2-1.8b", "decode_32k")]
    assert prof.flops == row["hlo_flops"]
    assert prof.hbm_bytes == row["hlo_bytes"]
    assert prof.ici_bytes == row["collective_bytes"]


def test_refuses_the_references_artifact():
    from repro_torch.launch.dryrun import DEFAULT_OUT, parse_args

    assert parse_args([]).out == DEFAULT_OUT == "artifacts/roofline_torch.json"
    with pytest.raises(SystemExit):
        parse_args(["--out", "artifacts/roofline.json"])


def test_example_twin_prints_the_references_schedule(tmp_path):
    """With no dry-run artifact both examples fall back to the analytic
    profiles: the port's copied core prints the reference's schedule,
    line for line."""
    outs = []
    for name in ("multi_job_cluster.py", "multi_job_cluster_torch.py"):
        res = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                             env=ENV, cwd=tmp_path, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        outs.append(res.stdout)
    assert "makespan" in outs[0] and outs[0] == outs[1]


def test_bf16_moe_trains():
    """The dry run trains every arch at bf16 params, the MoE router among
    them (``init_train_state`` casts it): the router's product upcasts it
    to f32, as the reference's einsum promotes it, so the loss and its
    gradients run on the CPU (the meta device would not check the
    operands' dtypes)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LM, RuntimeKnobs
    from repro_torch.runtime.steps import _value_and_grad, init_train_state

    model = LM(get_config("mixtral-8x7b", smoke=True),
               RuntimeKnobs(param_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    router = state["params"]["blocks"]["stack"]["moe"]["router"]
    assert router.dtype == torch.bfloat16
    loss, met, grads = _value_and_grad(
        model, state["params"], {"tokens": torch.zeros((2, 32),
                                                       dtype=torch.int32)})
    assert torch.isfinite(loss) and float(met["moe_lb_loss"]) > 0
    assert all(torch.isfinite(g.float()).all() for g in grads)
