"""Time the chunked decode kernel's rows at one head dim on its routed plan
against the CUDA-core plan of the same build, for checkouts in turns.

For each checkout given (a copy under ``build/`` with a constant edited is
a variant), in a fresh process: build the head dim's dense and paged
libraries, print ptxas's report of the routed instances, run
``chip_smoke.py``'s phase 3h and 3r decode checks at that head dim
(H = KV = 32: f32, bf16 and 1-byte pools against the plain versions, the
bitwise claims), then time #1 and #3 at T = 1 and the verify block and #2
and #5 at 2 splits, f32 and bf16 caches and pools, at phase 3's shape, on
``decode_route``'s route and on the CUDA cores (the route forced), in turns
cc, route, route, cc, cc, route (medians of three).  Compare designs only
inside one run.

    python3 scripts/route_ab.py --head-dim 64 --t 9 . build/variant .

Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

MARK = "ROUTE_AB "


def turn(root: str, d: int, t_verify: int) -> None:
    sys.path[:0] = [root, root + "/src"]
    import torch

    import chip_smoke as c
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as tdecode
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda)

    c.phase_device()
    names = [_build.lib_name(s, d) for s in ("decode_attention",
                                             "paged_attention")]
    t0 = time.perf_counter()
    _build.build_all(names)
    print(f"[route_ab] build {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in sorted(_build.build_logs.items()):
        for kern, v in sorted(c._ptxas_report(log).items()):
            if "mma" in kern or "tc_decode" in kern:
                print(f"[route_ab] ptxas {src}: {kern}: {v[0]} registers, "
                      f"{v[2]} B spill stores", flush=True)
    routed = tdecode.decode_route
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    with c._heads(32, 32, d):
        c._head_dim_checks(d)
        c._row_decode_checks((t_verify,))
        rows = {}
        for kd in (f32, bf16):
            tag = "" if kd == f32 else "_bf16"
            for t in (1, t_verify):
                q, k, v, pos = c._inputs(t, f32, kd)
                rows[f"1{tag}_t{t}"] = (
                    lambda a=(q, k, v, pos): tdecode.decode_attention_cuda(*a))
                a = c._paged_inputs(t, f32, kd)
                rows[f"3{tag}_t{t}"] = (
                    lambda a=a: paged_decode_attention_cuda(*a))
            q, k, v, pos = c._inputs(1, f32, kd)
            rows[f"2{tag}"] = lambda a=(q, k, v, pos): \
                tdecode.decode_attention_splitk_cuda(*a, num_splits=2)
            a = c._paged_inputs(1, f32, kd)
            rows[f"5{tag}"] = lambda a=a: \
                paged_decode_attention_splitk_cuda(*a, num_splits=2)
        times = {n: {"cc": [], "route": []} for n in rows}
        try:
            for tn in ("cc", "route", "route", "cc", "cc", "route"):
                tdecode.decode_route = routed if tn == "route" else (
                    lambda g, hd, kd: "cuda_cores")
                for n, fn in rows.items():
                    times[n][tn].append(c._time_ms(fn))
        finally:
            tdecode.decode_route = routed
        for n, ms in times.items():
            out[n] = (statistics.median(ms["cc"]),
                      statistics.median(ms["route"]))
    print(MARK + json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--t", type=int, default=9, help="the verify block's T")
    ap.add_argument("--out", default="build/route_ab")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        turn(args.turn, args.head_dim, args.t)
        return 0
    res = {}
    for i, root in enumerate(args.checkouts):
        proc = subprocess.run(
            [sys.executable, __file__, "--turn", root, "--head-dim",
             str(args.head_dim), "--t", str(args.t)],
            capture_output=True, text=True)
        label = f"{i}:{Path(root).resolve().name}"
        log = Path(f"{args.out}_{i}.log")
        log.parent.mkdir(parents=True, exist_ok=True)
        log.write_text(proc.stdout + proc.stderr)
        found = [ln[len(MARK):] for ln in proc.stdout.splitlines()
                 if ln.startswith(MARK)]
        if proc.returncode or not found:
            print(f"{label} failed: exit {proc.returncode}; see {log}\n"
                  f"{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        res[label] = json.loads(found[0])
        for ln in proc.stdout.splitlines():
            if ln.startswith("[route_ab]"):
                print(f"{label} {ln}", flush=True)
    for name in next(iter(res.values())):
        print(f"{name:10s} " + "  ".join(
            f"{label}: cc {r[name][0]:.4f} route {r[name][1]:.4f} "
            f"({r[name][1] / r[name][0]:.3f})" for label, r in res.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
