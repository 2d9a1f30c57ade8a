"""Time kernel rows of checkouts in turns, on one card.

Runs ``chip_smoke.py``'s kernel phases 3, 3p, 3q, 3c, 3g, 3h and 3r (every
check they make, then their timings) of each checkout in a fresh process,
in the order given, and keeps the rows whose names match ``--keep``
(comma-separated shell patterns; by default the rows of the many-row kernel,
#4 ``paged_prefill_attention*`` and #6 ``flash_attention*``, and of the SSD
chunk, #7 ``ssd_chunk*``).  Each checkout builds its kernels into its own
``build/``.  Compare two designs only inside one run, in turns (parent,
change, change, parent): times move between calls.

    python3 scripts/many_row_ab.py --out build/ab.json \\
        --turns parent,change,change,parent \\
        parent=build/parent change=.

    # the chunked decode kernel's rows (#1-#5, every pool dtype)
    python3 scripts/many_row_ab.py --keep '*decode_attention*' ...

prints, per row, each label's times (ms, CUDA events, median of 20 a turn)
with SDPA's and the bound, and writes every turn's rows to ``--out``; each
turn's full output goes to ``<out stem>_<turn>_<label>.log``.  Needs CUDA.
"""
from __future__ import annotations

import argparse
import fnmatch
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("phase_kernels", "phase_paged_kernels", "phase_quant_kernels",
          "phase_forward_kernels", "phase_grouping_kernels",
          "phase_head_dim_kernels", "phase_row_kernels")
KEEP = "paged_prefill_attention*,flash_attention*,ssd_chunk*"
MARK = "MANY_ROW_AB "


def turn(checkout: Path, keep: str = KEEP) -> int:
    """One turn in this process: the checkout's build and kernel phases;
    prints the rows whose names match a pattern of ``keep`` as one JSON
    line after ``MARK``."""
    sys.path[:0] = [str(checkout), str(checkout / "src")]
    import chip_smoke as c

    from repro_torch.kernels import _build

    c.phase_device()
    t0 = time.perf_counter()
    _build.build_all()  # ptxas's report below; a spill is reported, kept
    build_s = time.perf_counter() - t0
    for src, log in sorted(_build.build_logs.items()):
        for kern, (regs, _, st, ld) in sorted(c._ptxas_report(log).items()):
            if "many_row_kernel" in kern or "chunked_decode" in kern:
                print(f"[ab] ptxas {src}: {kern}: {regs} registers, {st} B "
                      f"spill stores, {ld} B spill loads", flush=True)
    patterns = keep.split(",")
    rows = []
    for name in PHASES:
        rows += [r for r in getattr(c, name)()
                 if any(fnmatch.fnmatchcase(r["name"], p) for p in patterns)]
    print(MARK + json.dumps({"build_s": build_s, "rows": rows}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*", metavar="LABEL=DIR")
    ap.add_argument("--turns", default="",
                    help="comma-separated labels, in order (default: each "
                         "checkout once)")
    ap.add_argument("--out", default="build/many_row_ab.json")
    ap.add_argument("--keep", default=KEEP,
                    help="comma-separated shell patterns of the row names "
                         f"to keep (default: {KEEP})")
    ap.add_argument("--turn", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        return turn(Path(args.turn).resolve(), args.keep)
    dirs = dict(c.split("=", 1) for c in args.checkouts)
    order = args.turns.split(",") if args.turns else list(dirs)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    turns = []
    for i, label in enumerate(order):
        log = out.with_name(f"{out.stem}_{i}_{label}.log")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--turn",
             dirs[label], "--keep", args.keep], capture_output=True,
            text=True)
        log.write_text(proc.stdout + proc.stderr)
        found = [ln[len(MARK):] for ln in proc.stdout.splitlines()
                 if ln.startswith(MARK)]
        if proc.returncode or not found:
            print(f"turn {i} ({label}) failed: exit {proc.returncode}; "
                  f"see {log}\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        res = json.loads(found[0])
        print(f"turn {i} {label}: {time.perf_counter() - t0:.1f} s "
              f"(build {res['build_s']:.1f} s)", flush=True)
        turns.append({"label": label, **res})
    out.write_text(json.dumps(turns, indent=1))
    names = list(dict.fromkeys(r["name"] for t in turns for r in t["rows"]))
    labels = list(dict.fromkeys(order))
    for name in names:
        cells = []
        for label in labels:
            got = [r for t in turns if t["label"] == label
                   for r in t["rows"] if r["name"] == name]
            ms = [r["ms"] for r in got]
            if ms:
                cells.append(f"{label} {statistics.median(ms):.4f} "
                             f"[{', '.join(f'{x:.4f}' for x in ms)}] "
                             f"err {max(r['max_abs_err'] for r in got):.3g}")
        ref = next(r for t in turns for r in t["rows"] if r["name"] == name)
        libs = [r["library_ms"] for t in turns for r in t["rows"]
                if r["name"] == name and r["library_ms"] is not None]
        lib = statistics.median(libs) if libs else None
        print(f"{name}: {'; '.join(cells)}; library "
              f"{'none' if lib is None else f'{lib:.4f}'}; bound "
              f"{ref['bound_ms']:.4f} ({ref['bound_by']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
