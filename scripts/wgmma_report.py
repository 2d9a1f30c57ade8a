"""Whether ptxas kept the warpgroup products of the port's kernels
asynchronous, for one checkout or several.

Builds the named libraries of each checkout given anew (into its own
``build/``) with ``nvcc -Xptxas -v`` through ``kernels/_build.py``,
prints ptxas's performance notes (``C75xx``: "wgmma.mma_async
instructions are serialized due to ..."), and from ``cuobjdump -sass`` of
each built library, per kernel with warpgroup products: its ``HGMMA``
count and its ``WARPGROUP.DEPBAR`` waits.  A kernel whose products ptxas serialized has
a wait after every product; one that kept them asynchronous, a wait per
group of products.

    python3 scripts/wgmma_report.py . build/variant \\
        --libs decode_attention_d128,paged_attention_d128

Needs nvcc and cuobjdump (the CUDA toolkit), not a card.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

LIBS = "decode_attention_d128,paged_attention_d128,flash_attention_d128"


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return "/usr/local/cuda/bin/cuobjdump"


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
    except OSError:
        return list(names)
    return out if len(out) == len(names) else list(names)


def report(checkout: Path, libs) -> None:
    """Builds ``libs`` of ``checkout`` in a fresh process (each checkout
    imports its own ``kernels/_build.py``) and prints its notes and SASS
    counts."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from repro_torch.kernels import _build;"
        "names = tuple(sys.argv[2].split(','));"
        "[_build._target(n).unlink(missing_ok=True) for n in names];"
        "paths = _build.build_all(names);"
        "[print('LIB', n, p) for n, p in paths.items()];"
        "[print('LOG', l) for log in _build.build_logs.values()"
        " for l in log.splitlines() if 'C75' in l]")
    proc = subprocess.run([sys.executable, "-c", code,
                           str(checkout / "src"), ",".join(libs)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{checkout}: build failed\n{proc.stderr[-4000:]}")
    print(f"== {checkout}", flush=True)
    notes = [ln[4:] for ln in proc.stdout.splitlines()
             if ln.startswith("LOG ")]
    mangled = re.compile(r"'(_Z\w+)'")
    for note in notes:
        m = mangled.search(note)
        name = _demangle([m.group(1)])[0] if m else ""
        print(f"[ptxas] {note.split(':', 1)[-1].strip()[:150]} :: "
              f"{name[:150]}", flush=True)
    if not notes:
        print("[ptxas] no performance notes", flush=True)
    for line in proc.stdout.splitlines():
        if not line.startswith("LIB "):
            continue
        _, lib, path = line.split(" ", 2)
        sass = subprocess.run([_cuobjdump(), "-sass", path],
                              capture_output=True, text=True).stdout
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        names = _demangle([f.split("\n", 1)[0].strip() for f in funcs])
        for name, body in zip(names, funcs):
            hgmma = len(re.findall(r"\bHGMMA\b", body))
            if not hgmma:
                continue
            waits = len(re.findall(r"WARPGROUP\.DEPBAR", body))
            short = name.replace("(anonymous namespace)::", "")
            print(f"[sass] {lib}: {short.split('(')[0][:120]}: {hgmma} "
                  f"HGMMA, {waits} WARPGROUP.DEPBAR", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+", type=Path)
    ap.add_argument("--libs", default=LIBS,
                    help=f"comma-separated libraries (default: {LIBS})")
    args = ap.parse_args(argv)
    for checkout in args.checkouts:
        report(checkout.resolve(), args.libs.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
