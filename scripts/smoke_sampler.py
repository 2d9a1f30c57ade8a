"""Where ``chip_smoke.py``'s wall time goes: run it under a stack sampler.

    python3 scripts/smoke_sampler.py [--out chiprun_out/smoke_samples.json]
                                     [--every 0.05]

A thread reads the main thread's stack every ``--every`` seconds and
counts two keys: the chain of ``chip_smoke.py`` frames (function and
line, outermost first) and the innermost frame of any file.  The JSON
holds the run's wall seconds, the sample count, the seconds a sample
stands for (wall over count) and both tables, most frequent first.  The
script's own exit code is ``chip_smoke.py``'s.  Processes that
``chip_smoke.py`` spawns (launchers, phase-16 ranks) are not sampled:
their time shows as the parent waiting in ``subprocess``/``selectors``.
"""
import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "smoke_samples.json"))
    ap.add_argument("--every", type=float, default=0.05)
    args = ap.parse_args()

    main_tid = threading.get_ident()
    by_stack, by_leaf = collections.Counter(), collections.Counter()
    stop = threading.Event()

    def sample():
        while not stop.wait(args.every):
            f = sys._current_frames().get(main_tid)
            stack, leaf = [], None
            while f is not None:
                code = f.f_code
                if leaf is None:
                    leaf = (f"{os.path.basename(code.co_filename)}:"
                            f"{code.co_name}:{f.f_lineno}")
                if code.co_filename == SMOKE:
                    stack.append(f"{code.co_name}:{f.f_lineno}")
                f = f.f_back
            by_stack[">".join(reversed(stack))] += 1
            by_leaf[leaf] += 1

    sampler = threading.Thread(target=sample, daemon=True)
    t0 = time.perf_counter()
    sampler.start()
    sys.argv = [SMOKE]
    rc = 0
    try:
        runpy.run_path(SMOKE, run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    finally:
        stop.set()
        sampler.join()
        wall = time.perf_counter() - t0
        n = sum(by_stack.values())
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"wall_s": wall, "samples": n,
                       "s_per_sample": wall / max(n, 1),
                       "stacks": by_stack.most_common(),
                       "leaves": by_leaf.most_common()}, fh)
        print(f"[sampler] {wall:.1f} s, {n} samples -> {args.out}",
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
