"""Spawned worlds of ranks for the port's distributed tests.

A world is ``n`` processes (``python -c`` of a worker, or a command), one
torch thread each, joined by ``torch.distributed`` over gloo through a
``file://`` rendezvous.  Every test file that spawns worlds goes through
``spawn_world``:

- each spawn has a rendezvous file of its own (a fresh name under the
  test's tmp dir), so no two worlds can meet in one file;
- a rank's stdout and stderr go to files, never to pipes: a rank that
  writes more than a pipe holds cannot stall while the harness waits on
  another rank;
- one deadline covers the whole world (``WORLD_TIMEOUT``), and gloo's
  per-collective timeout (``COLLECTIVE_TIMEOUT``) sits inside it, so a
  stuck collective ends its rank with gloo's error before the harness
  kills the world;
- a world that fails raises ``WorldFailed`` with every rank's exit code,
  its time and the tail of its stderr.

The timeouts come from the measured time of a world under load: the
slowest world of the sharded-serving module, run beside the heavy test
files and a whole second suite on six workers each, took 60 s on an
8-core machine; a world now has ten times that, and a collective five.

Workers start with ``WORKER_HEADER``, which puts ``src`` and ``tests`` on
``sys.path``, pins one thread and joins the group (``rank``, ``world``,
``out_dir`` bound); ``write_record`` / ``read_records`` pass a case's
result from rank 0 to the test, one file a case, so a world that fails
part way still hands over the cases it finished.

Workers end with ``WORKER_FOOTER``: a rank that ran its code to the end
flushes its output and leaves with ``os._exit(0)``, so no interpreter exit
runs after it.  A ``DeviceMesh`` (and whatever keeps one: a forward
function, a shard function, a step cache) keeps its process groups alive
past ``destroy_process_group()``, and with them gloo's worker threads.  A
worker thread drops its reference to a finished collective after the
waiting rank has moved on; if the interpreter is finalizing by then, the
tensor's Python object can only be released by taking the GIL, which
CPython 3.12 answers by ending the thread with ``pthread_exit``, whose
unwind through a ``noexcept`` frame calls ``std::terminate``: the rank dies
of SIGABRT ("terminate called without an active exception") after its
work is done.  A rank that raises leaves the same way, with exit code 1,
once its traceback is printed (``WORKER_HEADER``'s ``sys.excepthook``).
"""
import json
import os
import subprocess
import sys
import textwrap
import time
import uuid

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD_TIMEOUT = 600  # seconds for one spawned world, every rank included
COLLECTIVE_TIMEOUT = 300  # gloo's bound on one collective

WORKER_HEADER = """
import json, os, sys, traceback
from datetime import timedelta
sys.path.insert(0, "src")
sys.path.insert(0, "tests")


def _leave_on_error(*exc):
    sys.stdout.flush()
    sys.stderr.flush()
    os.write(2, "".join(traceback.format_exception(*exc)).encode())
    os._exit(1)


sys.excepthook = _leave_on_error
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from torch_worlds import write_record

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out_dir = os.environ["DIR"]
dist.init_process_group(
    "gloo", init_method=os.environ["INIT"], rank=rank, world_size=world,
    timeout=timedelta(seconds=float(os.environ["COLLECTIVE_TIMEOUT"])))
"""

WORKER_FOOTER = """
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


class WorldFailed(AssertionError):
    pass


def write_record(out_dir, name, rec, rank=0):
    """Rank ``rank``'s record of case ``name`` (JSON), written at once."""
    path = os.path.join(out_dir, f"case-{name}.rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)


def read_records(out_dir, rank=0) -> dict:
    """{case name: record} of every case rank ``rank`` wrote."""
    out = {}
    suffix = f".rank{rank}.json"
    for f in sorted(os.listdir(out_dir)):
        if f.startswith("case-") and f.endswith(suffix):
            with open(os.path.join(out_dir, f)) as fh:
                out[f[len("case-"):-len(suffix)]] = json.load(fh)
    return out


def _tail(path, n=3000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def spawn_world(n, out_dir, code=None, argv=None, env=None,
                timeout=WORLD_TIMEOUT, name="world"):
    """``n`` ranks of ``python -c WORKER_HEADER + code + WORKER_FOOTER``
    (or of ``argv``), run from the repo root with ``src`` on
    ``PYTHONPATH``; ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``DIR``
    (``out_dir``), ``INIT`` (a fresh rendezvous) and
    ``COLLECTIVE_TIMEOUT`` in the environment.
    Every rank must exit 0 within ``timeout`` seconds.  Returns the ranks'
    stdout."""
    out_dir = str(out_dir)
    tag = f"{name}-{uuid.uuid4().hex[:8]}"
    base = dict(os.environ, WORLD_SIZE=str(n), DIR=out_dir,
                INIT=f"file://{out_dir}/{tag}.rendezvous",
                COLLECTIVE_TIMEOUT=str(COLLECTIVE_TIMEOUT),
                OMP_NUM_THREADS="1", PYTHONPATH=os.path.join(ROOT, "src"),
                **(env or {}))
    cmd = argv or [sys.executable, "-c", textwrap.dedent(WORKER_HEADER)
                   + textwrap.dedent(code) + WORKER_FOOTER]
    logs = [(os.path.join(out_dir, f"{tag}.rank{r}.out"),
             os.path.join(out_dir, f"{tag}.rank{r}.err")) for r in range(n)]
    procs = []
    t0 = time.monotonic()
    try:
        for r, (o, e) in enumerate(logs):
            with open(o, "w") as fo, open(e, "w") as fe:
                procs.append(subprocess.Popen(
                    cmd, cwd=ROOT, stdout=fo, stderr=fe,
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
        deadline = t0 + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    elapsed = time.monotonic() - t0
    rcs = [p.returncode for p in procs]
    if any(rcs):
        detail = "\n".join(f"--- rank {r} exit {rc}:\n{_tail(e)}"
                           for r, (rc, (_, e)) in enumerate(zip(rcs, logs)))
        raise WorldFailed(f"{name}: {n} ranks, exits {rcs} after "
                          f"{elapsed:.1f} s (limit {timeout} s)\n{detail}")
    outs = []
    for o, _ in logs:
        with open(o) as f:
            outs.append(f.read())
    return outs
