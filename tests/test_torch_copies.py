"""Drift guard: the port keeps its own copies of the reference's jax-free
host modules.  Each copy must equal its reference source apart from lines
that name the package (``repro`` -> ``repro_torch``), the docstring lines
in ``REWORDED`` (history notes that name the reference's change log) and,
in ``configs/base.py``, the documented ``input_specs`` change (it returns
``(shape, torch.dtype)`` pairs instead of jax ShapeDtypeStructs, and the
module docstring says so).  ``runtime/disagg.py`` is no copy but a
counterpart: it may differ from the reference only in its imports, in
``transfer_chain``'s device copy (and that function's docstring) and in
its ``REWORDED`` lines."""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
COPIES = sorted(
    [f"configs/{p.name}" for p in (SRC / "repro" / "configs").glob("*.py")]
    + ["data/pipeline.py"]
    + [f"core/{n}.py" for n in ("hw", "resources", "drf", "jobs", "cluster",
                                "costmodel", "policies", "scheduler",
                                "simulator")]
    + [f"runtime/{n}.py" for n in ("draft", "kv_pool", "scheduler",
                                   "telemetry", "cluster", "autoscale",
                                   "fault")])


# copy lines allowed to differ from the reference's line at the same place
REWORDED = {
    "runtime/kv_pool.py": ("continuous batching made decode work",),
    "runtime/scheduler.py": ("first come, first served (the original "
                             "behavior).",),
    "runtime/fault.py": ("relaunches the job's main process.",
                         "3. The job restores the last checkpoint",
                         "Serving half: ``ReplicaFaultInjector``"),
    "runtime/cluster.py": ("and re-prefilled, and the position-folded",),
    "runtime/autoscale.py": ("Scale events land in the telemetry spine",),
    "runtime/disagg.py": ("replicas behave exactly like a plain",
                          "zero-copy (the preemption"),
}


def _normalise(text):
    return text.replace("repro_torch", "repro").splitlines()


def _without_docstring_and_input_specs(text):
    """Source lines after the module docstring, up to ``input_specs``."""
    tree = ast.parse(text)
    doc_end = tree.body[0].end_lineno
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "input_specs")
    return text.splitlines()[doc_end:fn.lineno - 1]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    ref = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    if rel == "configs/base.py":
        assert _without_docstring_and_input_specs(copy.replace(
            "repro_torch", "repro")) == _without_docstring_and_input_specs(ref)
        assert "import jax" not in copy
    else:
        c, r = _normalise(copy), _normalise(ref)
        assert len(c) == len(r)
        differ = [i for i, (a, b) in enumerate(zip(c, r)) if a != b]
        assert all(any(w in c[i] for w in REWORDED.get(rel, ()))
                   for i in differ), [c[i] for i in differ]


def test_every_reference_config_is_copied():
    ref = {p.name for p in (SRC / "repro" / "configs").glob("*.py")}
    copied = {p.name for p in (SRC / "repro_torch" / "configs").glob("*.py")}
    assert ref == copied


def _imports_and_transfer_chain(tree):
    """Line spans (1-based, inclusive) that the disagg counterpart may
    change: the module's top-level imports after ``from __future__`` and
    the body of ``transfer_chain``."""
    imports = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))
               and getattr(n, "module", None) != "__future__"]
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "transfer_chain")
    return fn, [(imports[0].lineno, imports[-1].end_lineno),
                (fn.lineno, fn.end_lineno)]


def _outside(lines, spans):
    return [line for i, line in enumerate(lines, 1)
            if not any(a <= i <= b for a, b in spans)]


def _transfer_chain_statements(fn):
    """``transfer_chain``'s statements but its docstring and the device
    copy: those from the destination's adoption check to the release of
    the source's hold."""
    body = fn.body[1:]  # fn.body[0] is the docstring
    i = next(j for j, n in enumerate(body) if isinstance(n, ast.If)
             and "new_pages is None" in ast.unparse(n.test))
    k = next(j for j, n in enumerate(body)
             if "release_chain" in ast.unparse(n))
    return [ast.dump(n) for n in body[:i + 1] + body[k:]]


def test_disagg_counterpart_matches_reference():
    ref = (SRC / "repro" / "runtime/disagg.py").read_text()
    port = (SRC / "repro_torch" / "runtime/disagg.py").read_text().replace(
        "repro_torch", "repro")
    r_fn, r_spans = _imports_and_transfer_chain(ast.parse(ref))
    p_fn, p_spans = _imports_and_transfer_chain(ast.parse(port))
    got = _outside(port.splitlines(), p_spans)
    want = _outside(ref.splitlines(), r_spans)
    assert len(got) == len(want)
    differ = [a for a, b in zip(got, want) if a != b]
    assert all(any(w in a for w in REWORDED["runtime/disagg.py"])
               for a in differ), differ
    assert _transfer_chain_statements(p_fn) == _transfer_chain_statements(
        r_fn)
    assert "import jax" not in port and "compiled_fn" not in port
