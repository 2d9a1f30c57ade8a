"""Drift guard: the port keeps its own copies of the reference's jax-free
host modules.  Each copy must equal its reference source apart from lines
that name the package (``repro`` -> ``repro_torch``), the docstring lines
in ``REWORDED`` (history notes that name the reference's change log) and,
in ``configs/base.py``, the documented ``input_specs`` change (it returns
``(shape, torch.dtype)`` pairs instead of jax ShapeDtypeStructs, and the
module docstring says so)."""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
COPIES = sorted(
    [f"configs/{p.name}" for p in (SRC / "repro" / "configs").glob("*.py")]
    + ["core/hw.py", "core/resources.py", "core/drf.py",
       "runtime/draft.py", "runtime/kv_pool.py", "runtime/scheduler.py",
       "runtime/telemetry.py"])


# copy lines allowed to differ from the reference's line at the same place
REWORDED = {
    "runtime/kv_pool.py": ("continuous batching made decode work",),
    "runtime/scheduler.py": ("first come, first served (the original "
                             "behavior).",),
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
