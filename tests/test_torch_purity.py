"""The port stands alone: importing every module of ``repro_torch`` pulls in
neither jax nor the JAX package, and no source of the port (or
``chip_smoke.py``) imports them.  Plus the small pieces held against the
reference: ``key_data`` and ``pick_decode_splits``."""
import itertools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                        r"import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
                        re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_and_no_reference(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path


def test_key_data_matches_jax_prngkey():
    jax = pytest.importorskip("jax")
    from repro_torch.runtime.sampling import SamplingParams

    for seed in (0, 1, 12345, 2 ** 31 - 1, 2 ** 31 + 5):
        want = np.asarray(jax.random.PRNGKey(seed % (2 ** 31)), np.uint32)
        got = SamplingParams(seed=seed).key_data(7)
        assert got.dtype == np.uint32 and (got == want).all(), seed
    assert (SamplingParams().key_data(42)
            == np.asarray(jax.random.PRNGKey(42), np.uint32)).all()


def test_pick_decode_splits_matches_reference():
    pytest.importorskip("jax")
    from repro.runtime.steps import pick_decode_splits as want
    from repro_torch.runtime.steps import pick_decode_splits as got

    grid = itertools.product((0, 100, 2047, 2048, 4095, 4096, 4200, 8191,
                              16384, 65535), (0, 1, 2, 4, 8, 16),
                             (96, 4096, 8192, 12288), (0, 1, 3, 4, 8),
                             (0, 16))
    for max_pos, batch, max_len, override, page in grid:
        kw = dict(max_len=max_len, page_size=page, override=override)
        assert got(max_pos, batch, **kw) == want(max_pos, batch, **kw), \
            (max_pos, batch, kw)
