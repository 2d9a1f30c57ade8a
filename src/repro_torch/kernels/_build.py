"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each library ``<name>`` becomes ``build/kernels/<name>-<hash>.so`` under
the repository root (a directory ``.gitignore`` lists), compiled for
``sm_90a`` on first use.  The attention sources (``csrc/{decode,paged,
flash}_attention.cu``) build once per head dim, as the libraries
``<source>_d<D>`` compiled with ``-DHEAD_DIM=<D>`` (``lib_name``);
``csrc/ssd_scan.cu`` builds once.  The hash covers the source, every
shared header in ``csrc/`` (``*.cuh``) and the flags, so an edited source
or header rebuilds.  ``build_all`` starts one ``nvcc`` per library, all at
once, and keeps each build's output, with ptxas's registers, stack and
spills of every kernel (``-Xptxas -v``), in ``build_logs``.  Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("decode_attention", "paged_attention", "flash_attention",
           "ssd_scan")
HEAD_DIMS = (64, 80, 128)  # the attention libraries' head dims
_PER_HEAD_DIM = SOURCES[:3]
LIBS = tuple(f"{src}_d{d}" for src in _PER_HEAD_DIM
             for d in HEAD_DIMS) + ("ssd_scan",)

_LOADED: dict = {}
build_seconds: dict = {}  # name -> wall seconds of the last nvcc run
build_logs: dict = {}  # name -> output of the last nvcc run


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def lib_name(source: str, head_dim: int) -> str:
    """The library of attention ``source`` built for ``head_dim``."""
    return f"{source}_d{head_dim}"


def _source(name: str):
    """(source file, extra nvcc flags) of library ``name``."""
    src, _, d = name.rpartition("_d")
    if src in _PER_HEAD_DIM and d.isdigit():
        return CSRC / f"{src}.cu", (f"-DHEAD_DIM={d}",)
    return CSRC / f"{name}.cu", ()


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + _source(name)[1]


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [_source(name)[0], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=LIBS) -> dict:
    """Compile every named library that has no up-to-date build, one
    ``nvcc`` process per library, all started together.  Returns
    ``{name: library path}``; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        lib = _target(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
               str(_source(name)[0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _LOADED[name] = lib
    return lib
