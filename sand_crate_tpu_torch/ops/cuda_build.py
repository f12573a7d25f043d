"""Build a CUDA source of ``csrc/`` into a shared library at first use.

Each kernel source has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``sand_crate_tpu_torch/_build/`` (gitignored), then
loaded with ``ctypes``.  ``NVCC_FLAGS`` are shared by every source;
``SOURCE_FLAGS`` holds what one kernel alone needs.  The library name carries
a hash of the source and its flags, so an edited source is rebuilt and a
stale library is never loaded; the write is atomic (rename), so concurrent
first uses are safe.  Nothing here runs at import time: the CPU-only test
machines import this module and never call :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# -fmad=false keeps every multiply and add separately rounded, so the kernels
# reproduce their plain torch versions bit for bit (see each source's note).
SOURCE_FLAGS = {
    "pmajor": ("-fmad=false",), "grid_pair": ("-fmad=false",), "probes": ("-fmad=false",),
    "boundary": ("-fmad=false",), "kick": ("-fmad=false",), "pair_batch": ("-fmad=false",),
    "pm_prep": ("-fmad=false",),
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name -> nvcc/ptxas output of this process's build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME or put nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together."""
    jobs = []
    for name in names:
        so = _library(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:  # wait for every process, then report
        out = proc.communicate()[0]
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` as a loaded library, compiled on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build(name)
    lib = ctypes.CDLL(str(_library(name)))
    _LIBS[name] = lib
    return lib
