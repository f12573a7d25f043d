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
# pmajor: -fmad=false keeps every multiply and add separately rounded, so the
# kernel reproduces its plain torch version bit for bit (see csrc/pmajor.cu).
SOURCE_FLAGS = {"pmajor": ("-fmad=false",)}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name -> nvcc/ptxas output of this process's build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME or put nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def load(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` as a loaded library, compiled on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {src.name}:\n"
                f"{res.stdout}{res.stderr}"
            )
        BUILD_LOGS[name] = res.stdout + res.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib
