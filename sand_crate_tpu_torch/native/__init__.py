"""The host-side C frame rasterizer (``rasterize.c``), built at first use
and bound with ctypes.

The source is compiled with ``gcc -O3 -shared -fPIC`` into the package's
gitignored ``_build/``, beside the CUDA kernels (``ops/cuda_build.py``),
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded; the library is
written under a temporary name and renamed, so concurrent first uses are
safe.  :func:`rasterize_lib` gives the bound library, or None when it
could not be built (``BUILD_ERROR`` then says why); ``render.py`` then
draws with its numpy rasterizer.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from ..ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "rasterize.c"
GCC_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: ctypes.CDLL | None = None
BUILD_ERROR: str | None = None  # why the last build failed, if it did


def build() -> Path:
    """Compile ``rasterize.c`` unless the library of the current source and
    flags exists; returns its path.  Raises if gcc is missing or fails."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GCC_FLAGS).encode())
    so = BUILD_DIR / f"librasterize-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(["gcc", *GCC_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                   capture_output=True, text=True, timeout=120)
    os.replace(tmp, so)
    return so


def rasterize_lib() -> ctypes.CDLL | None:
    """The library with ``rasterize`` bound, or None if it cannot be built.
    A failed build is tried again at the next call."""
    global _lib, BUILD_ERROR
    if _lib is None:
        try:
            so = build()
        except (OSError, subprocess.SubprocessError) as e:
            BUILD_ERROR = f"{type(e).__name__}: {e} {getattr(e, 'stderr', '') or ''}".strip()
            return None
        lib = ctypes.CDLL(str(so))
        lib.rasterize.restype = None
        lib.rasterize.argtypes = [
            ctypes.c_void_p,  # pos (n, 2) f32
            ctypes.c_void_p,  # pressure (n,) f32
            ctypes.c_void_p,  # alive (n,) u8
            ctypes.c_long,  # n
            ctypes.c_void_p,  # segments (s, 2, 2) f32
            ctypes.c_long,  # s
            ctypes.c_long,  # w
            ctypes.c_long,  # h
            ctypes.c_long,  # r_px
            ctypes.c_void_p,  # out (h, w, 3) u8
        ]
        _lib = lib
        BUILD_ERROR = None
    return _lib
