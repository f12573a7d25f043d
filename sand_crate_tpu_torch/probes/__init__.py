"""Kernel-design probes on the card: the port of the repository's ``tools/``
probes that hold Pallas kernels.

Each module is named after its tool and holds the tool's kernel as a
hand-written CUDA kernel of ``csrc/probes.cu`` (built by ``nvcc`` at first
use, with ``-fmad=false``), its plain torch version, a wrapper that sends CPU
tensors to the plain version and CUDA tensors to the kernel (counted in
:data:`LAUNCHES`; tensors elsewhere raise), the tool's input preparation in
torch, and ``main``, which prints the lines the tool prints, timed by CUDA
events:

* :mod:`.bf16_probe` (P4, ``tools/bf16_probe.py``): dependent mul-add chains
  in f32, packed bf16x2 and an f32-mask / bf16 mix — the issue rates.
* :mod:`.hybrid_probe` (P3, ``tools/hybrid_probe.py``): the pass-B fold
  chain, f32 against hybrid bf16.
* :mod:`.pmajor_probe` (P1, ``tools/pmajor_probe.py``): dense 128-self x
  3W candidate pair tiles on the p-major slab.
* :mod:`.passa_probe` (P2, ``tools/passa_probe.py``): the cost split of the
  grid pass A over the lo slots.

    python -m sand_crate_tpu_torch.probes.<name> [args]   # on the card

Every kernel performs the same IEEE operations in the same order as its
plain version, so the two agree bit for bit on the same inputs.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import cuda_build

# Kernel launches since the last reset, counted by the wrappers where they
# launch a CUDA kernel (never for the plain versions).
LAUNCHES = {
    "bf16_chain_f32": 0, "bf16_chain_bf16": 0, "bf16_mixed": 0,
    "hybrid_f32": 0, "hybrid_bf16": 0,
    "pmajor_probe_a": 0, "pmajor_probe_b": 0,
    "passa_full": 0, "passa_nostencil": 0, "passa_bf16": 0, "passa_nooutdma": 0,
    "passa_plane0": 0, "passa_tiny": 0, "passa_novel": 0, "passa_prefetch": 0,
}


def load_lib() -> ctypes.CDLL:
    lib = cuda_build.load("probes")
    if lib.sc_probe_chain.argtypes is None:  # pointers as c_void_p, never 32-bit ints
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sc_probe_chain.argtypes = [vp, vp, i, i, i, f, f, vp]
        lib.sc_probe_hybrid.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
        lib.sc_probe_pmajor.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.sc_probe_passa.argtypes = [vp, vp, vp, vp, vp] + [i] * 11 + [vp]
        for fn in (lib.sc_probe_chain, lib.sc_probe_hybrid, lib.sc_probe_pmajor,
                   lib.sc_probe_passa):
            fn.restype = ctypes.c_int
    return lib


def dispatch(who: str, *tensors: torch.Tensor) -> bool:
    """True to run the plain version (every tensor on the CPU), False to
    launch the kernel (every tensor on one CUDA device); raises otherwise."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"{who}: the operands must share one device, got {sorted(map(str, kinds))}")
    device = kinds.pop()
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"{who}: no kernel for tensors on {device}")


def run_kernel(label: str, fn, *args, device) -> None:
    """Launch one entry point of csrc/probes.cu on ``device``'s current
    stream; raise on a launch error, else count the launch."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{label} kernel failed: cudaError {err}")
    LAUNCHES[label] += 1


def require_card(who: str, crate=None) -> torch.device:
    """The CUDA device for a probe's ``main`` (``crate``'s, when it is given
    a settled crate): a probe measures the card and has no CPU fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who} measures the CUDA device and none is available")
    if crate is None:
        return torch.device("cuda")
    device = crate.state.pos.device
    if device.type != "cuda":
        raise RuntimeError(f"{who} measures the CUDA device; the crate is on {device}")
    return device


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back (round to nearest even): the plain
    versions write out every rounding that the kernels make."""
    return x.to(torch.bfloat16).to(torch.float32)
