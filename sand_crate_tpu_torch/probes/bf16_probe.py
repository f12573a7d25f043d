"""P4: packed-bf16 against f32 issue rate on the card.

The port of ``tools/bf16_probe.py``: a pure dependent mul-add chain per
dtype, in planes shaped like the pass kernels' (BLOCKS blocks of ROWS x
COLS), and the mixed shape the hybrid kernel needs (an f32 mask, then bf16
where + mul and bf16 accumulators).  Each element runs LANES independent
chains ``c_k = x * (1 + 0.01 k)``, then ``iters`` x ``c = c * a + b``, then
sums them.  The kernels are ``csrc/probes.cu`` ``chain_f32_kernel`` (a
thread per element), ``chain_bf16_kernel`` (CHAIN_PAIRS packed bf16x2 pairs
a thread, each step one bf16x2 multiply and one add, each rounded once: no
mul+add is contracted into an FMA; ``a`` and ``b`` staged through shared
memory, so that the card issues the steps on two pipes) and
``mixed_kernel``.  ``a`` and ``b``
default to the tool's constants; the hard inputs of ``probe_cases`` set
others.

    python -m sand_crate_tpu_torch.probes.bf16_probe [iters_per_elem]

prints the tool's lines (ms and G(mul+add)/s, counted as the tool counts:
two operations per element and iteration, one chain of the LANES), timed by
CUDA events.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.measure import cuda_ms
from ..ops.pair_kernel import check_cuda
from . import dispatch, load_lib, require_card, run_kernel, to_bf16

ROWS, COLS = 256, 512  # one pass-plane-sized block
BLOCKS = 64
LANES = 8  # independent chains, so the probe is issue-bound, not latency-bound
A = 1.0000001  # the chain's multiplier; bf16(A) is 1.0
B = 1e-7
CHAIN_THREADS = 128  # chain_bf16_kernel's block (kChainThreads)
CHAIN_PAIRS = 2  # and its bf16x2 pairs a thread (kChainPairs)
KINDS = ("f32", "bf16", "mixed")
_LABEL = {"f32": "bf16_chain_f32", "bf16": "bf16_chain_bf16", "mixed": "bf16_mixed"}


def make_input(kind: str, blocks: int = BLOCKS, device="cpu") -> torch.Tensor:
    """The tool's input: uniform [0, 1) from numpy seed 0, (blocks * ROWS,
    COLS), bf16 for the bf16 chains and f32 otherwise."""
    x = np.random.default_rng(0).random((blocks * ROWS, COLS))
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return torch.as_tensor(x, device=device).to(dtype)


def _scale(k: int) -> torch.Tensor:
    return torch.tensor(1.0 + 0.01 * k, dtype=torch.float32)


def chain_plain(x: torch.Tensor, kind: str, iters: int, a: float = A,
                b: float = B) -> torch.Tensor:
    """Plain torch version of the three kernels: f32 operations, with the
    bf16 roundings written out after each operation the kernel does in
    bf16 (the mixed kernel takes no ``b``)."""
    dev = x.device
    a = torch.tensor(a, dtype=torch.float32)
    b = torch.tensor(b, dtype=torch.float32)
    if kind == "f32":
        chains = [x * _scale(k).to(dev) for k in range(LANES)]
        for _ in range(iters):
            chains = [c * a.to(dev) + b.to(dev) for c in chains]
        acc = chains[0]
        for c in chains[1:]:
            acc = acc + c
        return acc
    a16, b16 = to_bf16(a).to(dev), to_bf16(b).to(dev)
    if kind == "bf16":
        xf = x.to(torch.float32)
        chains = [to_bf16(xf * to_bf16(_scale(k)).to(dev)) for k in range(LANES)]
        for _ in range(iters):
            chains = [to_bf16(to_bf16(c * a16) + b16) for c in chains]
        acc = chains[0]
        for c in chains[1:]:
            acc = to_bf16(acc + c)
        return acc.to(torch.bfloat16)
    if kind != "mixed":
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    mb = x > 0.5
    chains = [to_bf16(x * _scale(k).to(dev)) for k in range(LANES)]
    accs = [torch.zeros_like(c) for c in chains]
    for _ in range(iters):
        chains = [torch.where(mb, to_bf16(c * a16), 0.0) for c in chains]
        accs = [to_bf16(ak + c) for ak, c in zip(accs, chains)]
    acc = accs[0]
    for c in accs[1:]:
        acc = to_bf16(acc + c)
    return acc


def chain(x: torch.Tensor, kind: str, iters: int, a: float = A, b: float = B) -> torch.Tensor:
    """One probe kernel (``kind`` f32, bf16 or mixed) over ``x``: CPU tensors
    run :func:`chain_plain`, CUDA tensors launch the kernel of
    ``csrc/probes.cu`` (counted in ``probes.LAUNCHES``)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if dispatch("bf16_probe.chain", x):
        return chain_plain(x, kind, iters, a, b)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    check_cuda("bf16_probe.chain: x", x, dtype, x.shape)
    if x.numel() % 2:
        raise ValueError("bf16_probe.chain: the element count must be even (bf16x2 pairs)")
    out = torch.empty_like(x)
    run_kernel(_LABEL[kind], load_lib().sc_probe_chain, x.data_ptr(), out.data_ptr(),
               KINDS.index(kind), x.numel(), iters, float(a), float(b), device=x.device)
    return out


def operations(kind: str, iters: int, n: int):
    """(f32 operations, bf16 operations) of one call over ``n`` elements."""
    chain_ops = LANES + iters * LANES * 2 + (LANES - 1)  # scale, mul+add, sum
    if kind == "f32":
        return n * chain_ops, 0
    if kind == "bf16":
        return 0, n * chain_ops
    # compare, 8 f32 scale muls and their casts; where + mul + add per step
    return n * (1 + 2 * LANES), n * (LANES * iters * 3 + (LANES - 1))


def io_bytes(kind: str, n: int) -> int:
    """Bytes of one call: the input read once, the output written once."""
    return n * (2 + 2 if kind == "bf16" else 4 + 4)


def main(iters: int = 64, reps: int = 30) -> dict:
    """Time the three kernels on the card; returns {kind: ms}."""
    device = require_card("bf16_probe")
    n = BLOCKS * ROWS * COLS
    print(f"plane {ROWS}x{COLS} x {BLOCKS} blocks, {iters} mul-adds/elem")
    names = {"f32": "f32 chain", "bf16": "bf16 chain", "mixed": "mixed f32-mask/bf16"}
    times = {}
    for kind in KINDS:
        x = make_input(kind, device=device)
        ms = cuda_ms(lambda: chain(x, kind, iters), reps)
        times[kind] = ms
        gops = n * iters * 2 / (ms * 1e-3) / 1e9  # the tool's count: mul+add per iter
        print(f"{names[kind]:22s} {ms:8.3f} ms   {gops:8.1f} G(mul+add)/s", flush=True)
        if kind == "bf16":
            print(f"bf16 speedup over f32: {times['f32'] / times['bf16']:.2f}x")
    return times


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
