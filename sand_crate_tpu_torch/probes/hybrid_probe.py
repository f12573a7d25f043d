"""P3: the hybrid-bf16 pass-B fold chain against f32, on the card.

The port of ``tools/hybrid_probe.py``: the pass-B fold + symm window chain
on (128, 256) planes, iterated over ``iters`` pseudo-windows per block with
a per-visit perturbation of the self positions, in f32 and in the hybrid
form (an f32 prologue — deltas, cutoff, mask, 1 / sqrt — then the rest of
the chain and the accumulators in bf16).  The kernel is ``csrc/probes.cu``
``hybrid_kernel``: a thread per two candidate columns of a self (any W; an
odd W's last pair holds one column), the chain in registers, packed bf16x2
in the hybrid form, computed for every element and then selected by the
mask.  ``probe_cases`` holds hard inputs.

With the tool's inputs the mask's ``c_rw == s_rw`` compares random floats
and almost never holds, so the outputs are ~all zeros: :func:`main` also
times inputs whose rw columns are 0 (integer-valued; about half the pairs
pass the cutoff), and the two times agree when the kernel skips no work.

    python -m sand_crate_tpu_torch.probes.hybrid_probe [iters]
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from ..ops.measure import cuda_ms
from ..ops.pair_kernel import check_cuda
from . import dispatch, load_lib, require_card, run_kernel, to_bf16

CS, W = 128, 256  # the pass plane: cs x (split * 128)
BLOCKS = 64
EPS = 1e-6
DIAM, TP2 = 0.01, 0.008


def make_inputs(blocks: int = BLOCKS, device="cpu", equal_rw: bool = False):
    """The tool's inputs, (sfeat (blocks * CS, 8), cand (blocks * 8, W)),
    uniform [0, 0.02) from numpy seed 0; ``equal_rw`` sets both rw columns
    to 0, so the mask is the cutoff alone."""
    rng = np.random.default_rng(0)
    sfeat = torch.as_tensor(rng.random((blocks * CS, 8)), dtype=torch.float32) * 0.02
    cand = torch.as_tensor(rng.random((blocks * 8, W)), dtype=torch.float32) * 0.02
    if equal_rw:
        sfeat[:, 7] = 0.0
        cand[7::8] = 0.0
    return sfeat.to(device), cand.to(device)


def perturbations(iters: int) -> torch.Tensor:
    """The per-visit perturbation f32(1e-5 * (it + 1)), (iters,)."""
    return torch.tensor([1e-5 * (it + 1) for it in range(iters)], dtype=torch.float32)


def chain_plain(sfeat: torch.Tensor, cand: torch.Tensor, iters: int, hybrid: bool):
    """Plain torch version of the kernel (the bf16 roundings written out)."""
    f32 = torch.float32
    dev = sfeat.device
    blocks = sfeat.shape[0] // CS
    s = sfeat.reshape(blocks, CS, 8, 1).unbind(2)  # each (B, CS, 1)
    c = cand.reshape(blocks, 8, 1, cand.shape[1]).unbind(1)  # each (B, 1, W)
    diam = torch.tensor(DIAM, dtype=f32, device=dev)
    tp2 = torch.tensor(TP2, dtype=f32, device=dev)
    eps2 = torch.tensor(EPS * EPS, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    ax = ay = zero
    for p in perturbations(iters).to(dev):
        s_px, s_py, s_npx, s_npy = (s[k] + p for k in range(4))
        rx = s_px - c[0]
        ry = s_py - c[1]
        near = rx * rx + ry * ry <= diam * diam
        nrx = s_npx - c[2]
        nry = s_npy - c[3]
        nd2 = torch.maximum(nrx * nrx + nry * nry, eps2)
        mb = near & (c[7] == s[7])
        inv = 1.0 / torch.sqrt(nd2)
        s_tp = s[4] - tp2
        if not hybrid:
            nhx = nrx * inv
            nhy = nry * inv
            align = (s[5] - c[5]) * nhx + (s[6] - c[6]) * nhy
            t = torch.where(mb, align + (c[4] + s_tp), zero)
            ax = ax + t * nhx
            ay = ay + t * nhy
        else:
            b = to_bf16
            inv_h = b(inv)
            nhx = b(b(nrx) * inv_h)
            nhy = b(b(nry) * inv_h)
            align = b(b(b(b(s[5]) - b(c[5])) * nhx) + b(b(b(s[6]) - b(c[6])) * nhy))
            tpf = b(b(c[4]) + b(s_tp))
            t = torch.where(mb, b(align + tpf), zero)
            ax = b(ax + b(t * nhx))
            ay = b(ay + b(t * nhy))
    out = ax + ay
    if hybrid:
        out = to_bf16(out)
    return out.reshape(blocks * CS, -1)


_PERTURB: dict = {}  # (iters, device) -> perturbations(iters) on that device


def _device_perturbations(iters: int, device) -> torch.Tensor:
    """perturbations(iters) on ``device``, copied there once: a copy from
    host memory waits for the stream, and a timed call would count the host
    time of the launch that follows it."""
    key = (iters, str(device))
    if key not in _PERTURB:
        _PERTURB[key] = perturbations(iters).to(device)
    return _PERTURB[key]


def chain(sfeat: torch.Tensor, cand: torch.Tensor, iters: int, hybrid: bool):
    """The probe kernel -> (blocks * CS, W) f32: CPU tensors run
    :func:`chain_plain`, CUDA tensors launch the kernel of
    ``csrc/probes.cu`` (counted in ``probes.LAUNCHES``)."""
    if dispatch("hybrid_probe.chain", sfeat, cand):
        return chain_plain(sfeat, cand, iters, hybrid)
    n_self, w = sfeat.shape[0], cand.shape[1]
    if n_self % CS:
        raise ValueError(f"hybrid_probe.chain: {n_self} selves is not a multiple of {CS}")
    check_cuda("hybrid_probe.chain: sfeat", sfeat, torch.float32, (n_self, 8))
    check_cuda("hybrid_probe.chain: cand", cand, torch.float32, (n_self // CS * 8, w))
    perturb = _device_perturbations(iters, sfeat.device)
    out = torch.empty((n_self, w), dtype=torch.float32, device=sfeat.device)
    run_kernel("hybrid_bf16" if hybrid else "hybrid_f32", load_lib().sc_probe_hybrid,
               sfeat.data_ptr(), cand.data_ptr(), perturb.data_ptr(), out.data_ptr(),
               n_self, w, iters, int(hybrid), device=sfeat.device)
    return out


def mask_fraction(sfeat: torch.Tensor, cand: torch.Tensor) -> float:
    """Share of (self, candidate) elements whose mask holds at the first
    visit."""
    blocks = sfeat.shape[0] // CS
    s = sfeat.reshape(blocks, CS, 8, 1).unbind(2)
    c = cand.reshape(blocks, 8, 1, cand.shape[1]).unbind(1)
    p = perturbations(1).to(sfeat.device)[0]
    rx, ry = s[0] + p - c[0], s[1] + p - c[1]
    diam = torch.tensor(DIAM, dtype=torch.float32, device=sfeat.device)
    mb = (rx * rx + ry * ry <= diam * diam) & (c[7] == s[7])
    return float(mb.float().mean())


# Operations per element and visit, counted from the kernel: the f32 chain
# (deltas, cutoff, mask, 1 / sqrt, unit vector, align, coefficient, select,
# force, accumulate) and, in the hybrid form, the f32 prologue with its three
# casts and the bf16 rest.
F32_CHAIN_OPS = 31
HYBRID_F32_OPS = 19
HYBRID_BF16_OPS = 14


def operations(hybrid: bool, iters: int, n: int):
    """(f32 operations, bf16 operations) of one call over ``n`` elements."""
    if hybrid:
        return n * iters * HYBRID_F32_OPS, n * iters * HYBRID_BF16_OPS
    return n * iters * F32_CHAIN_OPS, 0


def io_bytes(n_self: int, w: int) -> int:
    return 4 * (n_self * 8 + n_self // CS * 8 * w + n_self * w)


def main(iters: int = 64, reps: int = 20, turns: int = 10) -> dict:
    """Time both forms on the card, on the tool's inputs and on the equal-rw
    inputs, in ``turns`` alternating turns (the order reversed every other
    turn) of ``reps`` runs each, after a warm-up, so that the card's clock
    ramp falls on both; returns {(form, inputs): ms}, the median over the
    turns of each turn's median."""
    device = require_card("hybrid_probe")
    print(f"pass-B fold chain, {CS}x{W} plane, {iters} visits/block")
    visits = BLOCKS * iters
    inputs = {"random rw": make_inputs(device=device),
              "equal rw": make_inputs(device=device, equal_rw=True)}
    forms = (("f32 chain", False), ("hybrid bf16", True))
    cuda_ms(lambda: chain(*inputs["random rw"], iters, False), 5 * reps)  # warm-up
    runs = {(name, k): [] for name, _ in forms for k in inputs}
    for turn in range(turns):
        for k in list(inputs)[::1 if turn % 2 == 0 else -1]:
            sfeat, cand = inputs[k]
            for name, hybrid in forms:
                runs[name, k].append(cuda_ms(lambda: chain(sfeat, cand, iters, hybrid), reps))
    times = {key: statistics.median(v) for key, v in runs.items()}
    for k in inputs:
        if k == "equal rw":
            print(f"inputs with rw columns 0 (mask = cutoff, "
                  f"{mask_fraction(*inputs[k]):.3f} of the elements pass; the tool's "
                  f"inputs pass {mask_fraction(*inputs['random rw']):.3f}):")
        for name, _ in forms:
            ms = times[name, k]
            print(f"{name:18s} {ms:8.3f} ms   {ms * 1e3 / visits:7.3f} us/(128x{W}) visit",
                  flush=True)
        print(f"hybrid speedup over f32: "
              f"{times['f32 chain', k] / times['hybrid bf16', k]:.3f}x")
    return times


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
