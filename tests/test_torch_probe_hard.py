"""The hard inputs of P1 and P4 (``probes/probe_cases.py``) on the CPU.

Each case holds what it claims (``pmajor_facts``, ``chain_facts``), the
port's plain versions run on it, and on the cases the tools' kernels take
(P1: W a multiple of 128; P4: the tool's constants a and b and whole
(ROWS, COLS) blocks) the plain versions match those kernels run in
``pl.pallas_call(..., interpret=True)`` with the tools' own grid specs, at
``tests/test_torch_probes.py``'s tolerances: f32 at rtol/atol 3e-3 (XLA's
rsqrt against the port's 1 / sqrt), P1's mask counts exactly, and bf16
within BF16_ULPS bf16 gaps of |want| plus the largest term of a sum.  On
the card, ``tests/test_torch_cuda.py`` holds every kernel on every case bit
for bit.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sand_crate_tpu_torch.probes import bf16_probe, pmajor_probe, probe_cases
from tools import bf16_probe as tool_p4
from tools import pmajor_probe as tool_p1

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 3e-3
BF16_EPS = 2.0**-7
BF16_ULPS = 3
COUNT_ROW = {"a": 3, "b": 6}  # the mask count's output row


def _tool_pmajor(slab_p, dma_lo, ws, coef, w, mode):
    """tools/pmajor_probe.py's kernel in interpret mode, the tool's grid spec."""
    nblocks = dma_lo.shape[0]
    f = pl.pallas_call(
        functools.partial(tool_p1._kernel, w=w, mode=mode),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3,
            grid=(nblocks,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.HBM),
            scratch_shapes=[
                pltpu.VMEM((2, 8, tool_p1.VCAP), jnp.float32),
                pltpu.VMEM((128, 8), jnp.float32),
                pltpu.VMEM((128, 8), jnp.float32),
                pltpu.VMEM((tool_p1.CPB, 8, 128), jnp.float32),
                pltpu.SemaphoreType.DMA((3,)),
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((nblocks * tool_p1.CPB, 8, 128), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(*(jnp.asarray(t.numpy()) for t in (dma_lo, ws, coef, slab_p))))


def _tool_chain(x, kind, iters):
    """tools/bf16_probe.py's chain or mixed kernel in interpret mode over
    (ROWS, COLS) blocks, as f32."""
    if kind == "mixed":
        kernel, dtypes = tool_p4._mixed_kernel, (jnp.float32, jnp.float32)
    else:
        dt = jnp.float32 if kind == "f32" else jnp.bfloat16
        kernel, dtypes = functools.partial(tool_p4._chain_kernel, dtype=dt), (dt, dt)
    blocks = x.shape[0] // tool_p4.ROWS
    spec = pl.BlockSpec((tool_p4.ROWS, tool_p4.COLS), lambda i: (i, 0))
    f = pl.pallas_call(
        functools.partial(kernel, iters=iters), grid=(blocks,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(tuple(x.shape), dtypes[1]), interpret=True)
    return np.asarray(f(jnp.asarray(x.float().numpy(), dtypes[0])).astype(jnp.float32))


# ---- P1 ------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(probe_cases.PMAJOR_CASES))
def test_pmajor_case_holds_what_it_claims(case):
    """Each P1 case holds what it is built to hold (W 200 and 1000, clamped
    windows, the zero padding, nd2 at its floor, pairs at one diameter and
    just past it, one block; nd2 inside inv_sqrt_rn's exact range), and both
    modes' plain versions give finite rows whose mask counts are whole
    numbers, mode a's equal to mode b's, with pairs counted."""
    facts = probe_cases.pmajor_facts(case)
    assert facts["holds"], facts
    slab_p, dma_lo, ws, coef, w = probe_cases.pmajor_inputs(case)
    out = {m: pmajor_probe.probe(slab_p, dma_lo, ws, coef, w, m) for m in ("a", "b")}
    for mode, o in out.items():
        assert o.shape == (dma_lo.shape[0] * pmajor_probe.CPB, 8, 128)
        assert bool(torch.isfinite(o).all()), mode
    count = out["a"][:, COUNT_ROW["a"]]
    assert bool((count == count.round()).all()) and float(count.sum()) > 0
    assert torch.equal(count, out["b"][:, COUNT_ROW["b"]])


@pytest.mark.parametrize("case, mode", [("clamped", "a"), ("padding", "b"), ("coincident", "a"),
                                        ("coincident", "b"), ("one_diameter", "a"),
                                        ("single_block", "b")])
def test_pmajor_hard_case_matches_tool(case, mode):
    """P1's plain version against the tool's kernel on the hard cases whose
    W is a multiple of 128 (the tool's lane-aligned windows)."""
    slab_p, dma_lo, ws, coef, w = probe_cases.pmajor_inputs(case)
    assert w % 128 == 0
    want = _tool_pmajor(slab_p, dma_lo, ws, coef, w, mode)
    got = pmajor_probe.probe(slab_p, dma_lo, ws, coef, w, mode).numpy()
    row = COUNT_ROW[mode]
    np.testing.assert_array_equal(got[:, row], want[:, row], err_msg="mask count")
    assert want[:, row].sum() > 100
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_pmajor_probe_rejects_w_outside_the_window():
    slab_p, dma_lo, ws, coef, _ = probe_cases.pmajor_inputs("single_block")
    for w in (0, pmajor_probe.VCAP + 1):
        with pytest.raises(ValueError, match=f"W {w} not in"):
            pmajor_probe.probe(slab_p, dma_lo, ws, coef, w, "a")


# ---- P4 ------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(probe_cases.CHAIN_CASES))
def test_chain_case_holds_what_it_claims(case):
    """Each P4 case holds what it is built to hold (every step rounds,
    subnormal inputs and sums, overflow to inf, a partial last block, 0, 1
    and 3 iterations), and all three kinds' plain versions keep the input's
    shape and type, finite except where the case overflows."""
    facts = probe_cases.chain_facts(case)
    assert facts["holds"], facts
    for kind in bf16_probe.KINDS:
        x, iters, a, b = probe_cases.chain_inputs(case, kind)
        out = bf16_probe.chain(x, kind, iters, a, b)
        assert out.shape == x.shape and out.dtype == x.dtype
        assert bool(torch.isfinite(out).all()) != (case == "huge"), kind


@pytest.mark.parametrize("case", ["huge", "iters0"])
@pytest.mark.parametrize("kind", bf16_probe.KINDS)
def test_chain_hard_case_matches_tool(case, kind):
    """P4's plain versions against the tool's kernels on the cases the tool
    takes (its a and b, whole blocks): overflow to inf, and no iteration."""
    x, iters, a, b = probe_cases.chain_inputs(case, kind)
    assert (a, b) == (bf16_probe.A, bf16_probe.B) and x.shape[1] == tool_p4.COLS
    want = _tool_chain(x, kind, iters)
    got = bf16_probe.chain(x, kind, iters).float().numpy()
    if kind == "f32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:  # a term is one chain: x times at most 1.07
        tol = BF16_ULPS * BF16_EPS
        term = float(np.abs(x.float().numpy()).max()) * (1.0 + 0.01 * (bf16_probe.LANES - 1))
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * term)


def test_chain_takes_a_and_b():
    """chain(x, kind, iters, a, b) runs the chain with ``a`` and ``b`` (the
    defaults are the tool's constants): one bf16 step from x is
    bf16(bf16(bf16(x * 1.0) * a) + b) summed over the lanes' scales."""
    x = torch.tensor([[0.5, 0.25]], dtype=torch.bfloat16)
    to_bf16 = bf16_probe.to_bf16
    a, b = 0.99, 0.01
    a16, b16 = to_bf16(torch.tensor(a)), to_bf16(torch.tensor(b))
    chains = [to_bf16(to_bf16(to_bf16(x.float() * to_bf16(torch.tensor(1.0 + 0.01 * k))) * a16)
                      + b16) for k in range(bf16_probe.LANES)]
    want = chains[0]
    for c in chains[1:]:
        want = to_bf16(want + c)
    assert torch.equal(bf16_probe.chain(x, "bf16", 1, a, b).float(), want)
    assert not torch.equal(bf16_probe.chain(x, "bf16", 1).float(), want)


def test_hard_case_constants_mirror_the_kernels():
    """pmajor_probe's CPB, CHUNK, OWN, VCAP and TILE are P1's kCpb, kChunk,
    kOwn, kVcap and kP1Tile, shared_bytes its p1_smem_bytes, and
    bf16_probe's CHAIN_THREADS and CHAIN_PAIRS chain_bf16_kernel's
    kChainThreads and kChainPairs (csrc/probes.cu)."""
    src = (REPO / "sand_crate_tpu_torch" / "csrc" / "probes.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert pmajor_probe.CPB == const("kCpb") and pmajor_probe.CHUNK == const("kChunk")
    assert pmajor_probe.OWN == pmajor_probe.CPB * pmajor_probe.CHUNK
    assert re.search(r"constexpr int kOwn = kCpb \* 128;", src)
    assert (pmajor_probe.VCAP, pmajor_probe.TILE) == (const("kVcap"), const("kP1Tile"))
    assert "3 * kP1Tile) * (mode == 0 ? 16 : 36)" in src  # pmajor_probe.shared_bytes
    assert [pmajor_probe.shared_bytes(m) for m in "ab"] == [48 * pmajor_probe.TILE,
                                                            108 * pmajor_probe.TILE]
    assert (bf16_probe.CHAIN_THREADS, bf16_probe.CHAIN_PAIRS) == (const("kChainThreads"),
                                                                   const("kChainPairs"))
