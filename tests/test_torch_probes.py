"""The probe kernels P1-P4 of tools/ against the port's probes.

Each tool's Pallas kernel function runs in ``pl.pallas_call(...,
interpret=True)`` built with the tool's own grid spec (a tool's ``run``
returns only a time, so the test makes the call itself; the tools stay
untouched), and the port's plain version (the wrapper on CPU tensors) gets
the same numpy-seeded inputs.  P1 and P2 take theirs from a real state: the
JAX package's slab (``slab_from_sorted``) and grid (``place_grid``) of a
~2k-particle dam break, whose pairs pass the cutoff (on a random grid every
slot is empty and pass A writes zeros).

Tolerances, element by element: f32 outputs at rtol/atol 3e-3 (the JAX
suite's pair-sum tolerance, ROADMAP.md); XLA's rsqrt against the port's
1 / sqrt is the only difference.  bf16 outputs within BF16_ULPS bf16 gaps
(2^-7 relative) of |want| plus the largest magnitude one term of the sum
can have, which holds a sum whose terms cancel to the terms' precision:
XLA on the CPU drops some of the bf16 roundings that the port writes out
after every operation, and the port's outputs differ from it by at most
2.0 such gaps (P2), 0.5 (P3, P4 mixed) and 0 (P4 bf16).  P2's count plane
is compared exactly.  Dropping one stencil pair, or one pair's w or s_x
term, from the port's bf16 P2 moves some element by 4 to 18 gaps, which
fails; leaving out one of its roundings moves none by more than 2.7, which
this check cannot tell from XLA's own difference: the rounding points are
held on the card, where each kernel equals its plain version bit for bit.
"""

from __future__ import annotations

import copy
import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sand_crate_tpu import load_config as jax_load_config
from sand_crate_tpu import physics as jphysics
from sand_crate_tpu.cellwise import cell_ids_grid as jax_cell_ids
from sand_crate_tpu.ops import pair_kernel as jpk
from sand_crate_tpu.ops import placement as jpl
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.scene import init_state as jax_init_state
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch.ops.pallas_forces import grid_width
from sand_crate_tpu_torch.probes import (bf16_probe, hybrid_probe, passa_probe, pmajor_probe,
                                         probe_cases)
from tools import bf16_probe as tool_p4
from tools import hybrid_probe as tool_p3
from tools import passa_probe as tool_p2
from tools import pmajor_probe as tool_p1

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 3e-3
BF16_EPS = 2.0**-7  # the gap between bf16 values in [1, 2)
BF16_ULPS = 3
ITERS = 3
P4_BLOCKS = 1
P3_BLOCKS = 2


def _close(got, want, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=err_msg)


def _close_bf16(got, want, term, err_msg=""):
    """Each element within BF16_ULPS bf16 gaps of |want| + ``term``, the
    largest magnitude one term of its sum can have."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = BF16_ULPS * BF16_EPS
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * term, err_msg=err_msg)


# ---- P4: tools/bf16_probe.py -------------------------------------------------


@pytest.mark.parametrize("kind", bf16_probe.KINDS)
def test_bf16_probe_matches_tool(kind):
    """The three chain kernels (f32, bf16, mixed) against the tool's kernels
    in interpret mode, on the tool's input."""
    x = bf16_probe.make_input(kind, blocks=P4_BLOCKS)
    if kind == "mixed":
        kernel, dtypes = tool_p4._mixed_kernel, (jnp.float32, jnp.float32)
    else:
        dt = jnp.float32 if kind == "f32" else jnp.bfloat16
        kernel, dtypes = functools.partial(tool_p4._chain_kernel, dtype=dt), (dt, dt)
    shape = (P4_BLOCKS * tool_p4.ROWS, tool_p4.COLS)
    f = pl.pallas_call(
        functools.partial(kernel, iters=ITERS),
        grid=(P4_BLOCKS,),
        in_specs=[pl.BlockSpec((tool_p4.ROWS, tool_p4.COLS), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((tool_p4.ROWS, tool_p4.COLS), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(shape, dtypes[1]),
        interpret=True,
    )
    want = np.asarray(f(jnp.asarray(x.float().numpy(), dtypes[0])).astype(jnp.float32))
    got = bf16_probe.chain(x, kind, ITERS)
    assert got.dtype == x.dtype and tuple(got.shape) == shape
    assert (want != 0).mean() > 0.4  # the mixed mask passes about half
    if kind == "f32":
        _close(got.float().numpy(), want)
    else:  # a term is one chain: x < 1 times at most 1.07
        _close_bf16(got.float().numpy(), want, term=1.0 + 0.01 * (bf16_probe.LANES - 1))


# ---- P3: tools/hybrid_probe.py -----------------------------------------------


@pytest.mark.parametrize("equal_rw", [False, True], ids=["tool_inputs", "equal_rw"])
@pytest.mark.parametrize("hybrid", [False, True], ids=["f32", "hybrid"])
def test_hybrid_probe_matches_tool(hybrid, equal_rw):
    """The fold chain, f32 and hybrid, against the tool's kernel; the tool's
    inputs (mask almost never true) and rw columns set equal (about half the
    elements pass)."""
    sfeat, cand = hybrid_probe.make_inputs(blocks=P3_BLOCKS, equal_rw=equal_rw)
    f = pl.pallas_call(
        functools.partial(tool_p3._kernel, iters=ITERS, hybrid=hybrid),
        grid=(P3_BLOCKS,),
        in_specs=[pl.BlockSpec((tool_p3.CS, 8), lambda i: (i, 0)),
                  pl.BlockSpec((8, tool_p3.W), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((tool_p3.CS, tool_p3.W), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((P3_BLOCKS * tool_p3.CS, tool_p3.W), jnp.float32),
        interpret=True,
    )
    want = np.asarray(f(jnp.asarray(sfeat.numpy()), jnp.asarray(cand.numpy())))
    got = hybrid_probe.chain(sfeat, cand, ITERS, hybrid).numpy()
    if equal_rw:
        frac = hybrid_probe.mask_fraction(sfeat, cand)
        assert 0.35 < frac < 0.65 and (want != 0).mean() > 0.3
    if hybrid:  # a term is t_coef * nh: |align| < 0.02 * sqrt(2), |tpf| < 0.032
        _close_bf16(got, want, term=0.06)
    else:
        _close(got, want)


# ---- P1 / P2: a small real state -----------------------------------------------


@pytest.fixture(scope="module")
def dam_break_2k():
    """The JAX package's ~2k-particle dam break (bench.py's rescaling) at its
    initial state, cell-sorted after the ghost phase as the tools sort it:
    (scene, params, slab, sorted cid, grid)."""
    config = jax_load_config(REPO / "configs" / "dam_break.yaml")
    w = copy.deepcopy(config.world_config)
    w.coefficients = dict(w.coefficients)
    spacing = math.sqrt((0.42 - 0.02) * (0.98 - 0.10) / 2000)
    w.initial_particles[0].spacing = spacing
    w.coefficients["particle_radius"] = spacing * 0.55
    w.coefficients["max_particles"] = 2100
    scene = jax_build_scene(w)
    params = JaxParams.from_coefficients(w.coefficients)
    state = jax_init_state(w, scene)
    ghost = jphysics.ghost_phase(state, params, scene)
    cid = jax_cell_ids(ghost.pos, state.alive, scene)
    iota = jnp.arange(scene.capacity, dtype=jnp.int32)
    sorted_cid, order = jax.lax.sort((cid, iota), num_keys=1)
    M, nx, ny = scene.cell_capacity, scene.grid_nx, scene.grid_ny
    slab, row_start, _, _ = jpl.slab_from_sorted(
        ghost.pos[order], state.alive[order], state.vel[order], sorted_cid, M, nx, ny)
    grid = jpl.place_grid(slab, row_start, M, nx, ny, grid_width(nx))
    return scene, params, slab, sorted_cid, grid


def _tool_p1_inputs(slab, sorted_cid, nx, ny):
    """tools/pmajor_probe.py main's preparation (its lines, on the JAX
    arrays)."""
    CPB, OWN, VCAP = tool_p1.CPB, tool_p1.OWN, tool_p1.VCAP
    p_pad = slab.shape[1]
    nblocks = (p_pad + OWN - 1) // OWN
    p_fit = nblocks * OWN
    off = jnp.arange(nblocks * CPB, dtype=jnp.int32) * 128
    last = jnp.minimum(off + 127, p_pad - 1)
    cx0 = slab[4][jnp.minimum(off, p_pad - 1)]
    rw0 = slab[6][jnp.minimum(off, p_pad - 1)]
    cx1 = slab[4][last]
    q = jnp.arange(3, dtype=jnp.int32)[None, :] - 1
    tgt = ((rw0[:, None].astype(jnp.int32) + q).clip(0, ny - 1) * nx
           + (cx0[:, None].astype(jnp.int32) - 2).clip(0, nx - 1))
    ws = jnp.searchsorted(sorted_cid, tgt.ravel()).astype(jnp.int32)
    tgt_hi = ((rw0[:, None].astype(jnp.int32) + q).clip(0, ny - 1) * nx
              + (cx1[:, None].astype(jnp.int32) + 3).clip(0, nx - 1))
    we = jnp.searchsorted(sorted_cid, tgt_hi.ravel()).astype(jnp.int32)
    dma_lo = (ws.reshape(-1, 3)[::CPB, 0] // 128) * 128
    dma_lo = jnp.minimum(dma_lo, jnp.arange(nblocks, dtype=jnp.int32) * OWN)
    dma_lo = jnp.clip(dma_lo, 0, p_pad)
    slab_p = jnp.pad(slab, ((0, 0), (0, VCAP + p_fit - p_pad)))
    return slab_p, dma_lo, ws, we - ws


@pytest.fixture(scope="module")
def p1_inputs(dam_break_2k):
    scene, params, slab, sorted_cid, _ = dam_break_2k
    jax_in = _tool_p1_inputs(slab, sorted_cid, scene.grid_nx, scene.grid_ny)
    port_in = pmajor_probe.prepare(torch.as_tensor(np.array(slab)),
                                   torch.as_tensor(np.array(sorted_cid)),
                                   scene.grid_nx, scene.grid_ny)
    return jax_in, port_in, params


def test_pmajor_probe_preparation_matches_tool(p1_inputs):
    """The port's prepare() gives the tool's padded slab, block window
    starts, chunk windows and needed widths exactly."""
    jax_in, port_in, _ = p1_inputs
    for name, a, b in zip(("slab_p", "dma_lo", "ws", "need"), jax_in, port_in):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert int(port_in[3].max()) > 0


@pytest.mark.parametrize("mode", ["a", "b"])
def test_pmajor_probe_matches_tool(p1_inputs, mode):
    """P1 at W = 384 against the tool's kernel on the same inputs, with
    pairs within the cutoff (mode a's count row)."""
    (slab_p, dma_lo, ws, _), _, params = p1_inputs
    w = 384
    nblocks = dma_lo.shape[0]
    coef = jnp.stack([params.diameter.astype(jnp.float32), jnp.zeros((), jnp.float32)])
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
    want = np.asarray(f(dma_lo, ws, coef, slab_p))
    t = [torch.as_tensor(np.array(a)) for a in (slab_p, dma_lo, ws, coef)]
    got = pmajor_probe.probe(*t, w, mode).numpy()
    count_row = 3 if mode == "a" else 6
    assert want[:, count_row].sum() > 100  # pairs within the cutoff
    _close(got, want)


# A 16-row band of the 2k grid (padded rows 10..27: two row blocks of 8,
# inside the fluid), shared by every P2 case.
P2_ROW0, P2_TR = 10, 8


@pytest.fixture(scope="module")
def p2_grids(dam_break_2k):
    grid = np.array(dam_break_2k[4])[:, P2_ROW0:P2_ROW0 + 2 * P2_TR + 2]
    return {"m16": grid, "m8": np.ascontiguousarray(grid[:, :, :8])}


def test_passa_probe_block_flags_match_jax(dam_break_2k):
    """block_flags equals the JAX _block_flags' occ on the whole grid and on
    the grid with its upper half emptied (air blocks)."""
    grid = np.array(dam_break_2k[4])
    tr = passa_probe.row_block(grid.shape[3])
    want, _ = jpk._block_flags(jnp.asarray(grid[jpk.POSX]), tr)
    got = passa_probe.block_flags(torch.as_tensor(grid), tr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0
    grid[:, grid.shape[1] // 2:] = 0.0
    want, _ = jpk._block_flags(jnp.asarray(grid[jpk.POSX]), tr)
    got = passa_probe.block_flags(torch.as_tensor(grid), tr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.shape[0]


def _tool_variant(grid, occ, coef, ticks, tr, mode):
    """tools/passa_probe.py's kernel (prefetch_kernel for "prefetch") in
    interpret mode, with the tool's grid spec, on numpy inputs."""
    _, nyp, m_slots, nxp = grid.shape
    m = min(m_slots, 8)
    nblocks = (nyp - 2) // tr
    if mode == "prefetch":
        kernel = functools.partial(tool_p2.prefetch_kernel, tr=tr, m=m)
        win = pltpu.VMEM((2, jpk.NUM_G, tr + 2, m, nxp), jnp.float32)
        n_sem = 3
    else:
        kernel = functools.partial(tool_p2.variant_kernel, tr=tr, m=m, mode=mode)
        win = pltpu.VMEM((jpk.NUM_G, tr + 2, m, nxp), jnp.float32)
        n_sem = 2
    f = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3,
            grid=(nblocks,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.HBM),
                      pl.BlockSpec(memory_space=pltpu.HBM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.HBM),
            scratch_shapes=[
                win,
                pltpu.VMEM((2, tr + 2, m, nxp), jnp.float32),
                pltpu.VMEM((jpk.NUM_A, tr, m, nxp), jnp.float32),
                pltpu.SemaphoreType.DMA((n_sem,)),
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((jpk.NUM_A, nyp, m_slots, nxp), jnp.float32),
        input_output_aliases={4: 0},
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(occ), jnp.asarray(coef), jnp.asarray(ticks),
                        jnp.asarray(grid), jnp.zeros((jpk.NUM_A, nyp, m_slots, nxp))))


def _hold_passa(got, want, mode):
    """The count plane exactly, the sums at the f32 or bf16 tolerance."""
    np.testing.assert_array_equal(got[3], want[3], err_msg="count plane")
    for p, name in enumerate(("w_sum", "s_x", "s_y")):
        if mode == "bf16":  # a term is w <= 1 or (1 - w) w nh, |.| <= 0.25
            _close_bf16(got[p], want[p], term=1.0, err_msg=name)
        else:
            _close(got[p], want[p], err_msg=name)


@pytest.mark.parametrize("tag, mode", [("m16", v) for v in passa_probe.VARIANTS]
                         + [("m8", "full"), ("m8", "bf16")])
def test_passa_probe_matches_tool(p2_grids, dam_break_2k, tag, mode):
    """Every P2 variant against the tool's kernel (prefetch_kernel for
    "prefetch") on the same grid, block 1 marked as air (skipped), with a
    nonzero noise amplitude and tick so that the jitter hash is exercised."""
    grid = p2_grids[tag]
    params = dam_break_2k[1]
    tr, m = P2_TR, min(grid.shape[2], 8)
    occ = np.array([1, 0], np.int32)
    diam = np.float32(params.diameter)
    coef = np.array([diam, 0.1 * diam], np.float32)
    ticks = np.array([3, 0], np.int32)
    want = _tool_variant(grid, occ, coef, ticks, tr, mode)
    got = passa_probe.variant(*(torch.as_tensor(a) for a in (grid, occ, coef, ticks)),
                              tr, mode).numpy()
    assert not got[:, 1 + tr:].any()  # the air block's rows keep their zeros
    if mode in ("full", "bf16", "novel", "prefetch"):
        occupied = grid[0, 1:1 + tr, :m] > 1.5
        assert occupied.sum() > 50 and (want[3, 1:1 + tr, :m][occupied] > 0).mean() > 0.9
    _hold_passa(got, want, mode)


# ---- the hard inputs of probes/probe_cases.py -----------------------------------


@pytest.mark.parametrize("case", sorted(probe_cases.PASSA_CASES))
def test_passa_case_holds_what_it_claims(case):
    """Each P2 hard case holds what it is built to hold (an odd m, tr 1, 3
    and 8, NXP 32, air blocks, coincident pairs at the eps floor, pairs at
    exactly one diameter, far positions with noise, a tick and a row
    offset), and the wrapper's plain version runs on it."""
    facts = probe_cases.passa_facts(case)
    assert facts["holds"], facts
    grid, occ, coef, ticks, tr = probe_cases.passa_inputs(case)
    out = passa_probe.variant(grid, occ, coef, ticks, tr, "full")
    assert out.shape == grid.shape and bool(torch.isfinite(out).all())
    assert float(out[3].sum()) > 0


@pytest.mark.parametrize("m_slots", probe_cases.SWEEP_SLOTS)
def test_passa_m_sweep_runs_every_variant(m_slots):
    """The m sweep (the sweep case at M = 1..8, one compiled kernel each):
    the inputs hold M slots, and every variant's plain version gives each
    occupied self an integer count of at most its 9 m - 1 stencil slots;
    nostencil, nooutdma, plane0 and tiny leave the count plane zero."""
    grid, occ, coef, ticks, tr = probe_cases.passa_inputs(probe_cases.SWEEP_CASE,
                                                          m_slots=m_slots)
    assert grid.shape[2] == m_slots and int(occ.sum()) > 0
    occupied = grid[0] > passa_probe.ALIVE_THRESHOLD
    assert bool(occupied.any())
    for mode in passa_probe.VARIANTS:
        count = passa_probe.variant(grid, occ, coef, ticks, tr, mode)[3]
        assert bool((count == count.round()).all()) and float(count.max()) <= 9 * m_slots - 1
        if mode in ("full", "bf16", "novel", "prefetch"):
            assert float(count[occupied].sum()) > 0, mode
        if mode in ("nostencil", "nooutdma", "plane0", "tiny"):
            assert not count.any(), mode


@pytest.mark.parametrize("case", sorted(probe_cases.HYBRID_CASES))
def test_hybrid_case_holds_what_it_claims(case):
    """Each P3 hard case holds what it is built to hold (W 2, 255 and 256,
    one visit and 64, random and equal rw, coincident positions, a
    candidate at exactly the cutoff and one just past it), and the
    wrapper's plain version gives every column, an odd W's last included."""
    facts = probe_cases.hybrid_facts(case)
    assert facts["holds"], facts
    sfeat, cand, iters = probe_cases.hybrid_inputs(case)
    for hybrid in (False, True):
        out = hybrid_probe.chain(sfeat, cand, iters, hybrid)
        assert out.shape == (sfeat.shape[0], cand.shape[1]) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("case, mode", [("m3_tr1", "full"), ("coincident", "full"),
                                        ("far", "bf16")])
def test_passa_hard_case_matches_tool(case, mode):
    """P2's plain version against the tool's kernel on hard inputs: an odd m
    at tr 1, coincident particles (nd2 at its floor), and far positions in
    bf16 (the relative coordinates), noise on where the case has it."""
    grid, occ, coef, ticks, tr = (a.numpy() if isinstance(a, torch.Tensor) else a
                                  for a in probe_cases.passa_inputs(case))
    want = _tool_variant(grid, occ, coef, ticks, tr, mode)
    got = passa_probe.variant(*(torch.as_tensor(a) for a in (grid, occ, coef, ticks)),
                              tr, mode).numpy()
    assert (want[3] > 0).mean() > 0.05
    _hold_passa(got, want, mode)


@pytest.mark.parametrize("case, hybrid", [("coincident", False), ("cutoff", True)])
def test_hybrid_hard_case_matches_tool(case, hybrid):
    """P3's plain version against the tool's kernel on candidates that
    coincide with their self (nd2 at its floor) and that sit exactly at the
    cutoff (the mask's <=), one visit."""
    sfeat, cand, iters = probe_cases.hybrid_inputs(case)
    blocks = sfeat.shape[0] // tool_p3.CS
    f = pl.pallas_call(
        functools.partial(tool_p3._kernel, iters=iters, hybrid=hybrid),
        grid=(blocks,),
        in_specs=[pl.BlockSpec((tool_p3.CS, 8), lambda i: (i, 0)),
                  pl.BlockSpec((8, tool_p3.W), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((tool_p3.CS, tool_p3.W), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((blocks * tool_p3.CS, tool_p3.W), jnp.float32),
        interpret=True,
    )
    want = np.asarray(f(jnp.asarray(sfeat.numpy()), jnp.asarray(cand.numpy())))
    got = hybrid_probe.chain(sfeat, cand, iters, hybrid).numpy()
    assert (want != 0).mean() > 0.1
    if hybrid:
        _close_bf16(got, want, term=0.06)
    else:
        _close(got, want)


def test_passa_io_bytes_count_the_zero_fill():
    """io_bytes counts the window read and the whole output written once,
    as the zero fill that the wrapper allocates and the timed call
    includes: the rows a variant writes lie inside that fill and are not
    counted again."""
    grid, occ, coef, ticks, tr = probe_cases.passa_inputs("m4_tr3_air")
    _, nyp, m_slots, nxp = grid.shape
    n_occ, m = int(occ.sum()), min(m_slots, 8)
    read, fill = 2 * n_occ * (tr + 2) * m * nxp, 4 * nyp * m_slots * nxp
    assert passa_probe.io_bytes(occ, grid.shape, tr) == 4 * (read + fill)
    assert passa_probe.variant(grid, occ, coef, ticks, tr, "nostencil").numel() == fill


def test_probe_constants_mirror_the_kernels():
    """TILE_X and TR_MAX are P2's kTx and kTrMax, M_LO its largest compiled
    m, and hybrid_probe.CS P3's kCs (csrc/probes.cu)."""
    src = (REPO / "sand_crate_tpu_torch" / "csrc" / "probes.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (passa_probe.TILE_X, passa_probe.TR_MAX) == (const("kTx"), const("kTrMax"))
    cases = [int(v) for v in re.findall(r"SC_PASSA_CASE\((\d+)\)\n", src)]
    assert cases == list(range(1, passa_probe.M_LO + 1))
    assert hybrid_probe.CS == const("kCs")


def test_passa_variant_rejects_what_the_kernel_does_not_take():
    """NXP not a multiple of the kernels' tile, no slots or more than 16,
    and tr outside 1..TR_MAX raise before any launch."""
    grid, occ, coef, ticks, tr = probe_cases.passa_inputs("m3_tr1")
    with pytest.raises(ValueError, match="multiple of 32"):
        passa_probe.variant(grid[..., :48], occ, coef, ticks, tr, "full")
    with pytest.raises(ValueError, match="1 to 16 slots"):
        passa_probe.variant(grid[:, :, :0], occ, coef, ticks, tr, "full")
    with pytest.raises(ValueError, match="tr 9"):
        passa_probe.variant(grid, occ, coef, ticks, passa_probe.TR_MAX + 1, "full")


def test_probe_wrappers_raise_off_cpu_and_cuda():
    """A wrapper runs its plain version on CPU tensors only and launches on
    CUDA tensors; tensors elsewhere raise instead of falling back."""
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        bf16_probe.chain(x, "f32", 1)
    with pytest.raises(ValueError, match="one device"):
        hybrid_probe.chain(torch.zeros((128, 8)), torch.zeros((8, 256), device="meta"), 1, False)


@pytest.mark.parametrize("main", [bf16_probe.main, hybrid_probe.main, pmajor_probe.main,
                                  passa_probe.main], ids=["P4", "P3", "P1", "P2"])
def test_probe_mains_need_the_card(main):
    """A probe's main measures the card: without one it raises, with no CPU
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would measure it")
    with pytest.raises(RuntimeError, match="measures the CUDA device"):
        main()
