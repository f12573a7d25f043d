"""P2: the cost split of the grid pass A, by variant, on the card.

The port of ``tools/passa_probe.py``: standalone pass-A kernel variants on
the settled 1M grid, so that their differences isolate the output write,
the stencil compute and the fixed cost per occupied row block.  Every
variant works on the lo slots (0 .. min(M, 8) - 1) of the occupied row
blocks (``occ > 0``): a self slot sums over the same slots of the 3 x 3
cells around it (x wrapping around the padded width, slots by rotation,
the self pairing skipped) under the probe's mask, the cutoff alone — so
empty slots pair with each other, as on the TPU.  The result goes to
padded rows i*tr + 1 .. i*tr + tr of a zeroed (4, NYP, M, NXP) output:

* ``full`` — all four planes [w_sum, s_x, s_y, cnt];
* ``nostencil`` — zeros (the window is read and jittered, no pairs);
* ``bf16`` — the stencil and the sums in bf16 on block-origin-relative
  coordinates (every rounding written out);
* ``nooutdma`` — the sums, written nowhere;
* ``plane0`` — plane 0 only; ``tiny`` — one (1, m, 128) tile of plane 0;
* ``novel`` and ``prefetch`` — TPU DMA tactics (the velocity planes left out
  of the window; the next block's window fetched ahead) that compute what
  ``full`` computes: on the card they run the ``full`` kernel.

The kernels are ``csrc/probes.cu`` ``passa_f32_kernel`` and
``passa_bf16_kernel``, compiled for each m in 1..8: a CTA per tile of
TILE_X columns of a row block stages the window (a halo column each side,
each slot twice so that the slot rotation is an offset) through shared
memory; the f32 kernel runs a thread per (slot, column), the bf16 kernel a
thread per (slot, two columns) in packed bf16x2.  ``tr`` is a parameter (the
JAX scene's row_block rule by default); ``probe_cases`` holds hard inputs.

    python -m sand_crate_tpu_torch.probes.passa_probe [n_particles] [settle]

builds bench.py's dam break on the slot grid (16 slots a cell), settles it
and times the tool's variants on the 16-slot grid and its compact 8-slot
copy, then the port's shipped ``pair_pass_a`` on the same crate's slab
(slab order, no grid; CUDA events).
"""

from __future__ import annotations

import sys

import torch

from ..ops.measure import cuda_ms
from ..ops.pair_kernel import check_cuda
from ..ops.pmajor import _u01
from . import dispatch, load_lib, require_card, run_kernel, to_bf16

POSX, POSY = 0, 1
NUM_A = 4
M_LO = 8  # the lo slot half
ALIVE_THRESHOLD = 1.5
EPS = 1e-12
TR_MAX = 8
TILE_X = 32  # the kernels' column tile (kTx): NXP must be a multiple of it
VARIANTS = ("full", "nostencil", "bf16", "nooutdma", "plane0", "tiny", "novel", "prefetch")
# The tool's main: its variants per grid.
TOOL_MODES = {"m16": ("full", "nostencil", "bf16", "novel"), "m8": ("full", "nostencil", "bf16")}
# What each variant writes: (stencil on, plane mask, bf16).
_SPEC = {
    "full": (True, 0b1111, False), "novel": (True, 0b1111, False),
    "prefetch": (True, 0b1111, False), "nostencil": (False, 0b1111, False),
    "bf16": (True, 0b1111, True), "nooutdma": (True, 0, False),
    "plane0": (True, 0b0001, False), "tiny": (True, 0b0001, False),
}


def row_block(nxp: int) -> int:
    """The JAX scene's Pallas row block (sand_crate_tpu/scene.py:188-190)."""
    tr = 8
    while tr > 1 and tr * nxp > 4608:
        tr //= 2
    return tr


def block_flags(grid: torch.Tensor, tr: int) -> torch.Tensor:
    """(nblocks,) int32: 1 where block i's window rows [i*tr, i*tr + tr + 2)
    hold an occupied lo slot (pair_kernel._block_flags' occ)."""
    nyp = grid.shape[1]
    nblocks = (nyp - 2) // tr
    row_any = grid[POSX, :, :M_LO, :].amax(dim=(1, 2))
    idx = (torch.arange(nblocks, device=grid.device)[:, None] * tr
           + torch.arange(tr + 2, device=grid.device)[None, :])
    return (row_any[idx].amax(dim=1) > ALIVE_THRESHOLD).to(torch.int32)


def _extent(mode: str, tr: int, nxp: int):
    """(rows, columns) of each block's output that the variant writes."""
    return (1, min(128, nxp)) if mode == "tiny" else (tr, nxp)


def variant_plain(grid, occ, coef, ticks, tr: int, mode: str) -> torch.Tensor:
    """Plain torch version of the kernel, vectorised over the row blocks'
    windows, the same operations in the same order."""
    stencil, wmask, bf16 = _SPEC[mode]
    f32 = torch.float32
    dev = grid.device
    _, nyp, m_slots, nxp = grid.shape
    m = min(m_slots, M_LO)
    nblocks = (nyp - 2) // tr
    out = torch.zeros((NUM_A, nyp, m_slots, nxp), dtype=f32, device=dev)
    if not wmask:
        return out
    rows = (torch.arange(nblocks, device=dev)[:, None] * tr
            + torch.arange(tr + 2, device=dev)[None, :])  # (nb, tr + 2) padded rows
    win = grid[:2, :, :m][:, rows]  # (2, nb, tr + 2, m, nxp)
    gy = (ticks[1].long() + rows)[:, :, None, None]
    gm = torch.arange(m, device=dev)[None, None, :, None]
    gx = torch.arange(nxp, device=dev)[None, None, None, :]
    pid = gy * (16 * 8192) + gm * 8192 + gx
    npx = win[0] + (_u01(pid * 2, ticks[0]) - 0.5) * coef[1]
    npy = win[1] + (_u01(pid * 2 + 1, ticks[0]) - 0.5) * coef[1]
    diam = coef[0]
    inv_diam = 1.0 / diam
    if bf16:
        origin = grid[:2, rows[:, 1], 0][:, :, None, None, :]  # (2, nb, 1, 1, nxp)
        ox, oy = (torch.floor(origin[k] * inv_diam) * diam for k in range(2))
        planes = [to_bf16(win[0] - ox), to_bf16(win[1] - oy), to_bf16(npx - ox),
                  to_bf16(npy - oy)]
        b = to_bf16
        diam2 = b(b(diam) * b(diam))
        inv_b = b(inv_diam)
        eps2 = b(torch.tensor(1e-8, dtype=f32, device=dev))
    else:
        planes = [win[0], win[1], npx, npy]
        diam2 = diam * diam
        eps2 = torch.tensor(EPS * EPS, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    sx, sy = planes[0][:, 1:1 + tr], planes[1][:, 1:1 + tr]
    acc = [torch.zeros_like(sx) for _ in range(NUM_A)]
    for dy in (0, 1, 2) if stencil else ():
        rows_dy = [p[:, dy:dy + tr] for p in planes]
        for dx in (-1, 0, 1):
            base = [torch.roll(p, -dx, dims=-1) if dx else p for p in rows_dy]
            for k in range(m):
                if dy == 1 and dx == 0 and k == 0:
                    continue  # every pair is a slot with itself
                nx_, ny_, nnx, nny = (torch.roll(p, k, dims=-2) if k else p for p in base)
                if not bf16:
                    rx = sx - nx_
                    ry = sy - ny_
                    mb = rx * rx + ry * ry <= diam2
                    nrx = sx - nnx
                    nry = sy - nny
                    nd2 = torch.maximum(nrx * nrx + nry * nry, eps2)
                    inv = 1.0 / torch.sqrt(nd2)
                    nhx = nrx * inv
                    nhy = nry * inv
                    dist = nd2 * inv
                    w = torch.where(mb, 1.0 - torch.clamp(dist * inv_diam, 0.0, 1.0), zero)
                    coeff = (1.0 - w) * w
                    terms = (w, coeff * nhx, coeff * nhy, mb.to(f32))
                    acc = [a + t for a, t in zip(acc, terms)]
                else:
                    rx = b(sx - nx_)
                    ry = b(sy - ny_)
                    mb = b(b(rx * rx) + b(ry * ry)) <= diam2
                    nrx = b(sx - nnx)
                    nry = b(sy - nny)
                    nd2 = torch.maximum(b(b(nrx * nrx) + b(nry * nry)), eps2)
                    inv = b(1.0 / torch.sqrt(nd2))
                    nhx = b(nrx * inv)
                    nhy = b(nry * inv)
                    dist = b(nd2 * inv)
                    w = torch.where(mb, b(1.0 - torch.clamp(b(dist * inv_b), 0.0, 1.0)), zero)
                    coeff = b(b(1.0 - w) * w)
                    acc = [b(acc[0] + w), b(acc[1] + b(coeff * nhx)),
                           b(acc[2] + b(coeff * nhy)), b(acc[3] + mb.to(f32))]
    res = torch.stack(acc)  # (4, nb, tr, m, nxp)
    res = torch.where(occ.bool()[None, :, None, None, None], res, zero)
    n_rows, n_cols = _extent(mode, tr, nxp)
    keep = torch.zeros_like(res, dtype=torch.bool)
    keep[:, :, :n_rows, :, :n_cols] = True
    planes_on = torch.tensor([bool(wmask >> p & 1) for p in range(NUM_A)], device=dev)
    keep &= planes_on[:, None, None, None, None]
    body = out[:, 1:1 + nblocks * tr, :m].reshape(NUM_A, nblocks, tr, m, nxp)
    out[:, 1:1 + nblocks * tr, :m] = torch.where(keep, res, body).reshape(
        NUM_A, nblocks * tr, m, nxp)
    return out


def variant(grid, occ, coef, ticks, tr: int, mode: str) -> torch.Tensor:
    """One probe variant -> (4, NYP, M, NXP) f32, written into a zeroed
    output as the tool's aliased buffer: CPU tensors run
    :func:`variant_plain`, CUDA tensors launch the kernel of
    ``csrc/probes.cu`` (counted in ``probes.LAUNCHES["passa_<mode>"]``)."""
    if mode not in VARIANTS:
        raise ValueError(f"mode must be one of {VARIANTS}, got {mode!r}")
    _, nyp, m_slots, nxp = grid.shape
    if not 1 <= tr <= TR_MAX:
        raise ValueError(f"passa_probe: tr {tr} not in [1, {TR_MAX}]")
    if nxp % TILE_X or nxp > 8192 or not 1 <= m_slots <= 16:
        raise ValueError(f"passa_probe: grid {tuple(grid.shape)} (NXP a multiple of "
                         f"{TILE_X}, at most 8192; 1 to 16 slots)")
    if dispatch("passa_probe.variant", grid, occ, coef, ticks):
        return variant_plain(grid, occ, coef, ticks, tr, mode)
    nblocks = (nyp - 2) // tr
    who = "passa_probe.variant"
    check_cuda(f"{who}: grid", grid, torch.float32, grid.shape)
    check_cuda(f"{who}: occ", occ, torch.int32, (nblocks,))
    check_cuda(f"{who}: coef", coef, torch.float32, (2,))
    check_cuda(f"{who}: ticks", ticks, torch.int32, (2,))
    stencil, wmask, bf16 = _SPEC[mode]
    n_rows, n_cols = _extent(mode, tr, nxp)
    out = torch.zeros_like(grid)
    run_kernel(f"passa_{mode}", load_lib().sc_probe_passa, grid.data_ptr(), occ.data_ptr(),
               coef.data_ptr(), ticks.data_ptr(), out.data_ptr(), nyp, m_slots, nxp, tr,
               min(m_slots, M_LO), nblocks, int(bf16), int(stencil), wmask, n_rows, n_cols,
               device=grid.device)
    return out


def crate_slab(crate):
    """The tool's sorted slab (8, P_pad) of ``crate``'s state and its row
    starts (ny + 1,) int32."""
    from .pmajor_probe import sorted_slab

    scene = crate.scene
    slab, sorted_cid = sorted_slab(crate.state, crate.params, scene)
    starts = torch.arange(scene.grid_ny + 1, device=slab.device) * scene.grid_nx
    return slab, torch.searchsorted(sorted_cid, starts.to(sorted_cid.dtype), out_int32=True)


def crate_grid(crate) -> torch.Tensor:
    """The tool's slot grid (4, NYP, M, NXP) of ``crate``'s state: its
    sorted slab placed by ``place_grid`` at the crate's cell capacity."""
    from ..ops.pallas_forces import grid_width
    from ..ops.placement import place_grid

    scene = crate.scene
    slab, _ = crate_slab(crate)
    nx, ny = scene.grid_nx, scene.grid_ny
    return place_grid(slab, None, scene.cell_capacity, nx, ny, grid_width(nx))


def coefficients(diameter, device):
    """The tool's (2,) f32 coef (diameter, noise amplitude 0) and (2,) i32
    ticks (tick 0, row offset 0)."""
    d = torch.as_tensor(diameter, device=device).to(torch.float32).reshape(())
    coef = torch.stack([d, torch.zeros((), dtype=torch.float32, device=device)])
    return coef, torch.zeros(2, dtype=torch.int32, device=device)


# Operations per self slot and stencil pair, counted from the kernel: the
# geometry, weight and mask 18, the four sums 6; bf16 the same count.
PAIR_OPS = 24


def operations(mode: str, occ: torch.Tensor, grid_shape, tr: int):
    """(f32 operations, bf16 operations) of one call on this grid's
    occupied blocks: every lo self slot against 9 * m - 1 neighbour slots."""
    _, _, m_slots, nxp = grid_shape
    m = min(m_slots, M_LO)
    pairs = int(occ.sum()) * tr * m * nxp * (9 * m - 1)
    stencil, _, bf16 = _SPEC[mode]
    ops = pairs * PAIR_OPS if stencil else 0
    return (0, ops) if bf16 else (ops, 0)


def io_bytes(occ: torch.Tensor, grid_shape, tr: int) -> int:
    """The bytes one call moves, the same for every variant: the occupied
    blocks' windows (two position planes of the lo slots) read once, and
    the whole (4, NYP, M, NXP) output written once, as the zero fill that
    :func:`variant` allocates (and the timed call includes, as the tool's
    ``jnp.zeros``); the rows a variant writes lie inside it."""
    _, nyp, m_slots, nxp = grid_shape
    m = min(m_slots, M_LO)
    n_occ = int(occ.sum())
    return 4 * (2 * n_occ * (tr + 2) * m * nxp + NUM_A * nyp * m_slots * nxp)


def main(n: int = 1_000_000, settle: int = 100, tr: int | None = None,
         modes: dict | None = None, crate=None) -> dict:
    """Time the variants (the tool's by default) on the settled grid and its
    8-slot copy, then the shipped pair_pass_a on the crate's slab (slab
    order, all 16 slots' pairs); ``crate``, already settled on
    the slot grid, takes the place of ``n`` and ``settle``.  Returns
    {(grid, mode): ms}."""
    from ..ops.pair_kernel import pair_pass_a
    from .pmajor_probe import settled_crate

    device = require_card("passa_probe", crate)
    if crate is None:
        crate = settled_crate(n, settle, device, forces_mode="pallas", cell_capacity=16)
    params = crate.params
    grid = crate_grid(crate)
    tr = tr or row_block(grid.shape[3])
    occ = block_flags(grid, tr)
    print(f"occupied blocks: {int(occ.sum())}/{occ.shape[0]} tr={tr}")
    grid8 = grid[:, :, :M_LO].contiguous()
    coef, ticks = coefficients(params.diameter, device)
    times = {}
    for tag, g in (("m16", grid), ("m8", grid8)):
        for mode in (modes or TOOL_MODES)[tag]:
            ms = cuda_ms(lambda: variant(g, occ, coef, ticks, tr, mode), 10)
            times[tag, mode] = ms
            print(f"[{tag}] pass_a[{mode:>10s} tr={tr}]  {ms:7.2f} ms", flush=True)
    zero = torch.zeros((), device=device)
    tick = torch.zeros((), dtype=torch.int32, device=device)  # on the card: no host copy
    slab, row_start = crate_slab(crate)
    scene = crate.scene
    ms = cuda_ms(lambda: pair_pass_a(slab, row_start, scene.cell_capacity, scene.grid_nx,
                                     params.diameter, zero, tick), 10)
    times["m16", "shipped"] = ms
    print(f"pass_a[   shipped]  {ms:7.2f} ms")
    return times


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:]]
    main(*(a or [1_000_000, 100]))
