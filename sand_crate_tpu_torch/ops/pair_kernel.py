"""Slot-grid pair passes A and B (the grid backend's pair sums).

The PyTorch counterpart of ``sand_crate_tpu/ops/pair_kernel.py``.  The
particles sit in the padded grid G (4, NYP, M, NXP) — [posx, posy, velx,
vely], positions carrying +ALIVE_OFFSET, the particle of rank m in cell
(row, cx) at [:, row + 1, m, cx + 1], zeros elsewhere (ops/placement.py).
For every occupied slot the passes sum over the slots of the 3 x 3 cells
around it, under the JAX mask: raw encoded distance <= diameter, not the
slot itself.  The neighbour's position is jittered by a hash of its global
padded (row + row_offset, slot, x) and the tick.

* :func:`pair_pass_a` -> padded (4, NYP, M, NXP) [w_sum, s_x, s_y, cnt];
* :func:`pair_pass_b` -> (8|10, NY, M, NXP) [pressure, tension xy,
  pressure-force xy, (spring xy), viscosity vsum xy, count] (grid mode);
* :func:`pair_pass_b_emit` -> the same planes as (8|10, P_pad) columns in
  slab (cell-sorted particle) order.

On CUDA tensors each launches its kernel of ``csrc/grid_pair.cu`` (counted
in :data:`LAUNCHES`); on CPU tensors it runs the plain torch version beside
it, which gives the kernel's bits (same operations, same summation order);
tensors elsewhere raise.

Deviations from the JAX package:

* All slot pairs are always summed: the lo/hi two-level split, its engaged
  work units and ``ADDON_UNIT_CAP`` are not ported, so no pair is lost to a
  work-list cap (the provider's ``overflow`` counts slot overflow alone).
* Empty slots hold 0 in the pass-A output and in grid-mode pass B, where
  the JAX kernels may leave dead-dead pair sums that no particle reads.
* The TPU tactics — row blocks and ``occ`` air-block skipping, lane/sublane
  rotations, VMEM windows, the MXU one-hot emission and its DMA chunking —
  have no counterpart; the signatures keep ``row_offset`` (the spatial
  engine's band offset) but not ``tr``/``occ``/``units``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .pmajor import _u01

EPS = 1e-12
# Liveness rides as a +ALIVE_OFFSET on both position components: an
# alive-dead pair is ~2 units apart and fails every diameter cutoff.
POSX, POSY, VELX, VELY = range(4)
NUM_G = 4
ALIVE_OFFSET = 2.0
ALIVE_THRESHOLD = 1.5  # posx > threshold <=> slot occupied
WS, SX, SY, CNT = range(4)  # pass-A planes
NUM_A = 4
MAX_SLOTS = 16  # the noise hash packs slot ids as gy*16*8192 + gm*8192 + gx
MAX_NXP = 8192

# Kernel launches since the last reset, counted by the wrappers where they
# launch a CUDA kernel (never for the plain versions).
LAUNCHES = {"place_grid": 0, "pair_pass_a": 0, "pair_pass_b_grid": 0, "pair_pass_b_emit": 0}


def num_b(enable_spring: bool) -> int:
    """Pass-B output planes: 10 with the spring, else 8."""
    return 10 if enable_spring else 8


def load_lib():
    lib = cuda_build.load("grid_pair")
    if lib.sc_pass_b.argtypes is None:  # pointers as c_void_p, never 32-bit ints
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sc_place_grid.argtypes = [vp, vp, i, i, i, i, vp]
        lib.sc_pass_a.argtypes = [vp, vp, vp, vp, i, i, i, vp]
        lib.sc_pass_b.argtypes = [vp] * 6 + [i] * 7 + [vp]
        for fn in (lib.sc_place_grid, lib.sc_pass_a, lib.sc_pass_b):
            fn.restype = ctypes.c_int
    return lib


def check_cuda(name: str, t: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, expected the CUDA device")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def run_kernel(label: str, fn, *args, device) -> None:
    """Launch one entry point of csrc/grid_pair.cu on ``device``'s current
    stream; raise on a launch error, else count the launch."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{label} kernel failed: cudaError {err}")
    LAUNCHES[label] += 1


def _grid_dims(grid: torch.Tensor):
    if grid.dim() != 4 or grid.shape[0] != NUM_G:
        raise ValueError(f"grid must be (4, NYP, M, NXP), got {tuple(grid.shape)}")
    _, nyp, m_slots, nxp = grid.shape
    if not (1 <= m_slots <= MAX_SLOTS and nxp <= MAX_NXP):
        raise ValueError(f"grid slots {m_slots} / width {nxp} exceed the noise hash's strides")
    return nyp, m_slots, nxp


def _tensor(x, device, dtype):
    return torch.as_tensor(x, device=device).to(dtype).reshape(())


def coef_a(diameter, noise_amp, device) -> torch.Tensor:
    """Pass A's (2,) f32 coefficients: diameter, noise amplitude."""
    return torch.stack([_tensor(v, device, torch.float32) for v in (diameter, noise_amp)])


def coef_b(diameter, surface_smoothing, target_pressure, spring_overlap_balance,
           ignored_pressure, noise_amp, device) -> torch.Tensor:
    """Pass B's (6,) f32 coefficients in the JAX order: diameter, smoothing,
    target pressure, spring balance, noise amplitude, ignored pressure."""
    vals = (diameter, surface_smoothing, target_pressure, spring_overlap_balance,
            noise_amp, ignored_pressure)
    return torch.stack([_tensor(v, device, torch.float32) for v in vals])


def tick_pair(tick, row_offset, device) -> torch.Tensor:
    """(2,) int32: the tick and the grid's global padded-row offset."""
    return torch.stack([_tensor(v, device, torch.int32) for v in (tick, row_offset)])


# --------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, vectorised over the grid)
# --------------------------------------------------------------------------


def _noise_planes(grid: torch.Tensor, noise_amp, tick, row_offset):
    """Jittered positions of every slot of the padded grid, (NYP, M, NXP)
    each: pos + (u01(2 pid) - 0.5) * amp, pid = (row_offset + gy) * 16 * 8192
    + gm * 8192 + gx (pair_kernel.py::_noise_planes, bit-exact)."""
    _, nyp, m_slots, nxp = grid.shape
    dev = grid.device
    gy = torch.arange(nyp, device=dev).view(-1, 1, 1) + torch.as_tensor(row_offset, device=dev).long()
    gm = torch.arange(m_slots, device=dev).view(1, -1, 1)
    gx = torch.arange(nxp, device=dev).view(1, 1, -1)
    pid = gy * (16 * 8192) + gm * 8192 + gx
    tick = torch.as_tensor(tick, device=dev)
    amp = torch.as_tensor(noise_amp, device=dev).to(torch.float32)
    npx = grid[POSX] + (_u01(pid * 2, tick) - 0.5) * amp
    npy = grid[POSY] + (_u01(pid * 2 + 1, tick) - 0.5) * amp
    return npx, npy


def _stencil(m_slots):
    """The kernels' neighbour order: dy, dx in (-1, 0, 1), then slot k."""
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            for k in range(m_slots):
                yield dy, dx, k


def _pair_terms(sx, sy, planes, npx, npy, dy, dx, k, diam2, inv_diam):
    """Neighbour slices and pair geometry for one stencil offset, over the
    interior (NY, M, NXP - 2) selves: (mask, nhx, nhy, w, neighbour slices).
    The neighbour is slot k of the cell at (dy, dx), broadcast over the
    self slots."""
    _, nyp, m_slots, nxp = planes.shape
    ny = nyp - 2
    rows = slice(1 + dy, 1 + dy + ny)
    cols = slice(1 + dx, nxp - 1 + dx)
    nb = planes[:, rows, k:k + 1, cols]  # (F, NY, 1, NXP - 2)
    rx = sx - nb[POSX]
    ry = sy - nb[POSY]
    mask = (sx > ALIVE_THRESHOLD) & (rx * rx + ry * ry <= diam2)
    if dy == 0 and dx == 0:
        self_slot = torch.arange(m_slots, device=sx.device).view(1, -1, 1) == k
        mask = mask & ~self_slot
    nrx = sx - npx[rows, k:k + 1, cols]
    nry = sy - npy[rows, k:k + 1, cols]
    nd2 = torch.clamp(nrx * nrx + nry * nry, min=EPS * EPS)
    inv = 1.0 / torch.sqrt(nd2)
    nhx = nrx * inv
    nhy = nry * inv
    w = 1.0 - torch.clamp(nd2 * inv * inv_diam, 0.0, 1.0)
    return mask, nhx, nhy, w, nb


def pair_pass_a_plain(grid, diameter, noise_amp, tick, *, row_offset=0):
    """Plain torch version of the pass-A kernel: same inputs, same bits.

    Loops over the 9 * M neighbour offsets in the kernel's order and adds
    each masked term in place into (NY, M, NXP - 2) accumulators."""
    nyp, m_slots, nxp = _grid_dims(grid)
    dev = grid.device
    coef = coef_a(diameter, noise_amp, dev)
    diam = coef[0]
    diam2, inv_diam = diam * diam, 1.0 / diam
    npx, npy = _noise_planes(grid, coef[1], tick, row_offset)
    sx = grid[POSX, 1:-1, :, 1:-1]
    sy = grid[POSY, 1:-1, :, 1:-1]
    acc = torch.zeros((NUM_A,) + tuple(sx.shape), dtype=torch.float32, device=dev)
    for dy, dx, k in _stencil(m_slots):
        mask, nhx, nhy, w, _ = _pair_terms(
            sx, sy, grid, npx, npy, dy, dx, k, diam2, inv_diam
        )
        ci = (1.0 - w) * w
        acc[WS] += torch.where(mask, w, 0.0)
        acc[SX] += torch.where(mask, ci * nhx, 0.0)
        acc[SY] += torch.where(mask, ci * nhy, 0.0)
        acc[CNT] += mask.to(torch.float32)
    out = torch.zeros((NUM_A, nyp, m_slots, nxp), dtype=torch.float32, device=dev)
    out[:, 1:-1, :, 1:-1] = acc
    return out


def cell_pressure(ps: torch.Tensor, ignored_pressure) -> torch.Tensor:
    """p = max(0, w_sum - ignored) on counted slots (crate.py:261-275)."""
    return torch.where(ps[CNT] > 0, torch.clamp(ps[WS] - ignored_pressure, min=0.0), 0.0)


def pair_pass_b_plain(
    grid, ps_grid, diameter, surface_smoothing, target_pressure,
    spring_overlap_balance, ignored_pressure, noise_amp, tick, *,
    enable_spring=False, row_offset=0, mode="grid", slab=None, n_particles=0,
):
    """Plain torch version of the pass-B kernel: same inputs, same bits.

    ``mode`` "grid" returns (NB, NY, M, NXP); "emit" returns (NB, P_pad)
    columns in slab order: the grid-mode sums of slot (row, rank % M,
    cx + 1) for the first ``n_particles`` columns of alive particles, zeros
    elsewhere (the emit kernel takes its noise row offset as 0)."""
    nyp, m_slots, nxp = _grid_dims(grid)
    ny = nyp - 2
    dev = grid.device
    if mode == "emit":
        row_offset = 0
    coef = coef_b(diameter, surface_smoothing, target_pressure,
                  spring_overlap_balance, ignored_pressure, noise_amp, dev)
    diam = coef[0]
    diam2, inv_diam = diam * diam, 1.0 / diam
    smooth, tp2, bal = coef[1], 2.0 * coef[2], coef[3]
    npx, npy = _noise_planes(grid, coef[4], tick, row_offset)
    cp_all = cell_pressure(ps_grid, coef[5])  # (NYP, M, NXP)
    # One (NYP, M, NXP) operand per neighbour quantity, sliced like the grid.
    nb_planes = torch.stack([grid[POSX], grid[POSY], grid[VELX], grid[VELY],
                             cp_all, ps_grid[SX], ps_grid[SY]])
    inner = (slice(1, -1), slice(None), slice(1, -1))
    sx, sy = grid[POSX][inner], grid[POSY][inner]
    cp, s_x, s_y = cp_all[inner], ps_grid[SX][inner], ps_grid[SY][inner]
    n_acc = 6 if enable_spring else 4
    nb = num_b(enable_spring)
    acc = torch.zeros((n_acc + 3,) + tuple(sx.shape), dtype=torch.float32, device=dev)
    for dy, dx, k in _stencil(m_slots):
        mask, nhx, nhy, w, nbv = _pair_terms(
            sx, sy, nb_planes, npx, npy, dy, dx, k, diam2, inv_diam
        )
        p_nb, nb_sx, nb_sy = nbv[4], nbv[5], nbv[6]
        align = ((s_x - nb_sx) * nhx + (s_y - nb_sy) * nhy) * smooth
        t_coef = align + ((p_nb + cp) - tp2)
        p_coef = cp + p_nb
        terms = [t_coef * nhx, t_coef * nhy, p_coef * nhx, p_coef * nhy]
        if enable_spring:
            terms += [(bal - w) * nhx, (bal - w) * nhy]
        terms += [nbv[VELX], nbv[VELY]]
        for a, t in zip(acc, terms):
            a += torch.where(mask, t, 0.0)
        acc[-1] += mask.to(torch.float32)
    occupied = sx > ALIVE_THRESHOLD
    out = torch.zeros((nb, ny, m_slots, nxp), dtype=torch.float32, device=dev)
    out[0, :, :, 1:-1] = torch.where(occupied, cp, 0.0)
    out[1:, :, :, 1:-1] = acc
    if mode == "grid":
        return out
    if mode != "emit":
        raise ValueError(f"pair_pass_b: mode must be 'grid' or 'emit', got {mode!r}")
    return _emit_columns(out, slab, n_particles, m_slots)


def _emit_columns(b_out, slab, n_particles, m_slots):
    """(NB, P_pad) slab-order columns of grid-mode results: column p <
    ``n_particles`` with row < NY reads slot (row, rank % M, cx + 1)."""
    nb, ny, _, nxp = b_out.shape
    p_pad = slab.shape[1]
    cx = slab[4, :n_particles].long()
    rank = slab[5, :n_particles].long()
    row = slab[6, :n_particles].long()
    valid = row < ny
    idx = torch.where(valid, (row * m_slots + rank % m_slots) * nxp + cx + 1, 0)
    out = torch.zeros((nb, p_pad), dtype=torch.float32, device=b_out.device)
    out[:, :n_particles] = torch.where(valid, b_out.reshape(nb, -1)[:, idx], 0.0)
    return out


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def pair_pass_a(grid, diameter, noise_amp, tick, *, row_offset=0):
    """Pass A: padded per-slot [w_sum, s_x, s_y, cnt] (4, NYP, M, NXP), zero
    on empty slots and the ring — pass B's neighbour operand.

    ``row_offset``: the global padded-row index of the grid's row 0 (nonzero
    only for a spatial band); it keys the collider noise."""
    if grid.device.type == "cpu":
        return pair_pass_a_plain(grid, diameter, noise_amp, tick, row_offset=row_offset)
    nyp, m_slots, nxp = _grid_dims(grid)
    check_cuda("pair_pass_a: grid", grid, torch.float32, grid.shape)
    dev = grid.device
    coef = coef_a(diameter, noise_amp, dev)
    ticks = tick_pair(tick, row_offset, dev)
    ps = torch.empty_like(grid)
    run_kernel("pair_pass_a", load_lib().sc_pass_a, grid.data_ptr(), coef.data_ptr(),
               ticks.data_ptr(), ps.data_ptr(), nyp, m_slots, nxp, device=dev)
    return ps


def pair_pass_b(
    grid, ps_grid, diameter, surface_smoothing, target_pressure,
    spring_overlap_balance, ignored_pressure, noise_amp, tick, *,
    enable_spring=False, row_offset=0, mode="grid", slab=None, n_particles=0,
):
    """Pass B: every per-slot result plane, (8|10, NY, M, NXP) in grid mode
    — [pressure, tension xy, pressure-force xy, (spring xy), viscosity xy,
    count], the PairSums order — or, with ``mode="emit"`` (see
    :func:`pair_pass_b_emit`), the same planes as slab-order columns."""
    args = (grid, ps_grid, diameter, surface_smoothing, target_pressure,
            spring_overlap_balance, ignored_pressure, noise_amp, tick)
    if grid.device.type == "cpu":
        return pair_pass_b_plain(*args, enable_spring=enable_spring, row_offset=row_offset,
                                 mode=mode, slab=slab, n_particles=n_particles)
    if mode not in ("grid", "emit"):
        raise ValueError(f"pair_pass_b: mode must be 'grid' or 'emit', got {mode!r}")
    nyp, m_slots, nxp = _grid_dims(grid)
    emit = mode == "emit"
    check_cuda("pair_pass_b: grid", grid, torch.float32, grid.shape)
    check_cuda("pair_pass_b: ps_grid", ps_grid, torch.float32, grid.shape)
    dev = grid.device
    nb = num_b(enable_spring)
    if emit:
        p_pad = slab.shape[1]
        check_cuda("pair_pass_b: slab", slab, torch.float32, (8, p_pad))
        if not 0 <= n_particles <= p_pad:
            raise ValueError(f"pair_pass_b: n_particles {n_particles} not in [0, {p_pad}]")
        out = torch.empty((nb, p_pad), dtype=torch.float32, device=dev)
    else:
        p_pad = 0
        out = torch.empty((nb, nyp - 2, m_slots, nxp), dtype=torch.float32, device=dev)
    if not (grid.device == ps_grid.device and (slab is None or slab.device == dev)):
        raise ValueError("pair_pass_b: the operands must share one device")
    coef = coef_b(diameter, surface_smoothing, target_pressure,
                  spring_overlap_balance, ignored_pressure, noise_amp, dev)
    ticks = tick_pair(tick, row_offset, dev)
    run_kernel(
        f"pair_pass_b_{mode}", load_lib().sc_pass_b, grid.data_ptr(), ps_grid.data_ptr(),
        coef.data_ptr(), ticks.data_ptr(), slab.data_ptr() if emit else None,
        out.data_ptr(), nyp, m_slots, nxp, int(enable_spring), int(emit),
        n_particles, p_pad, device=dev,
    )
    return out


def pair_pass_b_emit(
    grid, ps_grid, slab, row_start, sorted_cid, nx, diameter, surface_smoothing,
    target_pressure, spring_overlap_balance, ignored_pressure, noise_amp, tick, *,
    enable_spring=False,
):
    """Pass B emitting results in slab (= sorted state) order: (NB, P_pad).

    Column p < P (P = len(sorted_cid)) of an alive particle holds the sums
    of its slot (row, rank % M, cx + 1) — an over-cap particle its
    cellmate's, as ``slot_assignment``'s gather_slot — and every other
    column is 0.  ``row_start`` and ``nx`` keep the JAX signature; the
    kernel reads cell, rank and row from the slab itself."""
    del row_start, nx
    return pair_pass_b(
        grid, ps_grid, diameter, surface_smoothing, target_pressure,
        spring_overlap_balance, ignored_pressure, noise_amp, tick,
        enable_spring=enable_spring, mode="emit", slab=slab,
        n_particles=sorted_cid.shape[0],
    )
