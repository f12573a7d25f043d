"""Slot-grid pair passes A and B (the grid backend's pair sums).

The PyTorch counterpart of ``sand_crate_tpu/ops/pair_kernel.py``.  A self
sums over the in-cap particles of the 3 x 3 cells around it, other than
its own slot, under the JAX mask (raw encoded distance <= diameter); the
neighbour's position is jittered by a hash of its global padded slot
(row + 1 + row_offset, rank, cx + 1) and the tick.  The tick runs the two
slab-order passes, on the cell-sorted slab (8, P_pad) of
``ops/placement.py`` and its row starts, with no slot grid at all:

* :func:`pair_pass_a` -> (4, P_pad) [w_sum, s_x, s_y, cnt] per in-cap
  column, 0 elsewhere;
* :func:`pair_pass_b_emit` -> (8|10, P_pad) [pressure, tension xy,
  pressure-force xy, (spring xy), viscosity vsum xy, count] per alive
  column (an over-cap column takes its rank % M cellmate's sums), 0
  elsewhere.

The particle-order provider (and, later, the spatial engine) works on the
padded grids G (4, NYP, M, NXP) — the in-cap particle of rank m in cell
(row, cx) at [:, row + 1, m, cx + 1], zeros elsewhere — and the pass-A
grid PS placed the same way (``placement.place_grid`` on the slab with its
rows 0-3 replaced by pass A's columns):

* :func:`pair_pass_b` -> (8|10, NY, M, NXP), the same planes per slot.
  Its kernel tiles the grid in ``GRID_TILE`` cells of one row per warp,
  stages an occupied tile's 3 x (``GRID_TILE`` + 2) neighbourhood (its
  occupied slots, compacted) and streams the dense output, zeros past each
  cell's count; NXP must be a multiple of ``GRID_BLOCK_COLS``.

The two slab-order passes go through the custom operators
``torch.ops.sand_crate.pair_pass_a`` and ``.pair_pass_b_emit`` on one crate
as a batch of one.  The operators take a leading crate axis (slab (B, 8,
P_pad), row_start (B, ny + 1), per-crate coefficient rows and ticks) and
their vmap rules fold a vmapped batch into it, so batched crates
(``sweep.batched_step``) launch each pass once for every crate; on CPU
tensors they run the plain versions crate by crate (whose host reads of
the alive count happen there, not under ``vmap``).

On CUDA tensors each launches its kernel of ``csrc/grid_pair.cu`` (counted
in :data:`LAUNCHES`); on CPU tensors it runs the plain torch version beside
it, which gives the kernel's bits (same operations, same summation order:
row offset dy, then dx, then slot — which is slab order within a grid
row); tensors elsewhere raise.  The slab-order passes stage each warp tile's
windows (:func:`tile_windows`) through shared memory and walk each self's
exact cells (:func:`cell_ranges`).  On the settled 1M dam break (2.45% of
the dense grid's slots occupied) they take 0.0885 and 0.1219 ms of device
time per tick on an H100 80GB HBM3 at 700 W, where kernels that ran one
thread per slot of the dense grid and read every neighbour from it took
0.4602 and 0.2484 ms.
The dense plain versions :func:`pair_pass_a_plain` and
:func:`pair_pass_b_plain` stay as the oracle of the slab-order ones
(:func:`pass_a_via_grid`, :func:`pass_b_emit_via_grid`).

Deviations from the JAX package:

* All slot pairs are always summed: the lo/hi two-level split, its engaged
  work units and ``ADDON_UNIT_CAP`` are not ported, so no pair is lost to a
  work-list cap (the provider's ``overflow`` counts slot overflow alone).
* Pass A is a slab-order (4, P_pad) array, not a padded grid; empty slots
  hold 0 in PS and in grid-mode pass B, where the JAX kernels may leave
  dead-dead pair sums that no particle reads.
* The TPU tactics — row blocks and ``occ`` air-block skipping, lane/sublane
  rotations, VMEM windows, the MXU one-hot emission and its DMA chunking —
  have no counterpart; the signatures keep ``row_offset`` (the spatial
  engine's band offset) but not ``tr``/``occ``/``units``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .crate_axis import crates_plain, on_cpu_or_cuda, register_crate_vmap
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
CX, RANK, ROW, IN_CAP = 4, 5, 6, 7  # slab rows
SLAB_F = 8
MAX_SLOTS = 16  # the noise hash packs slot ids as gy*16*8192 + gm*8192 + gx
MAX_NXP = 8192
SLAB_TILE = 32  # slab-order kernels: the selves of one warp tile
SLAB_PIECE = 128  # and the candidates it stages at a time (kPiece)
GRID_TILE = 32  # grid-mode pass B: the cells (columns) of one warp tile
GRID_BLOCK_COLS = 128  # and the columns of a block of four tiles

# Kernel launches since the last reset, counted by the wrappers where they
# launch a CUDA kernel (one for a whole crate axis; never for the plain
# versions).
LAUNCHES = {"place_grid": 0, "pair_pass_a": 0, "pair_pass_b_grid": 0, "pair_pass_b_emit": 0}


def num_b(enable_spring: bool) -> int:
    """Pass-B output planes: 10 with the spring, else 8."""
    return 10 if enable_spring else 8


def load_lib():
    lib = cuda_build.load("grid_pair")
    if lib.sc_pass_b.argtypes is None:  # pointers as c_void_p, never 32-bit ints
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sc_place_grid.argtypes = [vp, vp, i, i, i, i, vp]
        lib.sc_pass_a.argtypes = [vp] * 5 + [i] * 5 + [vp]
        lib.sc_pass_b_emit.argtypes = [vp] * 6 + [i] * 6 + [vp]
        lib.sc_pass_b.argtypes = [vp] * 5 + [i] * 5 + [vp]
        for fn in (lib.sc_place_grid, lib.sc_pass_a, lib.sc_pass_b_emit, lib.sc_pass_b):
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


def _slab_dims(slab: torch.Tensor, row_start: torch.Tensor, m_slots: int, nx: int):
    """(P_pad, ny) of a slab and its row starts; raises on what the
    kernels do not take."""
    if slab.dim() != 2 or slab.shape[0] != SLAB_F:
        raise ValueError(f"slab must be (8, P_pad), got {tuple(slab.shape)}")
    if row_start.dim() != 1 or row_start.shape[0] < 2:
        raise ValueError(f"row_start must be (ny + 1,), got {tuple(row_start.shape)}")
    if not (1 <= m_slots <= MAX_SLOTS and 1 <= nx and nx + 2 <= MAX_NXP):
        raise ValueError(f"cell capacity {m_slots} / grid width {nx} exceed the noise hash's "
                         "strides")
    if slab.device != row_start.device:
        raise ValueError("the slab and row_start must share one device")
    return slab.shape[1], row_start.shape[0] - 1


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


# --------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, vectorised)
# --------------------------------------------------------------------------


def _jitter(px, py, pid, noise_amp, tick):
    """pos + (u01(2 pid) - 0.5) * amp per component
    (pair_kernel.py::_noise_planes, bit-exact)."""
    amp = torch.as_tensor(noise_amp, device=px.device).to(torch.float32)
    tick = torch.as_tensor(tick, device=px.device)
    return (px + (_u01(pid * 2, tick) - 0.5) * amp,
            py + (_u01(pid * 2 + 1, tick) - 0.5) * amp)


def _noise_planes(grid: torch.Tensor, noise_amp, tick, row_offset):
    """Jittered positions of every slot of the padded grid, (NYP, M, NXP)
    each; pid = (row_offset + gy) * 16 * 8192 + gm * 8192 + gx."""
    _, nyp, m_slots, nxp = grid.shape
    dev = grid.device
    gy = torch.arange(nyp, device=dev).view(-1, 1, 1) + torch.as_tensor(row_offset, device=dev).long()
    gm = torch.arange(m_slots, device=dev).view(1, -1, 1)
    gx = torch.arange(nxp, device=dev).view(1, 1, -1)
    pid = gy * (16 * 8192) + gm * 8192 + gx
    return _jitter(grid[POSX], grid[POSY], pid, noise_amp, tick)


def _stencil(m_slots):
    """The kernels' neighbour order: dy, dx in (-1, 0, 1), then slot k."""
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            for k in range(m_slots):
                yield dy, dx, k


def _geometry(sx, sy, nbx, nby, npx, npy, diam2, inv_diam):
    """The JAX _geometry of (self, neighbour) pairs, elementwise: (within
    the cutoff, nhx, nhy, w) from the raw and the jittered neighbour
    positions."""
    rx = sx - nbx
    ry = sy - nby
    near = rx * rx + ry * ry <= diam2
    nrx = sx - npx
    nry = sy - npy
    nd2 = torch.clamp(nrx * nrx + nry * nry, min=EPS * EPS)
    inv = 1.0 / torch.sqrt(nd2)
    nhx = nrx * inv
    nhy = nry * inv
    w = 1.0 - torch.clamp(nd2 * inv * inv_diam, 0.0, 1.0)
    return near, nhx, nhy, w


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
    near, nhx, nhy, w = _geometry(sx, sy, nb[POSX], nb[POSY], npx[rows, k:k + 1, cols],
                                  npy[rows, k:k + 1, cols], diam2, inv_diam)
    mask = (sx > ALIVE_THRESHOLD) & near
    if dy == 0 and dx == 0:
        self_slot = torch.arange(m_slots, device=sx.device).view(1, -1, 1) == k
        mask = mask & ~self_slot
    return mask, nhx, nhy, w, nb


def _a_terms(nhx, nhy, w):
    ci = (1.0 - w) * w
    return [w, ci * nhx, ci * nhy]


def pair_pass_a_plain(grid, diameter, noise_amp, tick, *, row_offset=0):
    """Pass A on the padded grid: (4, NYP, M, NXP) [w_sum, s_x, s_y, cnt],
    zero on empty slots and the ring.  The dense oracle of the slab-order
    pass (same terms, same order).

    Loops over the 9 * M neighbour offsets in the kernels' order and adds
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
        for a, t in zip(acc, _a_terms(nhx, nhy, w)):
            a += torch.where(mask, t, 0.0)
        acc[CNT] += mask.to(torch.float32)
    out = torch.zeros((NUM_A, nyp, m_slots, nxp), dtype=torch.float32, device=dev)
    out[:, 1:-1, :, 1:-1] = acc
    return out


def cell_pressure(ps: torch.Tensor, ignored_pressure) -> torch.Tensor:
    """p = max(0, w_sum - ignored) on counted slots (crate.py:261-275)."""
    return torch.where(ps[CNT] > 0, torch.clamp(ps[WS] - ignored_pressure, min=0.0), 0.0)


def _b_terms(s_x, s_y, cp, p_nb, nb_sx, nb_sy, nhx, nhy, w, smooth, tp2, bal, enable_spring):
    """Pass B's terms of one neighbour before the velocities, in the
    kernels' accumulator order."""
    align = ((s_x - nb_sx) * nhx + (s_y - nb_sy) * nhy) * smooth
    t_coef = align + ((p_nb + cp) - tp2)
    p_coef = cp + p_nb
    terms = [t_coef * nhx, t_coef * nhy, p_coef * nhx, p_coef * nhy]
    if enable_spring:
        terms += [(bal - w) * nhx, (bal - w) * nhy]
    return terms


def pair_pass_b_plain(
    grid, ps_grid, diameter, surface_smoothing, target_pressure,
    spring_overlap_balance, ignored_pressure, noise_amp, tick, *,
    enable_spring=False, row_offset=0,
):
    """Plain torch version of the grid-mode pass-B kernel: same inputs,
    same bits; (NB, NY, M, NXP)."""
    nyp, m_slots, nxp = _grid_dims(grid)
    ny = nyp - 2
    dev = grid.device
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
        terms = _b_terms(s_x, s_y, cp, nbv[4], nbv[5], nbv[6], nhx, nhy, w,
                         smooth, tp2, bal, enable_spring)
        terms += [nbv[VELX], nbv[VELY]]
        for a, t in zip(acc, terms):
            a += torch.where(mask, t, 0.0)
        acc[-1] += mask.to(torch.float32)
    occupied = sx > ALIVE_THRESHOLD
    out = torch.zeros((nb, ny, m_slots, nxp), dtype=torch.float32, device=dev)
    out[0, :, :, 1:-1] = torch.where(occupied, cp, 0.0)
    out[1:, :, :, 1:-1] = acc
    return out


# ---- slab order -------------------------------------------------------------


def _alive_keys(slab, row_start, nx):
    """(n alive, the (n,) int64 cell keys row * nx + cx of the alive prefix)."""
    n = int(row_start[-1])
    return n, slab[ROW, :n].long() * nx + slab[CX, :n].long()


def _slab_walk(slab, row_start, m_slots, nx, own, noise_amp, tick, row_offset, diam2, inv_diam):
    """The neighbours of the selves at slab columns ``own`` (each an in-cap
    column: the self's slot), in the kernels' order: yields (j, mask, nhx,
    nhy, w) per dy, dx and slot k, ``j`` the neighbour's column (0 where
    the mask is off).  The neighbour is the in-cap particle of rank k in
    cell (row + dy, cx + dx), jittered by the hash of its padded slot; the
    self's own column is left out."""
    ny = row_start.shape[0] - 1
    n, keys = _alive_keys(slab, row_start, nx)
    pid = ((slab[ROW, :n].long() + 1 + row_offset) * (16 * 8192)
           + slab[RANK, :n].long() * 8192 + slab[CX, :n].long() + 1)
    npx, npy = _jitter(slab[POSX, :n], slab[POSY, :n], pid, noise_amp, tick)
    in_cap = slab[IN_CAP, :n] > 0
    sx, sy = slab[POSX, own], slab[POSY, own]
    s_row, s_cx = slab[ROW, own].long(), slab[CX, own].long()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            r, c = s_row + dy, s_cx + dx
            inside = (r >= 0) & (r < ny) & (c >= 0) & (c < nx)
            start = torch.searchsorted(keys, r * nx + c)
            end = torch.searchsorted(keys, r * nx + c, right=True)
            for k in range(m_slots):
                j = start + k
                live = inside & (j < end) & (j != own)
                j = torch.where(live, j, 0)
                live = live & in_cap[j]
                near, nhx, nhy, w = _geometry(sx, sy, slab[POSX, j], slab[POSY, j],
                                              npx[j], npy[j], diam2, inv_diam)
                yield j, live & near, nhx, nhy, w


def pair_pass_a_slab_plain(slab, row_start, m_slots, nx, diameter, noise_amp, tick, *,
                           row_offset=0):
    """Plain torch version of the slab-order pass-A kernel: same inputs,
    same bits.  Vectorised over the in-cap columns; loops over the 9 * M
    neighbour (cell, rank) offsets in the kernels' order."""
    p_pad, _ = _slab_dims(slab, row_start, m_slots, nx)
    dev = slab.device
    coef = coef_a(diameter, noise_amp, dev)
    diam = coef[0]
    diam2, inv_diam = diam * diam, 1.0 / diam
    n = int(row_start[-1])
    selves = torch.nonzero(slab[IN_CAP, :n] > 0).squeeze(1)
    acc = torch.zeros((NUM_A, selves.shape[0]), dtype=torch.float32, device=dev)
    for _, mask, nhx, nhy, w in _slab_walk(slab, row_start, m_slots, nx, selves, coef[1],
                                           tick, row_offset, diam2, inv_diam):
        for a, t in zip(acc, _a_terms(nhx, nhy, w)):
            a += torch.where(mask, t, 0.0)
        acc[CNT] += mask.to(torch.float32)
    out = torch.zeros((NUM_A, p_pad), dtype=torch.float32, device=dev)
    out[:, selves] = acc
    return out


def pair_pass_b_emit_plain(
    slab, ps, row_start, m_slots, nx, diameter, surface_smoothing, target_pressure,
    spring_overlap_balance, ignored_pressure, noise_amp, tick, *, enable_spring=False,
):
    """Plain torch version of the emit-mode pass-B kernel: same inputs,
    same bits.  Column p of an alive particle reads its slot's sums, an
    over-cap one its cellmate's (column p - rank + rank % M); the noise row
    offset is 0."""
    p_pad, _ = _slab_dims(slab, row_start, m_slots, nx)
    dev = slab.device
    coef = coef_b(diameter, surface_smoothing, target_pressure,
                  spring_overlap_balance, ignored_pressure, noise_amp, dev)
    diam = coef[0]
    diam2, inv_diam = diam * diam, 1.0 / diam
    smooth, tp2, bal = coef[1], 2.0 * coef[2], coef[3]
    n = int(row_start[-1])
    rank = slab[RANK, :n].long()
    own = torch.arange(n, device=dev) - rank + rank % m_slots
    cp_col = cell_pressure(ps[:, :n], coef[5])
    cp, s_x, s_y = cp_col[own], ps[SX, own], ps[SY, own]
    n_acc = 6 if enable_spring else 4
    acc = torch.zeros((n_acc + 3, n), dtype=torch.float32, device=dev)
    for j, mask, nhx, nhy, w in _slab_walk(slab, row_start, m_slots, nx, own, coef[4], tick,
                                           0, diam2, inv_diam):
        terms = _b_terms(s_x, s_y, cp, cp_col[j], ps[SX, j], ps[SY, j], nhx, nhy, w,
                         smooth, tp2, bal, enable_spring)
        terms += [slab[VELX, j], slab[VELY, j]]
        for a, t in zip(acc, terms):
            a += torch.where(mask, t, 0.0)
        acc[-1] += mask.to(torch.float32)
    out = torch.zeros((num_b(enable_spring), p_pad), dtype=torch.float32, device=dev)
    out[0, :n] = cp
    out[1:, :n] = acc
    return out


def _slot_columns(planes, slab, row_start, m_slots, in_cap_only):
    """(F, P_pad) slab-order columns of per-slot planes (F, NY, M, NXP):
    column p of an alive particle (of an in-cap one with ``in_cap_only``)
    reads slot (row, rank % M, cx + 1); every other column is 0."""
    f, _, _, nxp = planes.shape
    p_pad = slab.shape[1]
    valid = torch.arange(p_pad, device=slab.device) < int(row_start[-1])
    if in_cap_only:
        valid = valid & (slab[IN_CAP] > 0)
    cx, rank, row = (slab[r].long() for r in (CX, RANK, ROW))
    idx = torch.where(valid, (row * m_slots + rank % m_slots) * nxp + cx + 1, 0)
    return torch.where(valid, planes.reshape(f, -1)[:, idx], 0.0)


def pass_a_via_grid(slab, row_start, m_slots, nx, diameter, noise_amp, tick, *, row_offset=0):
    """Slab-order pass A through the dense grid: the slab placed, the dense
    plain pass A, its slots gathered back to the in-cap columns."""
    from .placement import place_grid_plain

    ny = row_start.shape[0] - 1
    grid = place_grid_plain(slab, row_start, m_slots, nx, ny, nx + 2)
    ps_grid = pair_pass_a_plain(grid, diameter, noise_amp, tick, row_offset=row_offset)
    return _slot_columns(ps_grid[:, 1:-1], slab, row_start, m_slots, True)


def pass_b_emit_via_grid(slab, ps, row_start, m_slots, nx, *coefs, enable_spring=False):
    """Emit-mode pass B through the dense grids: the slab and its pass-A
    columns placed, the dense plain grid-mode pass B, its slots gathered
    back to the alive columns (an over-cap one reads slot rank % M)."""
    from .placement import place_grid_plain, with_features

    ny = row_start.shape[0] - 1
    grid = place_grid_plain(slab, row_start, m_slots, nx, ny, nx + 2)
    ps_grid = place_grid_plain(with_features(slab, ps), row_start, m_slots, nx, ny, nx + 2)
    out = pair_pass_b_plain(grid, ps_grid, *coefs, enable_spring=enable_spring)
    return _slot_columns(out, slab, row_start, m_slots, False)


# ---- the slab-order kernels' windows -------------------------------------------


def _cell_start(keys, n, nx, ny, r, c):
    """The first alive column of cell (r, c) or of the next occupied cell
    after it (c == nx: the end of row r); rows before 0 start at 0, rows
    from ny on at n."""
    at = torch.searchsorted(keys, r * nx + c)
    return torch.where(r < 0, 0, torch.where(r >= ny, n, at))


def tile_windows(slab, row_start, nx, tile=SLAB_TILE):
    """(6, ntiles) int64: rows 0-2 the first and rows 3-5 the end column of
    each tile's candidate window at row offsets -1, 0, +1, as the
    slab-order kernels find them: from cell (row_first + dy, cx_first - 1)
    to the end of cell (row_last + dy, cx_last + 1), first and last the
    tile's first and last alive columns ([0, 0) for a tile with none)."""
    ny = row_start.shape[0] - 1
    n, keys = _alive_keys(slab, row_start, nx)
    t0 = torch.arange(-(-slab.shape[1] // tile), device=slab.device) * tile
    live = t0 < n
    first = torch.where(live, t0, 0)
    last = torch.where(live, torch.clamp(t0 + tile - 1, max=n - 1), 0)
    row_f, cx_f = slab[ROW, first].long(), slab[CX, first].long()
    row_l, cx_l = slab[ROW, last].long(), slab[CX, last].long()
    lo = [_cell_start(keys, n, nx, ny, row_f + dy, torch.clamp(cx_f - 1, min=0))
          for dy in (-1, 0, 1)]
    hi = [_cell_start(keys, n, nx, ny, row_l + dy, torch.clamp(cx_l + 1, max=nx - 1) + 1)
          for dy in (-1, 0, 1)]
    return torch.where(live, torch.stack(lo + hi), 0)


def cell_ranges(slab, row_start, nx):
    """(6, P_pad) int64: for each alive column, the first (rows 0-2) and end
    (rows 3-5) column of its three cells at row offsets -1, 0, +1 (row + dy,
    max(cx - 1, 0) .. min(cx + 1, nx - 1)) — what one lane walks; empty for
    a row outside the grid and for dead and padding columns."""
    ny = row_start.shape[0] - 1
    n, keys = _alive_keys(slab, row_start, nx)
    p_pad = slab.shape[1]
    row, cx = slab[ROW, :n].long(), slab[CX, :n].long()
    out = torch.zeros((6, p_pad), dtype=torch.int64, device=slab.device)
    for q, dy in enumerate((-1, 0, 1)):
        r = row + dy
        inside = (r >= 0) & (r < ny)
        a = torch.searchsorted(keys, r * nx + torch.clamp(cx - 1, min=0))
        b = torch.searchsorted(keys, r * nx + torch.clamp(cx + 1, max=nx - 1) + 1)
        out[q, :n] = torch.where(inside, a, 0)
        out[3 + q, :n] = torch.where(inside, b, 0)
    return out


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _slab_batch(fn, slab, row_start, m_slots, nx):
    """(B, P_pad, ny) of a crate-axis slab (B, 8, P_pad) and its row starts
    (B, ny + 1) on the card; raises on what the kernels do not take."""
    if slab.dim() != 3 or row_start.dim() != 2 or row_start.shape[0] != slab.shape[0]:
        raise ValueError(f"{fn}: slab (B, 8, P_pad) and row_start (B, ny + 1) expected, got "
                         f"{tuple(slab.shape)} and {tuple(row_start.shape)}")
    p_pad, ny = _slab_dims(slab[0], row_start[0], m_slots, nx)
    B = slab.shape[0]
    check_cuda(f"{fn}: slab", slab, torch.float32, (B, SLAB_F, p_pad))
    check_cuda(f"{fn}: row_start", row_start, torch.int32, (B, ny + 1))
    return B, p_pad, ny


@torch.library.custom_op(
    "sand_crate::pair_pass_a", mutates_args=(),
    schema="(Tensor slab, Tensor row_start, Tensor coef, Tensor tick, int m_slots, int nx, "
           "int row_offset) -> Tensor")
def _pass_a_op(slab, row_start, coef, tick, m_slots, nx, row_offset):
    """K4+K5 over a leading crate axis: slab (B, 8, P_pad), row_start (B,
    ny + 1), coef (B, 2) [diameter, noise amplitude], tick (B,) ->
    (B, 4, P_pad)."""
    if slab.device.type == "cpu":
        return crates_plain(
            "pair_pass_a",
            lambda sl, rs, c, t: pair_pass_a_slab_plain(sl, rs, m_slots, nx, c[0], c[1], t,
                                                        row_offset=row_offset),
            (slab, row_start, coef, tick))
    if slab.device.type != "cuda":
        raise ValueError(f"pair_pass_a: tensors on {slab.device}; expected cpu or cuda")
    B, p_pad, ny = _slab_batch("pair_pass_a", slab, row_start, m_slots, nx)
    dev = slab.device
    check_cuda("pair_pass_a: coef", coef, torch.float32, (B, 2))
    check_cuda("pair_pass_a: tick", tick, torch.int32, (B,))
    ps = torch.empty((B, NUM_A, p_pad), dtype=torch.float32, device=dev)
    if B:
        run_kernel("pair_pass_a", load_lib().sc_pass_a, slab.data_ptr(), row_start.data_ptr(),
                   coef.data_ptr(), tick.data_ptr(), ps.data_ptr(), p_pad, ny, nx,
                   int(row_offset), B, device=dev)
    return ps


@torch.library.custom_op(
    "sand_crate::pair_pass_b_emit", mutates_args=(),
    schema="(Tensor slab, Tensor ps, Tensor row_start, Tensor coef, Tensor tick, int m_slots, "
           "int nx, int spring) -> Tensor")
def _pass_b_emit_op(slab, ps, row_start, coef, tick, m_slots, nx, spring):
    """K8+K9 over a leading crate axis: slab (B, 8, P_pad), ps (B, 4,
    P_pad), row_start (B, ny + 1), coef (B, 6) in coef_b's order, tick (B,)
    -> (B, 8|10, P_pad)."""
    if slab.device.type == "cpu":
        return crates_plain(
            "pair_pass_b_emit",
            lambda sl, p, rs, c, t: pair_pass_b_emit_plain(  # c in coef_b's order
                sl, p, rs, m_slots, nx, c[0], c[1], c[2], c[3], c[5], c[4], t,
                enable_spring=bool(spring)),
            (slab, ps, row_start, coef, tick))
    if slab.device.type != "cuda":
        raise ValueError(f"pair_pass_b_emit: tensors on {slab.device}; expected cpu or cuda")
    B, p_pad, ny = _slab_batch("pair_pass_b_emit", slab, row_start, m_slots, nx)
    dev = slab.device
    check_cuda("pair_pass_b_emit: ps", ps, torch.float32, (B, NUM_A, p_pad))
    check_cuda("pair_pass_b_emit: coef", coef, torch.float32, (B, 6))
    check_cuda("pair_pass_b_emit: tick", tick, torch.int32, (B,))
    if not (ps.device == row_start.device == coef.device == tick.device == dev):
        raise ValueError("pair_pass_b_emit: the operands must share one device")
    out = torch.empty((B, num_b(bool(spring)), p_pad), dtype=torch.float32, device=dev)
    if B:
        run_kernel("pair_pass_b_emit", load_lib().sc_pass_b_emit, slab.data_ptr(),
                   ps.data_ptr(), row_start.data_ptr(), coef.data_ptr(), tick.data_ptr(),
                   out.data_ptr(), p_pad, ny, nx, m_slots, int(spring), B, device=dev)
    return out


register_crate_vmap(_pass_a_op, 4)
register_crate_vmap(_pass_b_emit_op, 5)


def pair_pass_a(slab, row_start, m_slots, nx, diameter, noise_amp, tick, *, row_offset=0):
    """Pass A in slab order: (4, P_pad) [w_sum, s_x, s_y, cnt] of each
    in-cap column of the cell-sorted ``slab`` (8, P_pad), 0 elsewhere;
    ``row_start`` (ny + 1,) int32 holds its grid rows' first columns and
    ``m_slots`` is the cell capacity the slab was built with.  Through the
    ``sand_crate::pair_pass_a`` operator as a batch of one (under
    ``torch.func.vmap``, one launch for the whole batch).

    ``row_offset``: the global padded-row index of the grid's row 0
    (nonzero only for a spatial band); it keys the collider noise."""
    dev = slab.device
    _slab_dims(slab, row_start, m_slots, nx)
    # The tick's own device tensor, and the row offset as a kernel argument:
    # a host scalar copied to the card waits for the stream to drain.
    coef = coef_a(diameter, noise_amp, dev)
    tick = _tensor(tick, dev, torch.int32)
    return pair_pass_a_crates(slab[None], row_start[None], m_slots, nx, coef[None], tick[None],
                              row_offset=row_offset)[0]


def pair_pass_a_crates(slab, row_start, m_slots, nx, coef, tick, *, row_offset=0):
    """Pass A of B crates at once: slab (B, 8, P_pad), row_start (B, ny + 1)
    int32, coef (B, 2) f32 rows of :func:`coef_a`, tick (B,) int32 ->
    (B, 4, P_pad), through the ``sand_crate::pair_pass_a`` operator: one
    launch for all B crates on the card, the plain version crate by crate
    on the CPU."""
    on_cpu_or_cuda("pair_pass_a", slab)
    return torch.ops.sand_crate.pair_pass_a(slab, row_start, coef, tick, m_slots, nx,
                                            int(row_offset))


def pair_pass_b_emit(
    slab, ps, row_start, m_slots, nx, diameter, surface_smoothing, target_pressure,
    spring_overlap_balance, ignored_pressure, noise_amp, tick, *, enable_spring=False,
):
    """Pass B emitting results in slab (= sorted state) order: (NB, P_pad)
    from the slab, its pass-A columns ``ps`` (4, P_pad) and ``row_start``,
    through the ``sand_crate::pair_pass_b_emit`` operator as a batch of one
    (under ``torch.func.vmap``, one launch for the whole batch).

    Column p of an alive particle holds the sums of its slot (row, rank,
    cx + 1) — an over-cap particle its cellmate's of rank % M, as
    ``slot_assignment``'s gather_slot — and every other column is 0."""
    dev = slab.device
    _slab_dims(slab, row_start, m_slots, nx)
    coef = coef_b(diameter, surface_smoothing, target_pressure, spring_overlap_balance,
                  ignored_pressure, noise_amp, dev)
    tick = _tensor(tick, dev, torch.int32)
    return pair_pass_b_emit_crates(slab[None], ps[None], row_start[None], m_slots, nx,
                                   coef[None], tick[None], enable_spring=enable_spring)[0]


def pair_pass_b_emit_crates(slab, ps, row_start, m_slots, nx, coef, tick, *,
                            enable_spring=False):
    """Emit-mode pass B of B crates at once: slab (B, 8, P_pad), ps (B, 4,
    P_pad), row_start (B, ny + 1) int32, coef (B, 6) f32 rows of
    :func:`coef_b`, tick (B,) int32 -> (B, 8|10, P_pad), through the
    ``sand_crate::pair_pass_b_emit`` operator: one launch for all B crates
    on the card, the plain version crate by crate on the CPU."""
    on_cpu_or_cuda("pair_pass_b_emit", slab)
    return torch.ops.sand_crate.pair_pass_b_emit(slab, ps, row_start, coef, tick, m_slots, nx,
                                                 int(enable_spring))


def pair_pass_b(
    grid, ps_grid, diameter, surface_smoothing, target_pressure,
    spring_overlap_balance, ignored_pressure, noise_amp, tick, *,
    enable_spring=False, row_offset=0,
):
    """Grid-mode pass B: every per-slot result plane, (8|10, NY, M, NXP) —
    [pressure, tension xy, pressure-force xy, (spring xy), viscosity xy,
    count], the PairSums order — from the padded grids G and PS."""
    args = (grid, ps_grid, diameter, surface_smoothing, target_pressure,
            spring_overlap_balance, ignored_pressure, noise_amp, tick)
    if grid.device.type == "cpu":
        return pair_pass_b_plain(*args, enable_spring=enable_spring, row_offset=row_offset)
    nyp, m_slots, nxp = _grid_dims(grid)
    check_cuda("pair_pass_b: grid", grid, torch.float32, grid.shape)
    check_cuda("pair_pass_b: ps_grid", ps_grid, torch.float32, grid.shape)
    if nxp % GRID_BLOCK_COLS:
        raise ValueError(f"pair_pass_b: the kernel tiles {GRID_BLOCK_COLS} columns a block; "
                         f"grid width {nxp} is not a multiple")
    dev = grid.device
    if ps_grid.device != dev:
        raise ValueError("pair_pass_b: the operands must share one device")
    coef = coef_b(diameter, surface_smoothing, target_pressure,
                  spring_overlap_balance, ignored_pressure, noise_amp, dev)
    tick = _tensor(tick, dev, torch.int32)
    out = torch.empty((num_b(enable_spring), nyp - 2, m_slots, nxp), dtype=torch.float32,
                      device=dev)
    run_kernel("pair_pass_b_grid", load_lib().sc_pass_b, grid.data_ptr(), ps_grid.data_ptr(),
               coef.data_ptr(), tick.data_ptr(), out.data_ptr(), nyp, m_slots, nxp,
               int(row_offset), int(enable_spring), device=dev)
    return out
