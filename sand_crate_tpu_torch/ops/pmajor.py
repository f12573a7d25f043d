"""P-major (grid-free) pair sums on the cell-sorted particle slab.

The PyTorch counterpart of ``sand_crate_tpu/ops/pmajor.py``.  For every
sorted self particle, the pair passes sum over the candidates in three
contiguous ranges of the sorted slab — the cells (row + d, col - 1 .. col + 1)
for row offsets d in {-1, 0, +1} — under the JAX kernel's pair mask: raw
encoded distance <= diameter, candidate row == self row + d, j != i.

    feature rows -> pass A (w_sum, s, count, vsum) -> cell pressure
                 -> pass B (tension [+ pressure] [+ spring] forces)

Each pass is :func:`pm_pass`: on CUDA tensors it launches the hand-written
kernel ``csrc/pmajor.cu`` (built by ``nvcc`` at first use); on CPU tensors
it runs :func:`pm_pass_plain`, the vectorised torch version of the same
function.  The candidate ranges are exact per particle (``torch.searchsorted``
on the sorted cell ids), so no pair is lost and ``PairSums.overflow`` is 0 —
where the JAX kernel's fixed window budget ``w`` can lose and count pairs.
The JAX kernel's TPU tactics (128-lane window anchoring, VMEM residency,
``split``/``gate`` tiles, the searchsorted-by-sorting merge and the j-side
staging merge) have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from ..cellwise import PairSums, cell_ids_grid
from ..state import Scene
from . import cuda_build

# ops/pair_kernel.py:73-84: alive positions carry +ALIVE_OFFSET, so every
# alive-dead pair is ~2 units apart and fails the cutoff; EPS floors the
# jittered squared distance at EPS^2.
ALIVE_OFFSET = 2.0
EPS = 1e-12

# Slab columns (particle-major (P, 8) f32: one 32-byte row per particle).
A_PX, A_PY, A_NPX, A_NPY, A_VX, A_VY, A_ROW = 0, 1, 2, 3, 4, 5, 6
B_PX, B_PY, B_NPX, B_NPY, B_CP, B_SX, B_SY, B_ROW = 0, 1, 2, 3, 4, 5, 6, 7
SLAB_F = 8

# Kernel launches per mode since the last reset, counted by pm_pass where it
# launches the CUDA kernel (never for the plain version).
LAUNCHES = {"a": 0, "b": 0}

# Selves per chunk of the plain version (bounds its (chunk, span, 8) gather).
PLAIN_CHUNK = 1 << 16

_I32_MASK = 0xFFFFFFFF


def _u01(seed: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    """The pair_kernel noise mix (integer hash -> [0, 1) f32), bit-exact.

    The JAX hash multiplies int32s with wraparound and shifts logically.
    Here the arithmetic runs in int64 on the 32-bit pattern, masked back to
    32 bits after every multiply: each product is < 2^32 * 2^31, so nothing
    overflows, and the shifts of a non-negative value are logical."""
    h = (seed.long() * -1640531527) & _I32_MASK
    h = h ^ ((tick.long() * -1028477387) & _I32_MASK)
    h = h ^ (h >> 15)
    h = (h * -2048144789) & _I32_MASK
    h = h ^ (h >> 13)
    return (h >> 8).to(torch.float32) * 2.0**-24


def feature_rows(pos, vel, alive, noise_amp, tick):
    """Offset-encoded + pre-jittered f32 feature rows for the slab.

    Returns (pxo, pyo, npx, npy, vx, vy), each (P,) f32.  Jitter is keyed
    by the sorted index + tick, as in the JAX package."""
    f32 = torch.float32
    af = alive.to(pos.dtype)
    pxo = (pos[:, 0] + ALIVE_OFFSET * af).to(f32)
    pyo = (pos[:, 1] + ALIVE_OFFSET * af).to(f32)
    iota = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    amp = noise_amp.to(f32)
    npx = pxo + (_u01(iota * 2, tick) - 0.5) * amp
    npy = pyo + (_u01(iota * 2 + 1, tick) - 0.5) * amp
    return pxo, pyo, npx, npy, vel[:, 0].to(f32), vel[:, 1].to(f32)


def coef_stack(diameter, target_pressure, balance):
    """The (3,) f32 coefficient vector the pair passes read on the device:
    diameter, target_pressure, spring_overlap_balance.  (surface_smoothing
    is not in it: the SX/SY slab columns arrive prescaled.)"""
    vals = [diameter, target_pressure, balance]
    return torch.stack([v.to(torch.float32) for v in vals])


def finalize_cp(w_sum, cnt, ignored_pressure):
    """Cell pressure from pass-A sums (crate.py:261-275 semantics)."""
    return torch.where(cnt > 0, torch.clamp(w_sum - ignored_pressure, min=0.0), 0.0)


def candidate_ranges(sorted_cid: torch.Tensor, alive: torch.Tensor, nx: int, ny: int):
    """(6, P) int32 exact candidate ranges of every sorted particle.

    Rows 0-2 are the first and rows 3-5 the end slab position of the cells
    [cid + d*nx - 1, cid + d*nx + 2) for d = -1, 0, +1, clipped to the grid as
    in the JAX ``_windows``.  Dead selves get empty ranges."""
    NC = nx * ny
    d = torch.tensor([-nx, 0, nx], dtype=torch.int32, device=sorted_cid.device)
    base = sorted_cid[None, :] + d[:, None]  # (3, P)
    lo = torch.clamp(base - 1, 0, NC)
    hi = torch.clamp(base + 2, 0, NC)
    ws = torch.searchsorted(sorted_cid, lo, out_int32=True)
    we = torch.searchsorted(sorted_cid, hi, out_int32=True)
    we = torch.where(alive[None, :], we, ws)
    return torch.cat([ws, we]).contiguous()


def _n_out(mode: str, fold: bool, spring: bool) -> int:
    if mode == "a":
        return 6  # w_sum, s_x, s_y, cnt, vsum_x, vsum_y
    return 2 if fold else (6 if spring else 4)


def pm_pass_plain(slab, ranges, coef, mode, *, fold=False, spring=False, symm=False):
    """Plain torch version of the CUDA pair pass: same inputs, same outputs.

    Pads each self's candidate range to the chunk's longest and masks, one
    range (row offset) at a time, over chunks of ``PLAIN_CHUNK`` selves.
    The pair terms are computed with the kernel's operations in the
    kernel's order (1/sqrt, no fused multiply-add) and summed one candidate
    column at a time in ascending slab order, as the kernel sums them, so
    the two agree bit for bit."""
    P = slab.shape[0]
    n_out = _n_out(mode, fold, spring)
    out = torch.zeros((n_out, P), dtype=torch.float32, device=slab.device)
    diam = coef[0]
    diam2 = diam * diam
    inv_diam = 1.0 / torch.clamp(diam, min=EPS)
    tp2 = 2.0 * coef[1]
    bal = coef[2]
    row_col = A_ROW if mode == "a" else B_ROW
    for start in range(0, P, PLAIN_CHUNK):
        stop = min(start + PLAIN_CHUNK, P)
        s = slab[start:stop, None, :]  # (C, 1, 8)
        gid = torch.arange(start, stop, device=slab.device)[:, None]
        acc = [0.0] * n_out
        for q in range(3):
            ws, we = ranges[q, start:stop], ranges[3 + q, start:stop]
            span = int((we - ws).max())
            if span <= 0:
                continue
            j = ws[:, None].long() + torch.arange(span, device=slab.device)
            valid = j < we[:, None]
            j = torch.where(valid, j, gid)
            c = slab[j]  # (C, span, 8)
            rx = s[..., A_PX] - c[..., A_PX]
            ry = s[..., A_PY] - c[..., A_PY]
            mb = (
                valid
                & (rx * rx + ry * ry <= diam2)
                & (c[..., row_col] == s[..., row_col] + float(q - 1))
                & (j != gid)
            )
            if symm:
                nrx = s[..., A_NPX] - c[..., A_NPX]
                nry = s[..., A_NPY] - c[..., A_NPY]
            else:
                nrx = s[..., A_PX] - c[..., A_NPX]
                nry = s[..., A_PY] - c[..., A_NPY]
            nd2 = torch.clamp(nrx * nrx + nry * nry, min=EPS * EPS)
            inv = 1.0 / torch.sqrt(nd2)
            if mode == "a" or spring:
                wgt = 1.0 - torch.clamp(nd2 * inv * inv_diam, max=1.0)
            if mode == "a":
                ci = (1.0 - wgt) * wgt * inv
                terms = [wgt, ci * nrx, ci * nry, torch.ones_like(wgt),
                         c[..., A_VX], c[..., A_VY]]
            else:
                nhx = nrx * inv
                nhy = nry * inv
                align = (s[..., B_SX] - c[..., B_SX]) * nhx + (
                    s[..., B_SY] - c[..., B_SY]
                ) * nhy
                t_coef = align + (c[..., B_CP] + (s[..., B_CP] - tp2))
                terms = [t_coef * nhx, t_coef * nhy]
                if not fold:
                    p_coef = s[..., B_CP] + c[..., B_CP]
                    terms += [p_coef * nhx, p_coef * nhy]
                    if spring:
                        terms += [(bal - wgt) * nhx, (bal - wgt) * nhy]
            terms = [torch.where(mb, t, 0.0) for t in terms]
            for col in range(span):
                acc = [a + t[:, col] for a, t in zip(acc, terms)]
        for k in range(n_out):
            out[k, start:stop] = acc[k]
    return out


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"pm_pass: {name} is on {t.device}, expected the CUDA device")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"pm_pass: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape}, got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _lib():
    lib = cuda_build.load("pmajor")
    fn = lib.sc_pm_pass
    if fn.argtypes is None:  # pointers as c_void_p: ctypes would cut them to int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pm_pass(slab, ranges, coef, mode, *, fold=False, spring=False, symm=False):
    """One pair pass over the sorted slab -> (n_out, P) f32 sums.

    ``mode`` "a" sums (w_sum, s_x, s_y, count, vsum_x, vsum_y); "b" sums
    the folded force (2 rows) or tension and pressure (4) plus the spring
    (6).  CPU tensors run :func:`pm_pass_plain`; CUDA tensors launch the
    kernel of ``csrc/pmajor.cu`` on the current stream (and count it in
    ``LAUNCHES``); tensors elsewhere raise."""
    if mode not in ("a", "b"):
        raise ValueError(f"pm_pass: mode must be 'a' or 'b', got {mode!r}")
    if slab.device.type == "cpu":
        return pm_pass_plain(slab, ranges, coef, mode, fold=fold, spring=spring, symm=symm)
    P = slab.shape[0]
    _check("slab", slab, torch.float32, (P, SLAB_F))
    _check("ranges", ranges, torch.int32, (6, P))
    _check("coef", coef, torch.float32, (3,))
    if not (slab.device == ranges.device == coef.device):
        raise ValueError("pm_pass: slab, ranges and coef must share one device")
    n_out = _n_out(mode, fold, spring)
    out = torch.empty((n_out, P), dtype=torch.float32, device=slab.device)
    with torch.cuda.device(slab.device):  # launch on the tensors' card
        err = _lib().sc_pm_pass(
            slab.data_ptr(), ranges.data_ptr(), coef.data_ptr(), out.data_ptr(),
            P, 0 if mode == "a" else 1, n_out, int(symm),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pm_pass kernel (mode {mode}) failed: cudaError {err}")
    LAUNCHES[mode] += 1
    return out


def pass_a_inputs(pos, vel, alive, sorted_cid, noise_amp, tick, scene: Scene):
    """(slab_a, ranges): the pass-A slab and the candidate ranges.

    Under ``scene.pmajor_symm`` both positions of a pair are jittered, so
    the single-particle amplitude is scaled by 1/sqrt(2) to keep the
    pair-delta jitter variance at the reference's one-sided level."""
    nx, ny = scene.grid_nx, scene.grid_ny
    if scene.pmajor_symm:
        noise_amp = noise_amp * 0.7071067811865476
    pxo, pyo, npx, npy, vx, vy = feature_rows(pos, vel, alive, noise_amp, tick)
    row = torch.where(alive, sorted_cid // nx, ny).to(torch.float32)
    zero = torch.zeros_like(row)
    slab_a = torch.stack([pxo, pyo, npx, npy, vx, vy, row, zero], dim=1)
    return slab_a, candidate_ranges(sorted_cid, alive, nx, ny)


def pass_b_slab(slab_a, out_a, cp_slab, surface_smoothing):
    """The pass-B slab: pass A's positions and row, the cell pressure, and
    the pass-A normal sums prescaled by ``surface_smoothing``."""
    sm = surface_smoothing.to(torch.float32)
    cols = [slab_a[:, :4], cp_slab[:, None], (sm * out_a[1:3]).T, slab_a[:, A_ROW:A_ROW + 1]]
    return torch.cat(cols, dim=1).contiguous()


def neighbor_forces_pmajor_sorted(
    pos: torch.Tensor,  # all inputs pre-sorted by cell id (sorted-state step)
    vel: torch.Tensor,
    alive: torch.Tensor,
    sorted_cid: torch.Tensor,
    noise_amp: torch.Tensor,
    tick: torch.Tensor,
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    ignored_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
    scene: Scene,
    *,
    pressure_amplifier: torch.Tensor | None = None,
) -> PairSums:
    """Grid-free pair sums over pre-sorted operands, in the same order.

    When ``scene.fold_pairs`` is set, the spring is off AND the caller
    supplies ``pressure_amplifier``, pass B emits one folded force sum
    (tension + pa * pressure): the PairSums carry it in ``dv_tension`` and
    zeros in ``pressure_real``.  Callers that omit ``pressure_amplifier``
    (tests) always get the split sums."""
    fold = (
        scene.fold_pairs
        and pressure_amplifier is not None
        and not scene.enable_spring
    )
    symm = scene.pmajor_symm
    P = pos.shape[0]
    dtype = pos.dtype

    slab_a, ranges = pass_a_inputs(pos, vel, alive, sorted_cid, noise_amp, tick, scene)
    coef = coef_stack(diameter, target_pressure, spring_overlap_balance)
    out_a = pm_pass(slab_a, ranges, coef, "a", symm=symm)
    w_sum, cnt = out_a[0], out_a[3]
    cp = finalize_cp(w_sum, cnt, ignored_pressure)
    cp_slab = cp * (1.0 + pressure_amplifier) if fold else cp
    slab_b = pass_b_slab(slab_a, out_a, cp_slab, surface_smoothing)
    out_b = pm_pass(
        slab_b, ranges, coef, "b", fold=fold, spring=scene.enable_spring, symm=symm
    )

    # Dead selves have empty candidate ranges, so every dead row is zero.
    zeros2 = torch.zeros((P, 2), dtype=dtype, device=pos.device)
    return PairSums(
        p_i=cp.to(dtype),
        dv_tension=out_b[0:2].T.to(dtype),
        pressure_real=zeros2 if fold else out_b[2:4].T.to(dtype),
        spring_real=out_b[4:6].T.to(dtype) if scene.enable_spring else zeros2,
        visc_vsum=out_a[4:6].T.to(dtype),
        nbr_cnt=cnt.to(dtype),
        overflow=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def neighbor_forces_pmajor(
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: torch.Tensor,
    noise_amp: torch.Tensor,
    tick: torch.Tensor,
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    ignored_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
    scene: Scene,
    *,
    pressure_amplifier: torch.Tensor | None = None,
) -> PairSums:
    """Particle-order convenience wrapper (tests): sort, run, un-permute."""
    cid = cell_ids_grid(pos, alive, scene)
    order = torch.sort(cid, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    sums = neighbor_forces_pmajor_sorted(
        pos[order],
        vel[order],
        alive[order],
        cid[order].contiguous(),
        noise_amp,
        tick,
        diameter,
        surface_smoothing,
        target_pressure,
        ignored_pressure,
        spring_overlap_balance,
        scene,
        pressure_amplifier=pressure_amplifier,
    )
    return PairSums(*(f[inv] for f in sums[:-1]), overflow=sums.overflow)
