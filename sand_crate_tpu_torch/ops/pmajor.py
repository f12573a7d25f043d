"""P-major (grid-free) pair sums on the cell-sorted particle slab.

The PyTorch counterpart of ``sand_crate_tpu/ops/pmajor.py``.  For every
sorted self particle, the pair passes sum over the candidates in three
contiguous ranges of the sorted slab — the cells (row + d, col - 1 .. col + 1)
for row offsets d in {-1, 0, +1} — under the JAX kernel's pair mask: raw
encoded distance <= diameter, candidate row == self row + d, j != i.

    feature rows -> pass A (w_sum, s, count, vsum) -> cell pressure
                 -> pass B (tension [+ pressure] [+ spring] forces)

Two candidate-walk schedules compute the passes, both hand-written CUDA
kernels of ``csrc/pmajor.cu`` (built by ``nvcc`` at first use) beside their
vectorised torch versions, which CPU tensors run:

* :func:`pm_pass` (K1/K2, the default): one thread per self walks its own
  exact candidate ranges (:func:`candidate_ranges`, ``torch.searchsorted``
  on the sorted cell ids) out of shared memory, where each warp of
  ``PM_TILE`` selves stages its windows (:func:`tile_windows`); plain
  version :func:`pm_pass_plain`.  It calls the custom operator
  ``torch.ops.sand_crate.pm_pass`` on one crate as a batch of one; the
  operator takes a leading crate axis (slab (B, P, 8), ranges (B, 6, P) in
  crate-local slab positions, coef (B, 3) -> (B, n_out, P)) and its vmap
  rule folds a vmapped batch into that axis, so batched crates
  (``sweep.batched_step``) launch K1/K2 once a pass for every crate.  On
  CPU tensors the operator runs the plain version crate by crate (its
  host read of the span happens there, not under ``vmap``).
* :func:`pms_pass` (K10, ``SAND_CRATE_PMSUB=1``): chunks of ``PMS_CHUNK``
  consecutive selves share one candidate window per row offset
  (:func:`chunk_windows`); each self finds its exact ranges inside its
  chunk's window in the kernel (:func:`window_ranges` finds the same bounds)
  and walks them as K1/K2 do, so no P-sized search runs before it; plain
  version :func:`pms_pass_plain`.  The same pairs in the same order as
  K1/K2 with one-sided noise, so the same bits.  It calls the custom
  operator ``torch.ops.sand_crate.pms_pass`` as a batch of one, which takes
  a leading crate axis as ``pm_pass``'s does (slab (B, P, 8), cell ids
  (B, P), windows (B, 7, nchunks), coef (B, 3) -> (B, n_out, P)), so a
  vmapped step under ``SAND_CRATE_PMSUB=1`` launches K10 once a pass for
  every crate.

The glue around the passes -- slab A (offset-encoded, jittered positions,
velocities, rows), the exact ranges, the cell pressure and slab B -- has
plain versions (:func:`pass_a_slab`, :func:`candidate_ranges`,
:func:`finalize_cp`, :func:`pass_b_slab`), which CPU tensors run, and two
entries through the custom operators ``torch.ops.sand_crate.pm_prep`` /
``.pm_slab_b`` (:func:`pair_prep`, :func:`pass_b_prep`): on CUDA tensors
they launch the kernels of ``csrc/pm_prep.cu`` (a cell-start table then a
thread per slot for slab A and the ranges; a thread per slot for slab B),
one call for a crate axis, with the plain versions' bits.  The band step
(``spatial.py``) takes :func:`pair_prep`'s slab A of its own sorted crate
and the plain ranges and slab B of its spliced slab.

Both visit every candidate, so no pair is lost and ``PairSums.overflow`` is
0 — where the JAX kernels' fixed window budgets (``w``, ``VCAP_SUB``) can
lose and count pairs.  The environment knobs of the JAX package are read at
call time, as JAX reads them at trace time (ops/pmajor.py:1138-1147, 1183):
``SAND_CRATE_PMSUB=1`` selects K10 and ``SAND_CRATE_PMAJOR_GATE=1`` keeps
K1/K2 (the gate branch of the JAX kernel skips tiles past the window span;
the per-thread exact walk already visits only those candidates); both turn
the two-sided ``pmajor_symm`` noise off, so the jitter is one-sided at the
full amplitude.  ``SAND_CRATE_PMSUB_G`` (the TPU kernel's candidate rows per
vreg group) changes no result and has no counterpart.  Nor do the other TPU
tactics: 128-lane window anchoring, VMEM residency, ``split`` tiles, the
searchsorted-by-sorting merge and the j-side staging merge.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..cellwise import PairSums, cell_ids_grid
from ..state import Scene
from . import cuda_build
from .crate_axis import crates_plain, on_cpu_or_cuda, register_crate_vmap

# ops/pair_kernel.py:73-84: alive positions carry +ALIVE_OFFSET, so every
# alive-dead pair is ~2 units apart and fails the cutoff; EPS floors the
# jittered squared distance at EPS^2.
ALIVE_OFFSET = 2.0
EPS = 1e-12

# Slab columns (particle-major (P, 8) f32: one 32-byte row per particle).
A_PX, A_PY, A_NPX, A_NPY, A_VX, A_VY, A_ROW = 0, 1, 2, 3, 4, 5, 6
B_PX, B_PY, B_NPX, B_NPY, B_CP, B_SX, B_SY, B_ROW = 0, 1, 2, 3, 4, 5, 6, 7
SLAB_F = 8

# Kernel launches per pass since the last reset, counted by pm_pass (K1/K2:
# "a", "b"; one for a whole crate axis) and pms_pass (K10: "sub_a",
# "sub_b") where they launch a CUDA kernel (never for the plain versions);
# the pair glue's calls of csrc/pm_prep.cu, one a call for a whole crate
# axis: pair_prep ("prep": slab A, and the ranges through their cell table)
# and pass_b_prep ("slab_b").
LAUNCHES = {"a": 0, "b": 0, "sub_a": 0, "sub_b": 0, "prep": 0, "slab_b": 0}

# Selves per chunk of the plain versions (bounds their (selves, span, 8)
# candidate gathers).
PLAIN_CHUNK = 1 << 16

# K1/K2's tile of sorted selves (one warp) and the candidates it stages per
# piece (kPiece of csrc/pmajor.cu).
PM_TILE = 32
PM_PIECE = 128

# Selves per K10 chunk: 32 (one warp) or 128 (the JAX kernel's chunk, one
# block of csrc/pmajor.cu's kThreads, four warps searching one window).
PMS_CHUNK = 32
PMS_CHUNKS = (32, 128)

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
    # -nx, 0, nx made on the device: a list copied to the card would wait
    # for its stream to drain.
    d = torch.arange(-1, 2, dtype=torch.int32, device=sorted_cid.device) * nx
    base = sorted_cid[None, :] + d[:, None]  # (3, P)
    lo = torch.clamp(base - 1, 0, NC)
    hi = torch.clamp(base + 2, 0, NC)
    ws = torch.searchsorted(sorted_cid, lo, out_int32=True)
    we = torch.searchsorted(sorted_cid, hi, out_int32=True)
    we = torch.where(alive[None, :], we, ws)
    return torch.cat([ws, we]).contiguous()


def tile_windows(ranges: torch.Tensor, tile: int = PM_TILE) -> torch.Tensor:
    """(6, ntiles) int32: the candidate windows K1/K2 stage per tile of
    ``tile`` consecutive selves, as the kernel computes them from the
    :func:`candidate_ranges` it is given.

    Rows 0-2 are the least start and rows 3-5 the largest end of the tile's
    non-empty ranges at row offset d = -1, 0, +1; a row offset with no
    non-empty range gets the empty window (0, 0).  The window covers every
    self's range whatever the ranges are; it is tight because the starts
    never decrease along the sorted order."""
    P = ranges.shape[1]
    ntiles = -(-P // tile)
    pad = ntiles * tile - P
    ws = torch.nn.functional.pad(ranges[:3], (0, pad)).view(3, ntiles, tile)
    we = torch.nn.functional.pad(ranges[3:], (0, pad)).view(3, ntiles, tile)
    live = ws < we
    big = torch.iinfo(torch.int32).max
    lo = torch.where(live, ws, big).amin(dim=2)
    hi = torch.where(live, we, 0).amax(dim=2)
    empty = ~live.any(dim=2)
    return torch.cat([torch.where(empty, 0, lo), torch.where(empty, 0, hi)]).to(torch.int32)


def chunk_windows(sorted_cid: torch.Tensor, alive: torch.Tensor, nx: int, ny: int,
                  chunk: int) -> torch.Tensor:
    """(7, nchunks) int32 candidate windows of chunks of ``chunk`` selves.

    The torch counterpart of the JAX ``_windows_sub`` (ops/pmajor.py:922)
    without its TPU tactics (merge-sort search, ``VCAP_SUB`` residency clip,
    ``SUB_G`` quantisation): per chunk of consecutive sorted selves, rows 0-2
    are the first and rows 3-5 the end slab position of one window per row
    offset d = -1, 0, +1, from the first self's range start to the last
    alive self's range end (:func:`candidate_ranges`; targets are monotone
    in the cell id, so the window covers every self's range exactly);
    row 6 is one past the chunk's last alive self.  Alive particles are the
    sorted prefix (dead ones sort to the cell id NC), and dead chunks get
    empty windows.  No value is read back to the host, so it runs under
    ``torch.func.vmap`` (a crate each) and inside a CUDA graph capture."""
    P = sorted_cid.shape[0]
    dev = sorted_cid.device
    NC = nx * ny
    nchunks = -(-P // chunk)
    off = torch.arange(nchunks, dtype=torch.int32, device=dev) * chunk
    n_alive = alive.sum(dtype=torch.int32)
    end = torch.maximum(torch.minimum(off + chunk, n_alive), off)
    live = end > off
    cidf = sorted_cid[torch.clamp(off, max=P - 1).long()]
    cidl = sorted_cid[torch.clamp(end - 1, min=0).long()]
    # -nx, 0, nx made on the device: a list copied to the card would wait
    # for its stream to drain (and a CUDA graph capture refuses the copy).
    d = (torch.arange(-1, 2, dtype=torch.int32, device=dev) * nx)[:, None]
    ws = torch.searchsorted(sorted_cid, torch.clamp(cidf + d - 1, 0, NC), out_int32=True)
    we = torch.searchsorted(sorted_cid, torch.clamp(cidl + d + 2, 0, NC), out_int32=True)
    we = torch.where(live, we, ws)
    return torch.cat([ws, we, end[None]]).contiguous()


def _lower_bound(key, lo, hi, target):
    """Per element, the first position in [lo, hi) of the ascending ``key``
    whose value is >= ``target`` (``hi`` if none): the kernel's binary
    search, halving every bracket at once until all are empty."""
    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        open_ = lo < hi
        mid = (lo + hi) // 2
        below = key[torch.where(open_, mid, 0).long()] < target
        lo = torch.where(open_ & below, mid + 1, lo)
        hi = torch.where(open_ & ~below, mid, hi)
    return lo


def window_ranges(sorted_cid: torch.Tensor, windows: torch.Tensor, chunk: int,
                  nx: int) -> torch.Tensor:
    """(6, P) int32: each self's exact candidate ranges as K10 finds them,
    inside its chunk's window of the sorted cell ids (here by binary
    search; the kernel first tests a few candidates at once, which finds
    the same first position).

    Rows 0-2 are the first slab position whose cid reaches cid + d - 1, rows
    3-5 the first that reaches cid + d + 2, d = -nx, 0, +nx, each searched in
    [windows[q], windows[3 + q]) only; selves at or past the chunk's row 6
    (dead) get (0, 0).  No clamp is needed: the window holds every alive
    self's range, so a target below cell 0 finds the window's start (then
    0) and one past the last cell its end (then the first dead self), as
    :func:`candidate_ranges` clamps them."""
    P = sorted_cid.shape[0]
    idx = torch.arange(P, device=sorted_cid.device)
    c = idx // chunk
    alive = idx < windows[6, c]
    out = torch.zeros((6, P), dtype=torch.int32, device=sorted_cid.device)
    for q in range(3):
        ws = torch.where(alive, windows[q, c], 0)
        we = torch.where(alive, windows[3 + q, c], 0)
        lo = sorted_cid + (q - 1) * nx - 1
        out[q] = _lower_bound(sorted_cid, ws, we, lo)
        out[3 + q] = _lower_bound(sorted_cid, out[q], we, lo + 3)
    return out


def _n_out(mode: str, fold: bool, spring: bool) -> int:
    if mode == "a":
        return 6  # w_sum, s_x, s_y, cnt, vsum_x, vsum_y
    return 2 if fold else (6 if spring else 4)


def _masked_terms(s, c, mb, coef, mode, fold, spring, symm):
    """The pair terms of selves ``s`` and candidates ``c`` (broadcastable
    (..., 8) slab rows), zero where ``mb`` is False, with the kernels'
    operations in the kernels' order (1/sqrt, no fused multiply-add)."""
    diam = coef[0]
    inv_diam = 1.0 / torch.clamp(diam, min=EPS)
    tp2 = 2.0 * coef[1]
    bal = coef[2]
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
        terms = [wgt, ci * nrx, ci * nry, torch.ones_like(wgt), c[..., A_VX], c[..., A_VY]]
    else:
        nhx = nrx * inv
        nhy = nry * inv
        align = (s[..., B_SX] - c[..., B_SX]) * nhx + (s[..., B_SY] - c[..., B_SY]) * nhy
        t_coef = align + (c[..., B_CP] + (s[..., B_CP] - tp2))
        terms = [t_coef * nhx, t_coef * nhy]
        if not fold:
            p_coef = s[..., B_CP] + c[..., B_CP]
            terms += [p_coef * nhx, p_coef * nhy]
            if spring:
                terms += [(bal - wgt) * nhx, (bal - wgt) * nhy]
    return [torch.where(mb, t, 0.0) for t in terms]


def _near_and_row(s, c, coef, mode, q):
    """The distance and row parts of the pair mask."""
    rx = s[..., A_PX] - c[..., A_PX]
    ry = s[..., A_PY] - c[..., A_PY]
    row_col = A_ROW if mode == "a" else B_ROW
    return (rx * rx + ry * ry <= coef[0] * coef[0]) & (
        c[..., row_col] == s[..., row_col] + float(q - 1)
    )


def pm_pass_plain(slab, ranges, coef, mode, *, fold=False, spring=False, symm=False):
    """Plain torch version of the K1/K2 pair pass: same inputs, same outputs.

    Pads each self's candidate range to the chunk's longest and masks, one
    range (row offset) at a time, over chunks of ``PLAIN_CHUNK`` selves.
    The pair terms are summed one candidate column at a time in ascending
    slab order, as the kernel sums them, so the two agree bit for bit."""
    P = slab.shape[0]
    n_out = _n_out(mode, fold, spring)
    out = torch.zeros((n_out, P), dtype=torch.float32, device=slab.device)
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
            mb = valid & _near_and_row(s, c, coef, mode, q) & (j != gid)
            terms = _masked_terms(s, c, mb, coef, mode, fold, spring, symm)
            for col in range(span):
                acc = [a + t[:, col] for a, t in zip(acc, terms)]
        for k in range(n_out):
            out[k, start:stop] = acc[k]
    return out


def pms_pass_plain(slab, cid, windows, coef, mode, *, nx, chunk, fold=False, spring=False):
    """Plain torch version of the K10 chunk-window pass: same inputs, same
    outputs.

    Every self of a chunk tests every candidate of the chunk's window at
    each row offset, under the pair mask plus the cell test (the candidate's
    cell is one of the self's three cells of that row offset), and adds the
    terms that pass in ascending slab order, over groups of chunks of about
    ``PLAIN_CHUNK`` selves.  One-sided collider noise."""
    P = slab.shape[0]
    dev = slab.device
    n_out = _n_out(mode, fold, spring)
    nchunks = windows.shape[1]
    out = torch.zeros((n_out, nchunks * chunk), dtype=torch.float32, device=dev)
    pad = nchunks * chunk - P
    slab_p = torch.cat([slab, slab.new_zeros((pad, SLAB_F))])
    cid_p = torch.cat([cid, cid.new_zeros((pad,))])
    per = max(1, PLAIN_CHUNK // chunk)
    for g0 in range(0, nchunks, per):
        g1 = min(g0 + per, nchunks)
        gid = torch.arange(g0 * chunk, g1 * chunk, device=dev).view(g1 - g0, chunk)
        active = gid < windows[6, g0:g1, None]  # alive selves
        s = slab_p[gid][:, :, None, :]  # (G, chunk, 1, 8)
        s_cid = cid_p[gid][:, :, None]
        acc = [0.0] * n_out
        for q in range(3):
            ws, we = windows[q, g0:g1], windows[3 + q, g0:g1]
            span = int((we - ws).max())
            if span <= 0:
                continue
            j = ws[:, None].long() + torch.arange(span, device=dev)  # (G, span)
            valid = j < we[:, None]
            j = torch.where(valid, j, 0)
            c = slab[j][:, None]  # (G, 1, span, 8)
            cell = cid[j][:, None, :] - (s_cid + (q - 1) * nx - 1)
            mb = (
                (valid[:, None, :] & active[:, :, None])
                & _near_and_row(s, c, coef, mode, q)
                & (cell >= 0) & (cell < 3)
                & (j[:, None, :] != gid[:, :, None])
            )
            terms = _masked_terms(s, c, mb, coef, mode, fold, spring, False)
            for col in range(span):
                acc = [a + t[..., col] for a, t in zip(acc, terms)]
        for k in range(n_out):
            if isinstance(acc[k], torch.Tensor):
                out[k, g0 * chunk:g1 * chunk] = acc[k].reshape(-1)
    return out[:, :P]


def _check(fn, name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} is on {t.device}, expected the CUDA device")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape}, got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _lib():
    lib = cuda_build.load("pmajor")
    if lib.sc_pm_pass.argtypes is None:  # pointers as c_void_p: ctypes would cut them to int
        lib.sc_pm_pass.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.sc_pm_pass.restype = ctypes.c_int
        lib.sc_pms_pass.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.sc_pms_pass.restype = ctypes.c_int
    return lib


def _check_mode(fn, mode):
    if mode not in ("a", "b"):
        raise ValueError(f"{fn}: mode must be 'a' or 'b', got {mode!r}")


def _launch_pm(slab, ranges, coef, mode, fold, spring, symm):
    """K1/K2 over a crate axis: one launch of csrc/pmajor.cu's pm_kernel for
    all B crates, counted in ``LAUNCHES``."""
    B, P = slab.shape[:2]
    _check("pm_pass", "slab", slab, torch.float32, (B, P, SLAB_F))
    _check("pm_pass", "ranges", ranges, torch.int32, (B, 6, P))
    _check("pm_pass", "coef", coef, torch.float32, (B, 3))
    if not (slab.device == ranges.device == coef.device):
        raise ValueError("pm_pass: slab, ranges and coef must share one device")
    n_out = _n_out(mode, fold, spring)
    out = torch.empty((B, n_out, P), dtype=torch.float32, device=slab.device)
    with torch.cuda.device(slab.device):  # launch on the tensors' card
        err = _lib().sc_pm_pass(
            slab.data_ptr(), ranges.data_ptr(), coef.data_ptr(), out.data_ptr(),
            P, B, 0 if mode == "a" else 1, n_out, int(symm),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pm_pass kernel (mode {mode}, {B} crates) failed: cudaError {err}")
    LAUNCHES[mode] += 1
    return out


_MODES = ("a", "b")


@torch.library.custom_op(
    "sand_crate::pm_pass", mutates_args=(),
    schema="(Tensor slab, Tensor ranges, Tensor coef, int mode, int fold, int spring, "
           "int symm) -> Tensor")
def _pm_op(slab, ranges, coef, mode, fold, spring, symm):
    """K1/K2 over a leading crate axis: slab (B, P, 8), ranges (B, 6, P),
    coef (B, 3) -> (B, n_out, P).  CPU tensors run :func:`pm_pass_plain`
    crate by crate; CUDA tensors launch the kernel once."""
    m, kw = _MODES[mode], dict(fold=bool(fold), spring=bool(spring), symm=bool(symm))
    if slab.device.type == "cuda":
        return _launch_pm(slab, ranges, coef, m, **kw)
    if slab.device.type == "cpu":
        return crates_plain("pm_pass", lambda s, r, c: pm_pass_plain(s, r, c, m, **kw),
                            (slab, ranges, coef))
    raise ValueError(f"pm_pass: tensors on {slab.device}; expected cpu or cuda")


register_crate_vmap(_pm_op, 3)


def pm_pass(slab, ranges, coef, mode, *, fold=False, spring=False, symm=False):
    """One K1/K2 pair pass over the sorted slab -> (n_out, P) f32 sums.

    ``mode`` "a" sums (w_sum, s_x, s_y, count, vsum_x, vsum_y); "b" sums
    the folded force (2 rows) or tension and pressure (4) plus the spring
    (6).  Through the ``sand_crate::pm_pass`` operator as a batch of one
    (under ``torch.func.vmap`` its vmap rule launches once for the whole
    batch): CPU tensors run :func:`pm_pass_plain`; CUDA tensors launch the
    kernel of ``csrc/pmajor.cu`` on the current stream (and count it in
    ``LAUNCHES``); tensors elsewhere raise."""
    return pm_pass_crates(slab[None], ranges[None], coef[None], mode, fold=fold,
                          spring=spring, symm=symm)[0]


def pm_pass_crates(slab, ranges, coef, mode, *, fold=False, spring=False, symm=False):
    """K1/K2 over a leading crate axis: slab (B, P, 8), ranges (B, 6, P) in
    crate-local slab positions, coef (B, 3) -> (B, n_out, P), through the
    ``sand_crate::pm_pass`` operator: one launch for all B crates on the
    card, :func:`pm_pass_plain` crate by crate on the CPU."""
    _check_mode("pm_pass", mode)
    on_cpu_or_cuda("pm_pass", slab)
    return torch.ops.sand_crate.pm_pass(slab, ranges, coef, _MODES.index(mode), int(fold),
                                        int(spring), int(symm))


def _launch_pms(slab, cid, windows, coef, mode, nx, chunk, fold, spring):
    """K10 over a crate axis: one launch of csrc/pmajor.cu's pms_kernel for
    all B crates, counted in ``LAUNCHES["sub_a"]`` / ``["sub_b"]``."""
    B, P = slab.shape[:2]
    nchunks = -(-P // chunk)
    _check("pms_pass", "slab", slab, torch.float32, (B, P, SLAB_F))
    _check("pms_pass", "cid", cid, torch.int32, (B, P))
    _check("pms_pass", "windows", windows, torch.int32, (B, 7, nchunks))
    _check("pms_pass", "coef", coef, torch.float32, (B, 3))
    if not (slab.device == cid.device == windows.device == coef.device):
        raise ValueError("pms_pass: slab, cid, windows and coef must share one device")
    n_out = _n_out(mode, fold, spring)
    out = torch.empty((B, n_out, P), dtype=torch.float32, device=slab.device)
    with torch.cuda.device(slab.device):
        err = _lib().sc_pms_pass(
            slab.data_ptr(), cid.data_ptr(), windows.data_ptr(), coef.data_ptr(),
            out.data_ptr(), P, B, nchunks, chunk, nx, 0 if mode == "a" else 1, n_out,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pms_pass kernel (mode {mode}, {B} crates) failed: cudaError {err}")
    LAUNCHES["sub_" + mode] += 1
    return out


@torch.library.custom_op(
    "sand_crate::pms_pass", mutates_args=(),
    schema="(Tensor slab, Tensor cid, Tensor windows, Tensor coef, int mode, int nx, int chunk, "
           "int fold, int spring) -> Tensor")
def _pms_op(slab, cid, windows, coef, mode, nx, chunk, fold, spring):
    """K10 over a leading crate axis: slab (B, P, 8), cid (B, P), windows
    (B, 7, nchunks), coef (B, 3) -> (B, n_out, P).  CPU tensors run
    :func:`pms_pass_plain` crate by crate; CUDA tensors launch the kernel
    once."""
    m, kw = _MODES[mode], dict(nx=nx, chunk=chunk, fold=bool(fold), spring=bool(spring))
    if slab.device.type == "cuda":
        return _launch_pms(slab, cid, windows, coef, m, **kw)
    if slab.device.type == "cpu":
        return crates_plain("pms_pass", lambda s, c, w, k: pms_pass_plain(s, c, w, k, m, **kw),
                            (slab, cid, windows, coef))
    raise ValueError(f"pms_pass: tensors on {slab.device}; expected cpu or cuda")


register_crate_vmap(_pms_op, 4)


def pms_pass(slab, cid, windows, coef, mode, *, nx, chunk, fold=False, spring=False):
    """One K10 chunk-window pair pass -> (n_out, P) f32 sums, one-sided
    collider noise; outputs as :func:`pm_pass`.

    ``cid`` is the sorted cell ids (P,) int32, ``windows`` the
    :func:`chunk_windows` of ``chunk`` (32 or 128) selves, ``nx`` the grid
    width.  Through the ``sand_crate::pms_pass`` operator as a batch of one
    (under ``torch.func.vmap`` its vmap rule launches once for the whole
    batch): CPU tensors run :func:`pms_pass_plain`; CUDA tensors launch the
    kernel of ``csrc/pmajor.cu`` on the current stream (and count it in
    ``LAUNCHES["sub_a"]`` / ``["sub_b"]``); tensors elsewhere raise."""
    return pms_pass_crates(slab[None], cid[None], windows[None], coef[None], mode, nx=nx,
                           chunk=chunk, fold=fold, spring=spring)[0]


def pms_pass_crates(slab, cid, windows, coef, mode, *, nx, chunk, fold=False, spring=False):
    """K10 over a leading crate axis: slab (B, P, 8), sorted cell ids
    (B, P), each crate's :func:`chunk_windows` (B, 7, nchunks) in
    crate-local slab positions, coef (B, 3) -> (B, n_out, P), through the
    ``sand_crate::pms_pass`` operator: one launch for all B crates on the
    card, :func:`pms_pass_plain` crate by crate on the CPU."""
    _check_mode("pms_pass", mode)
    if chunk not in PMS_CHUNKS:
        raise ValueError(f"pms_pass: chunk must be one of {PMS_CHUNKS}, got {chunk}")
    on_cpu_or_cuda("pms_pass", slab)
    return torch.ops.sand_crate.pms_pass(slab, cid, windows, coef, _MODES.index(mode), nx, chunk,
                                         int(fold), int(spring))


def pass_a_slab(pos, vel, alive, sorted_cid, noise_amp, tick, scene: Scene, *, symm: bool):
    """The (P, 8) pass-A slab of sorted particles.

    With ``symm`` both positions of a pair are jittered, so the
    single-particle amplitude is scaled by 1/sqrt(2) to keep the pair-delta
    jitter variance at the reference's one-sided level."""
    return _slab_a(pos, vel, alive, sorted_cid, noise_amp, tick, scene.grid_nx, scene.grid_ny,
                   symm)


def _slab_a(pos, vel, alive, sorted_cid, noise_amp, tick, nx, ny, symm):
    if symm:
        noise_amp = noise_amp * 0.7071067811865476
    pxo, pyo, npx, npy, vx, vy = feature_rows(pos, vel, alive, noise_amp, tick)
    row = torch.where(alive, sorted_cid // nx, ny).to(torch.float32)
    return torch.stack([pxo, pyo, npx, npy, vx, vy, row, torch.zeros_like(row)], dim=1)


def pass_b_slab(slab_a, out_a, cp_slab, surface_smoothing):
    """The pass-B slab: pass A's positions and row, the cell pressure, and
    the pass-A normal sums prescaled by ``surface_smoothing``."""
    sm = surface_smoothing.to(torch.float32)
    cols = [slab_a[:, :4], cp_slab[:, None], (sm * out_a[1:3]).T, slab_a[:, A_ROW:A_ROW + 1]]
    return torch.cat(cols, dim=1).contiguous()


# --------------------------------------------------------------------------
# the pair glue on the card: csrc/pm_prep.cu
# --------------------------------------------------------------------------


def pair_prep_plain(pos, vel, alive, sorted_cid, noise_amp, tick, scene: Scene, *, symm,
                    ranges=True):
    """The plain pair prep of one crate: (:func:`pass_a_slab`,
    :func:`candidate_ranges`, or None without ``ranges``)."""
    slab = pass_a_slab(pos, vel, alive, sorted_cid, noise_amp, tick, scene, symm=symm)
    nx, ny = scene.grid_nx, scene.grid_ny
    return slab, candidate_ranges(sorted_cid, alive, nx, ny) if ranges else None


def pass_b_prep_plain(slab_a, out_a, ignored_pressure, surface_smoothing,
                      pressure_amplifier=None):
    """The plain pass-B prep of one crate: (:func:`pass_b_slab`, the cell
    pressure :func:`finalize_cp`), the slab's pressure column scaled by
    ``1 + pressure_amplifier`` where one is given (the folded pass B)."""
    cp = finalize_cp(out_a[0], out_a[3], ignored_pressure)
    cp_slab = cp if pressure_amplifier is None else cp * (1.0 + pressure_amplifier)
    return pass_b_slab(slab_a, out_a, cp_slab, surface_smoothing), cp


def _prep_lib():
    lib = cuda_build.load("pm_prep")
    if lib.sc_pm_prep.argtypes is None:  # pointers as c_void_p: ctypes would cut them to int
        lib.sc_pm_prep.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.sc_pm_prep.restype = ctypes.c_int
        lib.sc_pm_slab_b.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.sc_pm_slab_b.restype = ctypes.c_int
    return lib


def _check_operands(fn, checks):
    """Dtype, shape and contiguity of each (name, tensor, dtype, shape),
    then one CUDA device for all: nothing launches before every check."""
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
                f"{shape}, got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    device = checks[0][1].device
    if device.type != "cuda" or any(t.device != device for _, t, _, _ in checks):
        raise ValueError(f"{fn}: every operand must lie on one CUDA device, got "
                         f"{sorted({str(t.device) for _, t, _, _ in checks})}")


def _launch_prep(pos, vel, alive, sorted_cid, noise_amp, tick, nx, ny, symm, ranges):
    """csrc/pm_prep.cu's pm_cell_start_kernel and pm_prep_kernel (the
    kernel alone without ``ranges``) over a crate axis, counted once in
    ``LAUNCHES["prep"]``."""
    B, P = pos.shape[:2]
    f32 = torch.float32
    _check_operands("pair_prep", [
        ("pos", pos, f32, (B, P, 2)), ("vel", vel, f32, (B, P, 2)),
        ("alive", alive, torch.bool, (B, P)), ("sorted_cid", sorted_cid, torch.int32, (B, P)),
        ("noise_amp", noise_amp, f32, (B,)), ("tick", tick, torch.int32, (B,))])
    dev = pos.device
    slab = torch.empty((B, P, SLAB_F), dtype=f32, device=dev)
    out = torch.empty((B, 6 if ranges else 0, P), dtype=torch.int32, device=dev)
    # the cell table: scratch, written and read inside the call
    start = torch.empty((B, nx * ny + 1) if ranges else (0,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # launch on the tensors' card
        err = _prep_lib().sc_pm_prep(
            pos.data_ptr(), vel.data_ptr(), alive.data_ptr(), sorted_cid.data_ptr(),
            noise_amp.data_ptr(), tick.data_ptr(), start.data_ptr(), slab.data_ptr(),
            out.data_ptr(), P, B, nx, ny, int(symm), int(ranges),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_prep kernels ({B} crates) failed: cudaError {err}")
    LAUNCHES["prep"] += 1
    return slab, out


def _launch_slab_b(slab_a, out_a, ignored_pressure, surface_smoothing, pressure_amplifier,
                   fold):
    """csrc/pm_prep.cu's pm_slab_b_kernel over a crate axis, counted in
    ``LAUNCHES["slab_b"]``."""
    B, P = slab_a.shape[:2]
    f32 = torch.float32
    _check_operands("pass_b_prep", [
        ("slab_a", slab_a, f32, (B, P, SLAB_F)), ("out_a", out_a, f32, (B, 6, P)),
        ("ignored_pressure", ignored_pressure, f32, (B,)),
        ("surface_smoothing", surface_smoothing, f32, (B,)),
        ("pressure_amplifier", pressure_amplifier, f32, (B,))])
    slab_b = torch.empty_like(slab_a)
    cp = torch.empty((B, P), dtype=f32, device=slab_a.device)
    with torch.cuda.device(slab_a.device):
        err = _prep_lib().sc_pm_slab_b(
            slab_a.data_ptr(), out_a.data_ptr(), ignored_pressure.data_ptr(),
            surface_smoothing.data_ptr(), pressure_amplifier.data_ptr(), slab_b.data_ptr(),
            cp.data_ptr(), P, B, int(fold), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pass_b_prep kernel ({B} crates) failed: cudaError {err}")
    LAUNCHES["slab_b"] += 1
    return slab_b, cp


@torch.library.custom_op(
    "sand_crate::pm_prep", mutates_args=(),
    schema="(Tensor pos, Tensor vel, Tensor alive, Tensor sorted_cid, Tensor noise_amp, "
           "Tensor tick, int nx, int ny, int symm, int ranges) -> (Tensor, Tensor)")
def _prep_op(pos, vel, alive, sorted_cid, noise_amp, tick, nx, ny, symm, ranges):
    """The pair prep over a leading crate axis: pos, vel (B, P, 2), alive,
    sorted_cid (B, P), noise_amp, tick (B,) -> slab A (B, P, 8) and the
    ranges (B, 6, P), or (B, 0, P) without ``ranges``.  CPU tensors run the
    plain chain of :func:`pair_prep_plain` crate by crate; CUDA tensors
    launch the kernels once."""
    if pos.device.type == "cuda":
        return _launch_prep(pos, vel, alive, sorted_cid, noise_amp, tick, nx, ny, symm, ranges)
    if pos.device.type == "cpu":
        def plain(p, v, a, c, m, t):
            slab = _slab_a(p, v, a, c, m, t, nx, ny, bool(symm))
            return slab, (candidate_ranges(c, a, nx, ny) if ranges
                          else c.new_zeros((0, c.shape[0])))

        return crates_plain("pm_prep", plain, (pos, vel, alive, sorted_cid, noise_amp, tick))
    raise ValueError(f"pair_prep: tensors on {pos.device}; expected cpu or cuda")


register_crate_vmap(_prep_op, 6)


@torch.library.custom_op(
    "sand_crate::pm_slab_b", mutates_args=(),
    schema="(Tensor slab_a, Tensor out_a, Tensor ignored_pressure, Tensor surface_smoothing, "
           "Tensor pressure_amplifier, int fold) -> (Tensor, Tensor)")
def _slab_b_op(slab_a, out_a, ignored_pressure, surface_smoothing, pressure_amplifier, fold):
    """The pass-B prep over a leading crate axis: slab_a (B, P, 8), out_a
    (B, 6, P), ignored_pressure, surface_smoothing, pressure_amplifier (B,)
    (read only where ``fold``) -> slab B (B, P, 8), cp (B, P).  CPU tensors
    run :func:`pass_b_prep_plain` crate by crate; CUDA tensors launch the
    kernel once."""
    if slab_a.device.type == "cuda":
        return _launch_slab_b(slab_a, out_a, ignored_pressure, surface_smoothing,
                              pressure_amplifier, fold)
    if slab_a.device.type == "cpu":
        return crates_plain(
            "pm_slab_b",
            lambda s, o, ig, sm, pa: pass_b_prep_plain(s, o, ig, sm, pa if fold else None),
            (slab_a, out_a, ignored_pressure, surface_smoothing, pressure_amplifier))
    raise ValueError(f"pass_b_prep: tensors on {slab_a.device}; expected cpu or cuda")


register_crate_vmap(_slab_b_op, 5)


def pair_prep(pos, vel, alive, sorted_cid, noise_amp, tick, scene: Scene, *, symm: bool,
              ranges: bool = True):
    """Slab A and the exact candidate ranges of one crate's sorted slots ->
    (slab (P, 8) f32, ranges (6, P) i32, or None without ``ranges``: K10
    finds its own), as :func:`pass_a_slab` and :func:`candidate_ranges`.

    Through the ``sand_crate::pm_prep`` operator as a batch of one (under
    ``torch.func.vmap`` its vmap rule launches once for the whole batch):
    CPU tensors run :func:`pair_prep_plain`; CUDA tensors launch
    csrc/pm_prep.cu's cell table and prep kernels on the current stream,
    the same bits, counted in ``LAUNCHES["prep"]``.  ``sorted_cid`` must be
    sorted, the dead slots' ids NC, as the tick's cell sort leaves them."""
    on_cpu_or_cuda("pair_prep", pos)
    slab, rng = torch.ops.sand_crate.pm_prep(pos[None], vel[None], alive[None],
                                             sorted_cid[None], noise_amp[None], tick[None],
                                             scene.grid_nx, scene.grid_ny, int(symm),
                                             int(ranges))
    return slab[0], rng[0] if ranges else None


def pass_b_prep(slab_a, out_a, ignored_pressure, surface_smoothing, pressure_amplifier=None):
    """Slab B and the cell pressure of one crate -> (slab (P, 8) f32, cp
    (P,) f32), as :func:`pass_b_prep_plain`: the slab's pressure column
    times ``1 + pressure_amplifier`` where one is given (the folded pass
    B).  Through the ``sand_crate::pm_slab_b`` operator as a batch of one:
    CPU tensors run the plain version; CUDA tensors launch csrc/pm_prep.cu's
    pm_slab_b_kernel (once for a vmapped batch too, counted in
    ``LAUNCHES["slab_b"]``)."""
    on_cpu_or_cuda("pass_b_prep", slab_a)
    fold = pressure_amplifier is not None
    slab_b, cp = torch.ops.sand_crate.pm_slab_b(
        slab_a[None], out_a[None], ignored_pressure[None], surface_smoothing[None],
        (pressure_amplifier if fold else ignored_pressure)[None], int(fold))
    return slab_b[0], cp[0]


def schedule() -> str:
    """The pair schedule the environment selects, read at call time as the
    JAX package reads it at trace time: "pmsub" (K10), "gate" (K1/K2
    one-sided) or "default" (K1/K2, two-sided where the scene says so)."""
    if os.environ.get("SAND_CRATE_PMSUB") == "1":
        return "pmsub"
    if os.environ.get("SAND_CRATE_PMAJOR_GATE") == "1":
        return "gate"
    return "default"


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
    (tests) always get the split sums.  :func:`schedule` picks the kernels
    (K10 under ``SAND_CRATE_PMSUB=1``) and, off the default, one-sided
    noise."""
    fold = (
        scene.fold_pairs
        and pressure_amplifier is not None
        and not scene.enable_spring
    )
    sched = schedule()
    symm = scene.pmajor_symm and sched == "default"
    P = pos.shape[0]
    dtype = pos.dtype
    nx, ny = scene.grid_nx, scene.grid_ny

    slab_a, ranges = pair_prep(pos, vel, alive, sorted_cid, noise_amp, tick, scene, symm=symm,
                               ranges=sched != "pmsub")
    coef = coef_stack(diameter, target_pressure, spring_overlap_balance)
    if sched == "pmsub":
        windows = chunk_windows(sorted_cid, alive, nx, ny, PMS_CHUNK)

        def pair_pass(slab, mode, **kw):
            return pms_pass(slab, sorted_cid, windows, coef, mode, nx=nx, chunk=PMS_CHUNK, **kw)
    else:
        def pair_pass(slab, mode, **kw):
            return pm_pass(slab, ranges, coef, mode, symm=symm, **kw)

    out_a = pair_pass(slab_a, "a")
    slab_b, cp = pass_b_prep(slab_a, out_a, ignored_pressure, surface_smoothing,
                             pressure_amplifier if fold else None)
    out_b = pair_pass(slab_b, "b", fold=fold, spring=scene.enable_spring)

    # Dead selves have empty candidate ranges (or sit past their chunk's
    # last alive self), so every dead row is zero.
    zeros2 = pos.new_zeros((), dtype=dtype).expand(P, 2)  # one element, read for every slot
    return PairSums(
        p_i=cp.to(dtype),
        dv_tension=out_b[0:2].T.to(dtype),
        pressure_real=zeros2 if fold else out_b[2:4].T.to(dtype),
        spring_real=out_b[4:6].T.to(dtype) if scene.enable_spring else zeros2,
        visc_vsum=out_a[4:6].T.to(dtype),
        nbr_cnt=out_a[3].to(dtype),
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
