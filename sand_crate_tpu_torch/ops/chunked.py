"""Chunked fixed-halo pair backend, vmappable.

The PyTorch counterpart of ``sand_crate_tpu/ops/chunked.py`` (XLA code
there, no Pallas kernel), the mid-size backend of batched crates
(``sweep.py``), where the dense (P, P) planes grow too large:

    self chunk:   ``Scene.chunk_cs`` consecutive cell-sorted particles
    candidates:   one fixed window of the sorted slab,
                  [chunk_start - H, chunk_start + cs + H), H = ``Scene.chunk_halo``
    pair plane:   (cs, cs + 2H) elementwise math, one chunk at a time

Each pass sweeps the sorted feature slab through ``ops/pair_batch.window_pass``:
on the card one launch of the window kernel (D2, ``csrc/pair_batch.cu``)
for every crate of a vmapped batch; on the CPU :func:`_pass_scan_plain`,
its plain twin, a Python loop over a host count of chunks, so that under
``torch.func.vmap`` every window is a slice at the same offset for every
crate: no per-crate gather and no host read.  The hashed noise, the
feature slabs and the loss count stay torch glue (P-sized).

Pair rule: |grid-row delta| <= 1, distance within one diameter, both alive,
different slab index.  No cell-capacity cap.  The one approximation is the
fixed halo: a partner further than H slab positions away is lost, which
happens only when one grid row holds more than about H particles.  That
loss is counted exactly (the searchsorted row ranges against the fixed
window) into ``PairSums.overflow``.

Collider noise is the p-major backend's: jitter hashed from the sorted
index and the tick (``ops.pmajor._u01``), the JAX function's bits.
"""

from __future__ import annotations

import torch

from ..cellwise import PairSums, cell_ids_grid
from ..state import Scene
from . import pair_batch
from .pmajor import EPS, _u01


def live_chunks(live_rows: int | None, p_pad: int, cs: int) -> int:
    """Chunks of ``cs`` selves a sweep bounded by ``live_rows`` visits.

    Clamped to the slab's ``p_pad // cs`` chunks: a bound past the slab
    sweeps it whole (the JAX loop, ops/chunked.py:250, runs on past the
    last chunk and writes its last chunk again)."""
    nchunks = p_pad // cs
    if live_rows is None:
        return nchunks
    return min(-(-max(int(live_rows), 0) // cs), nchunks)


def _pass_scan_plain(feat, halo, n_out, mode, diam, smoothing, target_p, balance,
                     enable_spring, n_chunks, cs):
    """The window kernel's plain twin.  Sweep the first ``n_chunks``
    cs-wide self chunks of the (p_pad, F) sorted feature slab, each against
    its one fixed (cs + 2 halo) window; later chunks hold no alive self
    (dead rows sort last) and get exact zeros, as every output is gated on
    the both-alive pair mask.  Returns (p_pad, n_out)."""
    p_pad, F = feat.shape
    wt = cs + 2 * halo
    featp = torch.nn.functional.pad(feat, (0, 0, halo, halo))
    inv_diam = 1.0 / torch.clamp(diam, min=EPS)
    out = []
    for c in range(n_chunks):
        win = featp[c * cs: c * cs + wt]
        sf = featp[c * cs + halo: c * cs + halo + cs]
        s_px, s_py = sf[:, 0:1], sf[:, 1:2]
        s_rw, s_af = sf[:, 4:5], sf[:, 5:6]
        c_px, c_py = win[None, :, 0], win[None, :, 1]
        c_npx, c_npy = win[None, :, 2], win[None, :, 3]
        c_rw, c_af = win[None, :, 4], win[None, :, 5]
        s_gid = c * cs + torch.arange(cs, device=feat.device)[:, None]
        c_gid = c * cs - halo + torch.arange(wt, device=feat.device)[None, :]

        rx = s_px - c_px
        ry = s_py - c_py
        d2 = rx * rx + ry * ry
        dr = c_rw - s_rw
        mb = ((d2 <= diam * diam) & (s_af > 0) & (c_af > 0) & (dr >= -1.0) & (dr <= 1.0)
              & (s_gid != c_gid))
        nrx = s_px - c_npx
        nry = s_py - c_npy
        nd2 = torch.clamp(nrx * nrx + nry * nry, min=EPS * EPS)
        inv = torch.rsqrt(nd2)
        nhx = nrx * inv
        nhy = nry * inv
        dist = nd2 * inv
        wgt = torch.where(mb, 1.0 - torch.clamp(dist * inv_diam, 0.0, 1.0), 0.0)

        if mode == "a":
            coeff = (1.0 - wgt) * wgt
            outs = [wgt, coeff * nhx, coeff * nhy, mb.to(feat.dtype)]
        else:
            c_vx, c_vy = win[None, :, 6], win[None, :, 7]
            c_cp = win[None, :, 8]
            c_sx, c_sy = win[None, :, 9], win[None, :, 10]
            s_cp = sf[:, 8:9]
            s_sx, s_sy = sf[:, 9:10], sf[:, 10:11]
            align = ((s_sx - c_sx) * nhx + (s_sy - c_sy) * nhy) * smoothing
            t_coef = torch.where(mb, align + (c_cp + s_cp - 2.0 * target_p), 0.0)
            p_coef = torch.where(mb, s_cp + c_cp, 0.0)
            outs = [t_coef * nhx, t_coef * nhy, p_coef * nhx, p_coef * nhy]
            if enable_spring:
                sp = torch.where(mb, balance - wgt, 0.0)
                outs += [sp * nhx, sp * nhy]
            # The JAX loop multiplies by mb.astype(f32); XLA compiles that
            # product as a select, so a NaN velocity outside the mask (a
            # dead slot) stays out of the sum: a where keeps its result.
            outs += [torch.where(mb, c_vx, 0.0), torch.where(mb, c_vy, 0.0)]
        out.append(torch.stack([o.sum(dim=1) for o in outs], dim=-1))
    assert not out or out[0].shape[-1] == n_out
    rest = p_pad - n_chunks * cs
    if rest:
        out.append(feat.new_zeros((rest, n_out)))
    return torch.cat(out)


def _lost_pairs(sorted_cid, n_alive, nx, ny, halo, nchunks, cs):
    """Exact count of candidate slots outside the fixed windows: chunk c's
    candidates for row offset d lie in [searchsorted(cid_first + d nx - 1),
    searchsorted(cid_last + d nx + 2)); whatever lies before c cs - halo or
    at or after c cs + cs + halo is out of reach."""
    P = sorted_cid.shape[0]
    dev = sorted_cid.device
    off = torch.arange(nchunks, dtype=torch.int32, device=dev) * cs
    first = torch.clamp(off, max=P - 1).long()
    lastp = torch.clamp(torch.minimum(off + cs - 1, n_alive - 1), 0, P - 1).long()
    cidf = sorted_cid[first]
    cidl = sorted_cid[lastp]
    NC = nx * ny
    d = torch.arange(3, dtype=torch.int32, device=dev)[None, :] - 1
    lo = torch.clamp(cidf[:, None] + d * nx - 1, 0, NC)
    hi = torch.clamp(cidl[:, None] + d * nx + 2, 0, NC)
    ws = torch.searchsorted(sorted_cid, lo.reshape(-1).to(sorted_cid.dtype), out_int32=True)
    we = torch.searchsorted(sorted_cid, hi.reshape(-1).to(sorted_cid.dtype), out_int32=True)
    lo_fix = torch.repeat_interleave(off - halo, 3)
    hi_fix = torch.repeat_interleave(off + cs + halo, 3)
    live = torch.repeat_interleave(off < n_alive, 3)
    lost = torch.where(
        live, torch.clamp(lo_fix - ws, min=0) + torch.clamp(we - hi_fix, min=0), 0
    )
    return lost.sum(dtype=torch.int32)


def neighbor_forces_chunked_sorted(
    pos: torch.Tensor,  # every per-particle input already sorted by cell id
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
    live_rows: int | None = None,
) -> PairSums:
    """Fixed-halo pair sums over pre-sorted operands, in the same order.

    ``live_rows`` (a host int, the same for every crate of a vmapped batch)
    bounds the sweep to the first ``ceil(live_rows / cs)`` chunks, at most
    all of them (:func:`live_chunks`).  It must bound this crate's alive
    count from above; alive rows past the swept chunks are skipped and
    counted into ``PairSums.overflow``, never lost silently.  ``None``
    sweeps every chunk."""
    nx, ny = scene.grid_nx, scene.grid_ny
    halo, cs = scene.chunk_halo, scene.chunk_cs
    P = pos.shape[0]
    dtype = pos.dtype
    f32 = torch.float32
    dev = pos.device

    p_pad = -(-P // cs) * cs
    n_chunks = live_chunks(live_rows, p_pad, cs)
    af = alive.to(f32)
    iota = torch.arange(P, dtype=torch.int32, device=dev)
    amp = noise_amp.to(f32)
    px = pos[:, 0].to(f32)
    py = pos[:, 1].to(f32)
    npx = px + (_u01(iota * 2, tick) - 0.5) * amp
    npy = py + (_u01(iota * 2 + 1, tick) - 0.5) * amp
    rowf = torch.div(sorted_cid, nx, rounding_mode="floor").to(f32)  # dead: row ny, masked

    def col(x):
        return torch.nn.functional.pad(x, (0, p_pad - P))

    diam = diameter.to(f32)
    sm = surface_smoothing.to(f32)
    tp = target_pressure.to(f32)
    bal = spring_overlap_balance.to(f32)
    n_alive = torch.searchsorted(
        sorted_cid, torch.full_like(sorted_cid[:1], nx * ny), out_int32=True
    )[0]

    feat_a = torch.stack([col(px), col(py), col(npx), col(npy), col(rowf), col(af)], dim=-1)
    out_a = pair_batch.window_pass(feat_a, halo, 4, "a", diam, sm, tp, bal, False, n_chunks, cs)
    w_sum, sx, sy, cnt = (out_a[:P, k] for k in range(4))
    cp = torch.where(cnt > 0, torch.clamp(w_sum - ignored_pressure, min=0.0), 0.0)

    n_out_b = 8 if scene.enable_spring else 6
    feat_b = torch.stack(
        [col(px), col(py), col(npx), col(npy), col(rowf), col(af),
         col(vel[:, 0].to(f32)), col(vel[:, 1].to(f32)), col(cp), col(sx), col(sy)],
        dim=-1,
    )
    out_b = pair_batch.window_pass(feat_b, halo, n_out_b, "b", diam, sm, tp, bal,
                                   scene.enable_spring, n_chunks, cs)

    lost = _lost_pairs(sorted_cid, n_alive, nx, ny, halo, p_pad // cs, cs)
    if live_rows is not None:
        # Alive rows past the swept chunks had no pair sums: count them.
        lost = lost + torch.clamp(n_alive - n_chunks * cs, min=0)

    if scene.enable_spring:
        spring_real = out_b[:P, 4:6].to(dtype)
        v0 = 6
    else:
        spring_real = torch.zeros((P, 2), dtype=dtype, device=dev)
        v0 = 4
    return PairSums(
        p_i=cp.to(dtype),
        dv_tension=out_b[:P, 0:2].to(dtype),
        pressure_real=out_b[:P, 2:4].to(dtype),
        spring_real=spring_real,
        visc_vsum=out_b[:P, v0: v0 + 2].to(dtype),
        nbr_cnt=cnt.to(dtype),
        overflow=lost.to(torch.int32),
    )


def neighbor_forces_chunked(
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
    live_rows: int | None = None,
) -> PairSums:
    """Particle-order wrapper: sort by cell id, run, undo the permutation."""
    cid = cell_ids_grid(pos, alive, scene)
    sorted_cid, order = torch.sort(cid, stable=True)
    sums = neighbor_forces_chunked_sorted(
        pos[order], vel[order], alive[order], sorted_cid, noise_amp, tick, diameter,
        surface_smoothing, target_pressure, ignored_pressure, spring_overlap_balance,
        scene, live_rows=live_rows,
    )
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return PairSums(*(x[inv] for x in sums[:-1]), overflow=sums.overflow)
