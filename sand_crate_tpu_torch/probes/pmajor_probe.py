"""P1: dense 128-self x W-candidate pair tiles on the p-major slab.

The port of ``tools/pmajor_probe.py``, which priced a grid-free pair
backend: pair tiles of 128 sorted selves x W contiguous slab candidates for
each of the 3 neighbour rows, no grid, no placement.  Timing-faithful and
correctness-loose, as the tool: block ownership is a fixed 8192-column
range, a chunk's windows come from its first self's row and column only,
and dead columns carry junk.  The port reproduces that index arithmetic and
the tool's hashed candidate jitter (``_hash2``: arithmetic shifts, wrapping
multiplies, the seed summed in f32 before the int32 cast).  The kernel is
``csrc/probes.cu`` ``pmajor_probe_kernel`` (a CTA of 64 threads per chunk,
two selves each; the three windows staged through shared memory TILE
columns at a time, one 16-byte load a candidate).  Mode "a" sums 4 rows
(pass-A shape), mode "b" 8 (pass-B shape, stand-in operands).

    python -m sand_crate_tpu_torch.probes.pmajor_probe [n_particles] [settle] [W] [mode]

builds bench.py's dam break at ``n_particles``, settles it, prints the
window widths the chunks need and times modes a and b at W + 128 and
W + 256 (CUDA events).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.measure import cuda_ms
from ..ops.pair_kernel import check_cuda
from . import dispatch, load_lib, require_card, run_kernel

CPB = 64  # chunks per block
CHUNK = 128  # selves per chunk
OWN = CPB * CHUNK  # own columns per block
VCAP = 16384  # window columns per block
TILE = 256  # columns of each window the kernel stages at once (kP1Tile)
_I32 = 1 << 32


def _wrap(h: torch.Tensor) -> torch.Tensor:
    """int64 values to the int32 range, two's complement (a wrapping int32
    multiply, done in int64)."""
    return (h + (1 << 31)) % _I32 - (1 << 31)


def hash2(h: torch.Tensor) -> torch.Tensor:
    """The tool's _hash2 on int32 values (held in int64): wrapping
    multiplies, arithmetic right shifts."""
    h = _wrap(h * 0x27D4EB2D)
    h = h ^ (h >> 15)
    h = _wrap(h * 0x165667B1)
    return h ^ (h >> 13)


def settled_crate(n: int, settle: int, device, **options):
    """bench.py's dam break at ``n`` target particles on ``device``, after
    ``settle`` ticks (``options`` go to the Crate)."""
    from ..bench import dam_break_world
    from ..engine import Crate

    crate = Crate(dam_break_world(n), device=device, **options)
    crate.run(settle)
    return crate


def sorted_slab(state, params, scene):
    """The tool's slab: ghost-fixed positions sorted by cell (ties by slot),
    through ``slab_from_sorted``: (slab (8, P_pad), sorted cell ids)."""
    from ..cellwise import cell_ids_grid
    from ..ops.placement import slab_from_sorted
    from ..physics import ghost_phase

    ghost = ghost_phase(state, params, scene)
    cid = cell_ids_grid(ghost.pos, state.alive, scene)
    sorted_cid, order = torch.sort(cid, stable=True)
    slab, _, _, _ = slab_from_sorted(ghost.pos[order], state.alive[order], state.vel[order],
                                     sorted_cid, scene.cell_capacity, scene.grid_nx,
                                     scene.grid_ny)
    return slab, sorted_cid


def prepare(slab: torch.Tensor, sorted_cid: torch.Tensor, nx: int, ny: int):
    """The tool's input preparation: (slab_p (8, p_fit + VCAP), dma_lo
    (nblocks,) i32, ws (nblocks * CPB * 3,) i32, need (nblocks * CPB * 3,)
    the window width each chunk's row would need)."""
    dev = slab.device
    p_pad = slab.shape[1]
    nblocks = (p_pad + OWN - 1) // OWN
    p_fit = nblocks * OWN
    off = torch.arange(nblocks * CPB, device=dev) * 128
    first = off.clamp(max=p_pad - 1)
    last = (off + 127).clamp(max=p_pad - 1)
    cx0, rw0, cx1 = slab[4][first].long(), slab[6][first].long(), slab[4][last].long()
    q = torch.arange(3, device=dev)[None, :] - 1
    rows = (rw0[:, None] + q).clamp(0, ny - 1) * nx
    key = sorted_cid.contiguous()
    ws = torch.searchsorted(key, (rows + (cx0[:, None] - 2).clamp(0, nx - 1)).reshape(-1)
                            .to(key.dtype), out_int32=True)
    we = torch.searchsorted(key, (rows + (cx1[:, None] + 3).clamp(0, nx - 1)).reshape(-1)
                            .to(key.dtype), out_int32=True)
    dma_lo = torch.div(ws.reshape(-1, 3)[::CPB, 0], 128, rounding_mode="floor") * 128
    dma_lo = torch.minimum(dma_lo, torch.arange(nblocks, device=dev, dtype=torch.int32) * OWN)
    dma_lo = dma_lo.clamp(0, p_pad).to(torch.int32)
    slab_p = torch.nn.functional.pad(slab, (0, VCAP + p_fit - p_pad))
    return slab_p.contiguous(), dma_lo.contiguous(), ws.contiguous(), we - ws


def coefficients(diameter, device) -> torch.Tensor:
    """The tool's (2,) f32 coef: diameter, 0."""
    d = torch.as_tensor(diameter, device=device).to(torch.float32).reshape(())
    return torch.stack([d, torch.zeros((), dtype=torch.float32, device=device)])


def shared_bytes(mode: str) -> int:
    """Dynamic shared memory of one CTA of the kernel (p1_smem_bytes): TILE
    columns of the three windows, 16 bytes a candidate in mode a, 36 in b."""
    return 3 * TILE * (16 if mode == "a" else 36)


def _windows(dma_lo: torch.Tensor, ws: torch.Tensor, w: int):
    """Per chunk: the self window columns (nchunks, 128) and the three
    candidate window starts (nchunks, 3), as the kernel computes them."""
    nchunks = ws.shape[0] // 3
    dev = ws.device
    chunk = torch.arange(nchunks, device=dev)
    b, j = chunk // CPB, chunk % CPB
    base = dma_lo.long()[b]
    own0 = b * OWN - base
    orel = torch.div((own0 + j * 128).clamp(0, VCAP - 128), 128, rounding_mode="floor") * 128
    selves = (base + orel)[:, None] + torch.arange(128, device=dev)[None, :]
    wrel = (ws.long().reshape(nchunks, 3) - base[:, None]).clamp(0, VCAP - w)
    starts = base[:, None] + torch.div(wrel, 128, rounding_mode="floor") * 128
    return selves, starts


def jitter(cand: torch.Tensor, coef: torch.Tensor):
    """The probe's jittered positions (npx, npy) of slab columns ``cand``
    (8, ...): each position plus the low 16 bits of ``hash2`` of its
    column's (rw * 131072 + rk * 8192 + cx), summed in f32 and truncated to
    int32, scaled to a tenth of the diameter."""
    jscale = (coef[1] * 0.0 + coef[0] * 0.1) / 65535.0
    hseed = (cand[6] * 131072.0 + cand[5] * 8192.0 + cand[4]).to(torch.int32).long()
    h1 = hash2(hseed + coef[1].to(torch.int32).long())
    h2 = hash2(hseed ^ 0x5BD1E995)
    return (cand[0] + (h1 & 0xFFFF).to(torch.float32) * jscale,
            cand[1] + (h2 & 0xFFFF).to(torch.float32) * jscale)


def probe_plain(slab_p, dma_lo, ws, coef, w: int, mode: str) -> torch.Tensor:
    """Plain torch version of the kernel -> (nchunks, 8, 128) f32: the
    three windows' terms added per candidate column, the columns summed in
    order."""
    if mode not in ("a", "b"):
        raise ValueError(f"mode must be 'a' or 'b', got {mode!r}")
    f32 = torch.float32
    selves, starts = _windows(dma_lo, ws, w)
    s = slab_p[:, selves]  # (8, nchunks, 128)
    s_px, s_py, s_ax, s_ay, s_cp = s[0], s[1], s[4], s[5], s[6]
    diam = coef[0]
    inv_diam = 1.0 / diam
    diam2 = diam * diam
    n_out = 4 if mode == "a" else 8
    acc = [torch.zeros_like(s_px) for _ in range(n_out)]
    zero = torch.zeros((), dtype=f32, device=slab_p.device)
    for col in range(w):
        cand = slab_p[:, starts + col][..., None]  # (8, nchunks, 3, 1)
        npx, npy = jitter(cand, coef)
        v = [zero] * n_out
        for q in range(3):
            c_px, c_py = cand[0][:, q], cand[1][:, q]
            rx = s_px - c_px
            ry = s_py - c_py
            mb = rx * rx + ry * ry <= diam2
            nrx = s_px - npx[:, q]
            nry = s_py - npy[:, q]
            nd2 = torch.clamp(nrx * nrx + nry * nry, min=1e-12)
            inv = 1.0 / torch.sqrt(nd2)
            nhx = nrx * inv
            nhy = nry * inv
            dist = nd2 * inv
            wgt = torch.where(mb, 1.0 - torch.clamp(dist * inv_diam, 0.0, 1.0), zero)
            mm = mb.to(f32)
            if mode == "a":
                coeff = (1.0 - wgt) * wgt
                terms = (wgt, coeff * nhx, coeff * nhy, mm)
            else:
                c_cp = cand[7][:, q]
                align = ((s_ax - (cand[4][:, q] + 0.5)) * nhx
                         + (s_ay - (cand[5][:, q] + 0.5)) * nhy) * 0.3
                t_coef = torch.where(mb, align + ((c_cp + s_cp) - 1.4), zero)
                p_coef = torch.where(mb, s_cp + c_cp, zero)
                terms = (t_coef * nhx, t_coef * nhy, p_coef * nhx, p_coef * nhy,
                         mm * cand[2][:, q], mm * cand[3][:, q], mm, wgt)
            v = [a + t for a, t in zip(v, terms)]
        acc = [a + t for a, t in zip(acc, v)]
    rows = [acc[k if k < n_out else 0] for k in range(8)]
    return torch.stack(rows, dim=1)


def probe(slab_p, dma_lo, ws, coef, w: int, mode: str) -> torch.Tensor:
    """The probe kernel -> (nchunks, 8, 128) f32: CPU tensors run
    :func:`probe_plain`, CUDA tensors launch the kernel of
    ``csrc/probes.cu`` (counted in ``probes.LAUNCHES``)."""
    if mode not in ("a", "b"):
        raise ValueError(f"mode must be 'a' or 'b', got {mode!r}")
    if not 0 < w <= VCAP:
        raise ValueError(f"pmajor_probe: W {w} not in (0, {VCAP}]")
    if dispatch("pmajor_probe.probe", slab_p, dma_lo, ws, coef):
        return probe_plain(slab_p, dma_lo, ws, coef, w, mode)
    nblocks = dma_lo.shape[0]
    width = nblocks * OWN + VCAP
    who = "pmajor_probe.probe"
    check_cuda(f"{who}: slab_p", slab_p, torch.float32, (8, width))
    check_cuda(f"{who}: dma_lo", dma_lo, torch.int32, (nblocks,))
    check_cuda(f"{who}: ws", ws, torch.int32, (nblocks * CPB * 3,))
    check_cuda(f"{who}: coef", coef, torch.float32, (2,))
    out = torch.empty((nblocks * CPB, 8, 128), dtype=torch.float32, device=slab_p.device)
    run_kernel(f"pmajor_probe_{mode}", load_lib().sc_probe_pmajor, slab_p.data_ptr(),
               dma_lo.data_ptr(), ws.data_ptr(), coef.data_ptr(), out.data_ptr(),
               nblocks * CPB, width, w, 0 if mode == "a" else 1, device=slab_p.device)
    return out


# Operations per (self, candidate) pair, counted from the kernel: geometry
# with jitter, weight and mask 20; mode a's terms and sums 8, mode b's 24.
PAIR_OPS = {"a": 28, "b": 44}


def operations(mode: str, nchunks: int, w: int) -> int:
    """f32 operations of one call: every self against 3 x W candidates."""
    return nchunks * 128 * 3 * w * PAIR_OPS[mode]


def io_bytes(nblocks: int, w: int) -> int:
    """The slab read once, dma_lo and ws, the output written once."""
    nchunks = nblocks * CPB
    return 4 * (8 * (nblocks * OWN + VCAP) + nblocks + 3 * nchunks + nchunks * 8 * 128)


def main(n: int = 1_000_000, settle: int = 100, w: int = 256, mode: str = "all",
         crate=None) -> dict:
    """Time modes a/b at W + 128 and W + 256 on the settled world (or on
    ``crate``, already settled, in place of ``n`` and ``settle``); returns
    {(mode, W): ms}."""
    device = require_card("pmajor_probe", crate)
    if crate is None:
        crate = settled_crate(n, settle, device)
    params, scene = crate.params, crate.scene
    slab, sorted_cid = sorted_slab(crate.state, params, scene)
    slab_p, dma_lo, ws, need = prepare(slab, sorted_cid, scene.grid_nx, scene.grid_ny)
    nd = need.cpu().numpy()
    print(f"window width needed: p50={np.percentile(nd, 50):.0f} "
          f"p95={np.percentile(nd, 95):.0f} p99={np.percentile(nd, 99):.0f} "
          f"max={nd.max()} (W covers {100 * (nd <= w).mean():.2f}%)")
    p_pad = slab.shape[1]
    print(f"P_pad={p_pad} blocks={dma_lo.shape[0]} chunks={dma_lo.shape[0] * CPB}")
    coef = coefficients(params.diameter, device)
    times = {}
    for m_ in (["a", "b"] if mode == "all" else [mode]):
        for ww in (w + 128, w + 256):
            out = probe(slab_p, dma_lo, ws, coef, ww, m_)
            ms = cuda_ms(lambda: probe(slab_p, dma_lo, ws, coef, ww, m_), 10)
            times[m_, ww] = ms
            print(f"pmajor[{m_} W={ww}]  {ms:7.2f} ms   (probe out {float(out[40, 6, 64]):.1f})",
                  flush=True)
    return times


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]) if len(a) > 0 else 1_000_000,
         int(a[1]) if len(a) > 1 else 100,
         int(a[2]) if len(a) > 2 else 256,
         a[3] if len(a) > 3 else "all")
