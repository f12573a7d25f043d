"""Pair sums of batched crates: the dense all-pairs passes (D1) and the
chunked window passes (D2) as hand-written CUDA kernels, one launch a pass
for every crate of a vmapped batch.

Neither replaces a ``pl.pallas_call``: D1 is the counterpart of the XLA
fusion of ``sand_crate_tpu/cellwise.py:334-392`` (``neighbor_forces_dense``),
D2 of the XLA loop of ``sand_crate_tpu/ops/chunked.py:50`` (``_pass_scan``).

* D1: a prologue, ``dense_order_kernel`` of ``csrc/pair_batch.cu``, sorts
  each crate's slots by a cell key and writes the sorted fields and a
  record per tile of ``TILE`` sorted slots (:func:`dense_order`); then
  ``dense_pass_kernel<MODE, SPRING>``'s pass A (counts, weight sums,
  surface normals and, in its epilogue, ``p_i``) and pass B (tension,
  pressure, the spring where the scene enables it, the neighbour
  velocities), both from that one order, their sums in slot order.  The
  plain twin is ``cellwise.neighbor_forces_dense`` (each pass alone:
  ``cellwise.dense_pass_a`` / ``dense_pass_b``); the prologue's is
  :func:`dense_order_plain`.
* D2, ``window_pass_kernel<MODE, SPRING>``: one pass over the first
  ``n_chunks`` cs-wide self chunks of a (p_pad, F) cell-sorted feature slab,
  each against its fixed window ``[c cs - H, c cs + cs + H)``; rows past
  ``n_chunks * cs`` get exact zeros.  Its plain twin is
  ``ops/chunked.py::_pass_scan_plain``.

Both kernels test each pair before they compute its terms, and skip a
whole candidate tile whose box lies more than one diameter from a warp's
selves (D2: or more than one grid row), where every slot of both is
bounded: :func:`dense_visits` and :func:`window_visits` are the rule's torch
mirror, with the kernel's tile sizes (``TILE``, :func:`self_tile`), for the
tests and for counting the pairs a run tests.

:func:`neighbor_forces_dense` (``physics.neighbor_stage``) and
:func:`window_pass` (``ops/chunked.py``) call the custom operators
``torch.ops.sand_crate.dense_pairs`` and ``.window_pairs`` on one crate as
a batch of one; the operators take a leading crate axis and dispatch on
the tensors' device: CPU tensors run the plain twins crate by crate, CUDA
tensors launch the kernels on the current stream, tensors anywhere else
raise.  A build or launch failure raises; nothing falls back to the plain
version.  ``torch.func.vmap`` (batched crates, ``sweep.batched_step``)
reaches each operator's vmap rule, which folds the vmapped dim into the
crate axis, so each pass launches once for all crates.  ``LAUNCHES``
counts each launch where it happens (a captured graph's replays count
through ``graphs.COUNTERS``).

The kernels keep the pair set exactly (the neighbour counts equal the
plain version's bit for bit) and the plain version's NaN places; their
float sums are taken in an order of their own, fixed by the crate (never by
the batch), so a vmapped batch equals each crate alone bit for bit on the
card and the float fields agree with the plain twin to f32 rounding of a
reordered sum (see the source's note).
"""

from __future__ import annotations

import ctypes
import math
import types
from typing import NamedTuple

import torch

from .. import cellwise
from ..cellwise import EPS, PairSums
from . import cuda_build
from .crate_axis import crates_plain, on_cpu_or_cuda, register_crate_vmap

# Kernel launches since the last reset, counted where each kernel launches.
LAUNCHES = {"dense_order": 0, "dense_a": 0, "dense_b": 0, "window_a": 0, "window_b": 0}

# The operators' per-crate coefficient operands, (B,) each.
DENSE_COEFS = ("diameter", "surface_smoothing", "target_pressure", "ignored_pressure",
               "spring_overlap_balance")
WINDOW_COEFS = ("diameter", "surface_smoothing", "target_pressure", "spring_overlap_balance")
# Feature columns a window pass reads, and the sums it writes.
WINDOW_FEATURES = {"a": 6, "b": 11}

# f32 operations of the pair sums, each compare, clamp side, sqrt, rsqrt and
# division counted as one.  The work any implementation must do is the
# terms of the pairs that count (within one diameter): the noisy offset, its
# length, the clamps, the direction and the weight (14), then the pass's
# terms and sums: COUNTED_PAIR_OPS, what chip_smoke's bounds charge at the
# published 67 TFLOP/s beside the bytes (each input read once, each output
# written once).  A kernel that rules out whole tiles of candidates tests
# fewer pairs than all, so the test of every candidate pair (rx, ry, d2 =
# rx rx + ry ry, d2 <= diam^2: PAIR_TEST_OPS; D2 first the row delta of each
# alive window pair, its difference and two compares: ROW_TEST_OPS) is no
# least time; chip_smoke prints that all-pairs figure beside the bound
# under its own name.
PAIR_TEST_OPS = 6
ROW_TEST_OPS = 3
COUNTED_PAIR_OPS = {"a": 14 + 8, "b": 14 + 20, "b_spring": 14 + 25}

# The kernels' tiles: TILE candidates (a warp's lanes), self_tile() selves a
# warp.  A tile's record (csrc/pair_batch.cu's Tile, 8 x 32 bits): its
# alive bounded slots' box and (D2) grid rows, its alive bits and flags.
TILE = 32
TILE_FIELDS = ("x0", "x1", "y0", "y1", "r0", "r1", "alive", "flags")
POS_OK, VEL_OK = 1, 2  # every slot's position and noisy position bounded; and velocity
BIG = 2.0 ** 100  # a bounded value: |v| <= BIG
# D1's prologue: crates of at most SORT_MAX slots are sorted by the cell key
# (row-major cells of one diameter, CELL_MAX + 1 an axis; KEY_DEAD for a dead
# or NaN slot); larger ones keep slot order.
SORT_MAX = 4096
CELL_MAX = 1022
KEY_DEAD = 0xFFFFF


def self_tile(rows: int) -> int:
    """Selves a warp: 32, or 16 past 2048 rows (two lanes a self)."""
    return 16 if rows > 2048 else 32


def window_outputs(mode: str, spring: bool) -> int:
    """The sums a window pass writes per row: 4 (pass A), 6 or 8 (pass B
    without and with the spring)."""
    return 4 if mode == "a" else (8 if spring else 6)


# --------------------------------------------------------------------------
# the plain versions, one crate each
# --------------------------------------------------------------------------


def dense_pairs_plain(pos, vel, alive, noise, diameter, surface_smoothing, target_pressure,
                      ignored_pressure, spring_overlap_balance, spring: bool) -> tuple:
    """One crate's dense pair sums -> (p_i, dv_tension, pressure_real,
    spring_real, visc_vsum, nbr_cnt), as ``cellwise.neighbor_forces_dense``."""
    sums = cellwise.neighbor_forces_dense(
        pos, vel, alive, noise, diameter, surface_smoothing, target_pressure, ignored_pressure,
        spring_overlap_balance, types.SimpleNamespace(enable_spring=bool(spring)))
    return tuple(sums[:6])


def window_pairs_plain(feat, diameter, surface_smoothing, target_pressure,
                       spring_overlap_balance, halo: int, cs: int, n_chunks: int, mode: str,
                       spring: bool) -> torch.Tensor:
    """One crate's window pass -> (p_pad, n_out), as
    ``ops/chunked.py::_pass_scan_plain``."""
    from . import chunked

    return chunked._pass_scan_plain(
        feat, halo, window_outputs(mode, spring), mode, diameter, surface_smoothing,
        target_pressure, spring_overlap_balance, spring and mode == "b", n_chunks, cs)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


class DenseOrder(NamedTuple):
    """D1's prologue over B crates of P slots: ``order`` (B, P) int32, the
    slot of each sorted index; ``pq`` (B, P, 4) f32, the sorted position and
    noisy position (position + noise); ``sv`` (B, P, 2) f32, the sorted
    velocity; ``tiles`` (B, ceil(P / TILE), 8) int32, a record a tile of
    sorted slots (TILE_FIELDS; the box and rows as f32 bits)."""

    order: torch.Tensor
    pq: torch.Tensor
    sv: torch.Tensor
    tiles: torch.Tensor


class _DenseArgs(ctypes.Structure):
    """csrc/pair_batch.cu's DenseArgs, field for field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("pos", "vel", "alive", "noise") + DENSE_COEFS
                 + ("p_i", "cnt", "s", "dv_tension", "pressure_real", "spring_real",
                    "visc_vsum", "order", "pq", "sv", "tiles")]
                + [("B", ctypes.c_int), ("P", ctypes.c_int)])


class _WindowArgs(ctypes.Structure):
    """csrc/pair_batch.cu's WindowArgs, field for field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("feat",) + WINDOW_COEFS + ("out",)]
                + [(k, ctypes.c_int) for k in ("B", "p_pad", "F", "halo", "cs", "n_chunks")])


def _lib():
    lib = cuda_build.load("pair_batch")
    if lib.sc_dense_order.argtypes is None:  # pointers as c_void_p: never cut to int
        lib.sc_dense_order.argtypes = [ctypes.POINTER(_DenseArgs), ctypes.c_void_p]
        lib.sc_dense_order.restype = ctypes.c_int
    for fn, args in ((lib.sc_dense_pass, _DenseArgs), (lib.sc_window_pass, _WindowArgs)):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.POINTER(args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _checked(label: str, device, **tensors) -> dict:
    """Each (name: (tensor, shape, dtype)) on ``device`` with that shape and
    dtype, made contiguous (the kernels read dense arrays)."""
    out = {}
    for name, (t, shape, dtype) in tensors.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{label}: {name} must be a {dtype} tensor of shape {tuple(shape)} "
                             f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        out[name] = t.contiguous()
    return out


def _call(fn, args, device, what: str, *flags) -> None:
    with torch.cuda.device(device):  # launch on the tensors' card
        err = fn(ctypes.byref(args), *flags, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: cudaError {err}")


def _order_ptrs(order: DenseOrder) -> dict:
    B, P = order.order.shape
    t = _checked("dense order", order.order.device, order=(order.order, (B, P), torch.int32),
                 pq=(order.pq, (B, P, 4), torch.float32), sv=(order.sv, (B, P, 2), torch.float32),
                 tiles=(order.tiles, (B, -(-P // TILE), len(TILE_FIELDS)), torch.int32))
    return {k: v.data_ptr() for k, v in t.items()}


def dense_order(pos, vel, alive, noise, diameter) -> DenseOrder:
    """D1's prologue over a leading crate axis (CUDA tensors: pos, vel,
    noise (B, P, 2), alive (B, P), diameter (B,)) -> :class:`DenseOrder`; one
    launch, counted in ``LAUNCHES["dense_order"]``.  Its plain twin is
    :func:`dense_order_plain`."""
    B, P = pos.shape[:2]
    f32, dev = torch.float32, pos.device
    t = _checked("dense_pairs order", dev, pos=(pos, (B, P, 2), f32), vel=(vel, (B, P, 2), f32),
                 alive=(alive, (B, P), torch.bool), noise=(noise, (B, P, 2), f32),
                 diameter=(diameter, (B,), f32))
    out = DenseOrder(torch.empty((B, P), dtype=torch.int32, device=dev),
                     torch.empty((B, P, 4), dtype=f32, device=dev),
                     torch.empty((B, P, 2), dtype=f32, device=dev),
                     torch.empty((B, -(-P // TILE), len(TILE_FIELDS)), dtype=torch.int32,
                                 device=dev))
    if B * P:
        a = _DenseArgs(B=B, P=P, **{k: v.data_ptr() for k, v in t.items()}, **_order_ptrs(out))
        _call(_lib().sc_dense_order, a, dev, "dense order")
        LAUNCHES["dense_order"] += 1
    return out


def dense_pass_a(order: DenseOrder, diameter, ignored_pressure):
    """D1 pass A over a leading crate axis from the prologue's ``order``
    (CUDA tensors; coefficients (B,)) -> (p_i (B, P), s (B, P, 2),
    cnt (B, P)) in slot order; one launch, counted in
    ``LAUNCHES["dense_a"]``."""
    B, P = order.order.shape
    f32, dev = torch.float32, order.pq.device
    t = _checked("dense_pairs pass A", dev, diameter=(diameter, (B,), f32),
                 ignored_pressure=(ignored_pressure, (B,), f32))
    p_i = torch.empty((B, P), dtype=f32, device=dev)
    cnt = torch.empty((B, P), dtype=f32, device=dev)
    s = torch.empty((B, P, 2), dtype=f32, device=dev)
    if B * P:
        a = _DenseArgs(B=B, P=P, p_i=p_i.data_ptr(), cnt=cnt.data_ptr(), s=s.data_ptr(),
                       **{k: v.data_ptr() for k, v in t.items()}, **_order_ptrs(order))
        _call(_lib().sc_dense_pass, a, dev, "dense pass A", 0, 0)
        LAUNCHES["dense_a"] += 1
    return p_i, s, cnt


def dense_pass_b(order: DenseOrder, p_i, s, diameter, surface_smoothing, target_pressure,
                 spring_overlap_balance, spring: bool):
    """D1 pass B over a leading crate axis from the prologue's ``order`` and
    pass A's ``p_i`` and ``s`` (slot order) -> (dv_tension, pressure_real,
    spring_real, visc_vsum), each (B, P, 2) in slot order (``spring_real``
    zeros without ``spring``); one launch, counted in
    ``LAUNCHES["dense_b"]``."""
    B, P = order.order.shape
    f32, dev = torch.float32, order.pq.device
    t = _checked("dense_pairs pass B", dev, p_i=(p_i, (B, P), f32), s=(s, (B, P, 2), f32),
                 diameter=(diameter, (B,), f32), surface_smoothing=(surface_smoothing, (B,), f32),
                 target_pressure=(target_pressure, (B,), f32),
                 spring_overlap_balance=(spring_overlap_balance, (B,), f32))
    outs = [torch.empty((B, P, 2), dtype=f32, device=dev) for _ in range(4)]
    if B * P:
        names = ("dv_tension", "pressure_real", "spring_real", "visc_vsum")
        a = _DenseArgs(B=B, P=P, **{k: v.data_ptr() for k, v in t.items()},
                       **{k: o.data_ptr() for k, o in zip(names, outs)}, **_order_ptrs(order))
        _call(_lib().sc_dense_pass, a, dev, "dense pass B", 1, int(bool(spring)))
        LAUNCHES["dense_b"] += 1
    return tuple(outs)


def window_kernel(feat, diameter, surface_smoothing, target_pressure, spring_overlap_balance,
                  halo: int, cs: int, n_chunks: int, mode: str, spring: bool) -> torch.Tensor:
    """D2, one pass over a leading crate axis (CUDA tensors: feat
    (B, p_pad, F), coefficients (B,)) -> (B, p_pad, n_out); one launch,
    counted in ``LAUNCHES["window_" + mode]``."""
    B, p_pad, F = feat.shape
    f32, dev = torch.float32, feat.device
    spring = bool(spring) and mode == "b"
    if mode not in WINDOW_FEATURES or F < WINDOW_FEATURES[mode]:
        raise ValueError(f"window_pairs: mode {mode!r} with {F} feature columns")
    if cs <= 0 or p_pad % cs or halo < 0 or not 0 <= n_chunks <= p_pad // cs:
        raise ValueError(f"window_pairs: p_pad {p_pad}, cs {cs}, halo {halo}, "
                         f"n_chunks {n_chunks}")
    t = _checked("window_pairs", dev, feat=(feat, (B, p_pad, F), f32),
                 **{k: (v, (B,), f32) for k, v in zip(
                     WINDOW_COEFS, (diameter, surface_smoothing, target_pressure,
                                    spring_overlap_balance))})
    out = torch.empty((B, p_pad, window_outputs(mode, spring)), dtype=f32, device=dev)
    if B * p_pad:
        a = _WindowArgs(B=B, p_pad=p_pad, F=F, halo=halo, cs=cs, n_chunks=n_chunks,
                        out=out.data_ptr(), **{k: v.data_ptr() for k, v in t.items()})
        _call(_lib().sc_window_pass, a, dev, f"window pass {mode}", 0 if mode == "a" else 1,
              int(spring))
        LAUNCHES["window_" + mode] += 1
    return out


# --------------------------------------------------------------------------
# the prologue's plain twin and the skip rule's mirror
# --------------------------------------------------------------------------


def _bounded(*xs) -> torch.Tensor:
    """|x| <= BIG for every x (False at a NaN)."""
    out = None
    for x in xs:
        b = x.abs() <= BIG
        out = b if out is None else out & b
    return out


def _tiled(x: torch.Tensor, size: int, fill=0):
    """(B, n, ...) -> (B, ceil(n / size), size, ...), the tail padded with
    ``fill``."""
    n = x.shape[1]
    pad = -n % size
    if pad:
        x = torch.cat([x, x.new_full((x.shape[0], pad) + tuple(x.shape[2:]), fill)], dim=1)
    return x.reshape((x.shape[0], -1, size) + tuple(x.shape[2:]))


def _boxes(boxed, x, y, r=None) -> list:
    """The per-tile box (and rows) over the slots with ``boxed``, as the
    kernels' warp_box: tiles (B, n, size) -> [x0, x1, y0, y1, r0, r1]."""
    inf = torch.tensor(math.inf, dtype=torch.float32, device=x.device)
    r = torch.zeros_like(x) if r is None else r
    out = []
    for v in (x, y, r):
        out += [torch.where(boxed, v, inf).amin(-1), torch.where(boxed, v, -inf).amax(-1)]
    return out


def _bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., 32) bool -> (...) int32, bit k set for mask[..., k]."""
    v = (mask.to(torch.int64) << torch.arange(TILE, device=mask.device)).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _unbits(bits: torch.Tensor) -> torch.Tensor:
    """(...) int32 -> (..., 32) bool."""
    return ((bits.to(torch.int64)[..., None] >> torch.arange(TILE, device=bits.device)) & 1) == 1


def _records(box: list, alive_bits, flags) -> torch.Tensor:
    floats = torch.stack(box, dim=-1).contiguous().view(torch.int32)
    return torch.cat([floats, alive_bits[..., None], flags[..., None].to(torch.int32)], dim=-1)


def _cell_keys(pos, alive, diameter) -> torch.Tensor:
    """D1's sort key (B, P) int32: the row-major cell of side
    clamp(diameter, EPS) (cells from -1, clamped to 0..CELL_MAX an axis);
    KEY_DEAD for a dead slot or a NaN position."""
    diam = torch.clamp(diameter, min=EPS)[:, None]
    fx = torch.floor(pos[..., 0] / diam) + 1.0
    fy = torch.floor(pos[..., 1] / diam) + 1.0
    dead = ~alive | torch.isnan(fx) | torch.isnan(fy)
    cx = torch.clamp(torch.where(dead, 0.0, fx), 0.0, CELL_MAX).to(torch.int32)
    cy = torch.clamp(torch.where(dead, 0.0, fy), 0.0, CELL_MAX).to(torch.int32)
    return torch.where(dead, KEY_DEAD, cy * 1024 + cx).to(torch.int32)


def dense_order_plain(pos, vel, alive, noise, diameter) -> DenseOrder:
    """The prologue's plain twin over a leading crate axis (any device):
    the same :class:`DenseOrder`, bit for bit (a box's zero may differ in
    sign)."""
    B, P = alive.shape
    if P <= SORT_MAX:
        order = torch.sort(_cell_keys(pos, alive, diameter), dim=1, stable=True).indices
    else:
        order = torch.arange(P, device=pos.device).expand(B, P)
    take = lambda x: torch.take_along_dim(x, order[..., None], dim=1)  # noqa: E731
    p, v, n = take(pos), take(vel), take(noise)
    pq = torch.cat([p, p + n], dim=-1)
    al = torch.take_along_dim(alive, order, dim=1)
    valid = _tiled(torch.ones_like(al), TILE, False)
    x, y, qx, qy = (_tiled(pq[..., k], TILE) for k in range(4))
    vx, vy = _tiled(v[..., 0], TILE), _tiled(v[..., 1], TILE)
    al_t = _tiled(al, TILE, False)
    pos_ok = (~valid | _bounded(x, y, qx, qy)).all(-1)
    vel_ok = (~valid | (_bounded(x, y, qx, qy) & _bounded(vx, vy))).all(-1)
    box = _boxes(al_t & _bounded(x, y), x, y)
    box[4:] = [torch.zeros_like(box[0])] * 2
    flags = pos_ok.to(torch.int32) * POS_OK + vel_ok.to(torch.int32) * VEL_OK
    return DenseOrder(order.to(torch.int32).contiguous(), pq.contiguous(), v.contiguous(),
                      _records(box, _bits(al_t), flags).contiguous())


def _visits(s_box, s_ok, s_any, records, c_ok, diam2, rows: bool):
    """The kernels' rule: (visit, full) over (..., self tiles, candidate
    tiles) from the selves' boxes (..., S) and the candidates' records
    (..., T, 8)."""
    c_box = records[..., :6].contiguous().view(torch.float32).unbind(-1)
    c_alive = records[..., 6] != 0
    sx0, sx1, sy0, sy1, sr0, sr1 = (v[..., :, None] for v in s_box)
    cx0, cx1, cy0, cy1, cr0, cr1 = (v[..., None, :] for v in c_box)
    d2 = diam2.reshape(diam2.shape + (1,) * (sx0.dim() - diam2.dim()))
    gx = torch.clamp(torch.maximum(cx0 - sx1, sx0 - cx1), min=0.0)
    gy = torch.clamp(torch.maximum(cy0 - sy1, sy0 - cy1), min=0.0)
    near = ~(gx * gx + gy * gy > d2)
    if rows:
        near = near & ~(cr0 - sr1 > 1.0) & ~(sr0 - cr1 > 1.0)
    full = ~(s_ok[..., :, None] & c_ok[..., None, :])
    return full | (s_any[..., :, None] & c_alive[..., None, :] & near), full


def dense_visits(order: DenseOrder, diameter, mode: str):
    """Which candidate tiles D1's pass ``mode`` visits for each self tile,
    and which of them it computes pair by pair (an unbounded slot): bool
    (visit, full), each (B, ceil(P / self_tile(P)), ceil(P / TILE))."""
    B, P = order.order.shape
    ts = self_tile(P)
    alive = _unbits(order.tiles[..., 6]).reshape(B, -1)[:, :P]
    x, y = _tiled(order.pq[..., 0], ts), _tiled(order.pq[..., 1], ts)
    valid = _tiled(torch.ones_like(alive), ts, False)
    al = _tiled(alive, ts, False) & valid
    s_box = _boxes(al & _bounded(x, y), x, y)
    s_ok = (~valid | _bounded(x, y)).all(-1)
    need = POS_OK if mode == "a" else VEL_OK
    c_ok = (order.tiles[..., 7] & need) != 0
    diam = torch.clamp(diameter, min=EPS)
    return _visits(s_box, s_ok, al.any(-1), order.tiles, c_ok, diam * diam, rows=False)


def window_visits(feat, diameter, halo: int, cs: int, n_chunks: int):
    """The same for D2 over (B, p_pad, F) slabs: bool (visit, full), each
    (B, n_chunks, ceil(cs / self_tile(p_pad)), ceil((cs + 2 halo) / TILE)),
    window tiles counted from each window's first row."""
    B, p_pad = feat.shape[:2]
    ts = self_tile(p_pad)
    wt = cs + 2 * halo
    n_tiles = -(-wt // TILE)
    f = feat[..., :6]
    featp = torch.nn.functional.pad(f, (0, 0, halo, halo))
    visit, full = [], []
    for c in range(n_chunks):
        win = _tiled(featp[:, c * cs: c * cs + wt], TILE)  # (B, n_tiles, TILE, 6)
        in_win = _tiled(torch.ones((B, wt), dtype=torch.bool, device=feat.device), TILE, False)
        x, y, nx, ny, row = (win[..., k] for k in range(5))
        al = in_win & (win[..., 5] > 0)
        c_ok = (~in_win | _bounded(x, y, nx, ny)).all(-1)
        rec = _records(_boxes(al & _bounded(x, y), x, y, row), _bits(al),
                       c_ok.to(torch.int32) * POS_OK)
        sf = _tiled(f[:, c * cs: c * cs + cs], ts)
        s_in = _tiled(torch.ones((B, cs), dtype=torch.bool, device=feat.device), ts, False)
        sx, sy, srow = sf[..., 0], sf[..., 1], sf[..., 4]
        s_al = s_in & (sf[..., 5] > 0)
        s_box = _boxes(s_al & _bounded(sx, sy), sx, sy, srow)
        s_ok = (~s_in | _bounded(sx, sy)).all(-1)
        v, fu = _visits(s_box, s_ok, s_al.any(-1), rec, c_ok, diameter * diameter, rows=True)
        visit.append(v)
        full.append(fu)
    shape = (B, 0, -(-cs // ts), n_tiles)
    if not visit:
        return (torch.zeros(shape, dtype=torch.bool, device=feat.device),) * 2
    return torch.stack(visit, dim=1), torch.stack(full, dim=1)


def tile_work(visit, self_rows: int, ts: int, cand_rows: int) -> dict:
    """What the rule's ``visit`` (..., S, T) costs a kernel: the tile pairs,
    those visited, and the pairs tested (a visited tile pair's selves times
    its candidates), self tiles of ``ts`` over ``self_rows`` rows and
    candidate tiles of TILE over ``cand_rows``."""
    def rows(n, size):
        return torch.clamp(n - torch.arange(0, n, size, device=visit.device), max=size)

    pairs = (rows(self_rows, ts).double()[:, None] * rows(cand_rows, TILE).double()[None, :])
    return {"tile_pairs": float(visit.numel()), "visited": float(visit.sum()),
            "tested": float((visit.double() * pairs).sum())}


# --------------------------------------------------------------------------
# the operators
# --------------------------------------------------------------------------

_DENSE_SCHEMA = ("(Tensor pos, Tensor vel, Tensor alive, Tensor noise, "
                 + ", ".join(f"Tensor {k}" for k in DENSE_COEFS)
                 + ", int spring) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_WINDOW_SCHEMA = ("(Tensor feat, " + ", ".join(f"Tensor {k}" for k in WINDOW_COEFS)
                  + ", int halo, int cs, int n_chunks, int mode, int spring) -> Tensor")
_MODES = ("a", "b")


@torch.library.custom_op("sand_crate::dense_pairs", mutates_args=(), schema=_DENSE_SCHEMA)
def _dense_op(pos, vel, alive, noise, diameter, surface_smoothing, target_pressure,
              ignored_pressure, spring_overlap_balance, spring):
    """D1 over a leading crate axis: (p_i, dv_tension, pressure_real,
    spring_real, visc_vsum, nbr_cnt), each with the crate axis."""
    per_crate = (pos, vel, alive, noise, diameter, surface_smoothing, target_pressure,
                 ignored_pressure, spring_overlap_balance)
    if pos.device.type == "cuda":
        order = dense_order(pos, vel, alive, noise, diameter)  # once for both passes
        p_i, s, cnt = dense_pass_a(order, diameter, ignored_pressure)
        dv, pr, sp, vs = dense_pass_b(order, p_i, s, diameter, surface_smoothing,
                                      target_pressure, spring_overlap_balance, bool(spring))
        return p_i, dv, pr, sp, vs, cnt
    if pos.device.type == "cpu":
        return crates_plain("dense_pairs", dense_pairs_plain, per_crate, bool(spring))
    raise ValueError(f"dense_pairs: tensors on {pos.device}; expected cpu or cuda")


@torch.library.custom_op("sand_crate::window_pairs", mutates_args=(), schema=_WINDOW_SCHEMA)
def _window_op(feat, diameter, surface_smoothing, target_pressure, spring_overlap_balance, halo,
               cs, n_chunks, mode, spring):
    """D2 over a leading crate axis: (B, p_pad, n_out)."""
    per_crate = (feat, diameter, surface_smoothing, target_pressure, spring_overlap_balance)
    if feat.device.type == "cuda":
        return window_kernel(*per_crate, halo, cs, n_chunks, _MODES[mode], bool(spring))
    if feat.device.type == "cpu":
        return crates_plain("window_pairs", window_pairs_plain, per_crate, halo, cs, n_chunks,
                            _MODES[mode],
                             bool(spring))
    raise ValueError(f"window_pairs: tensors on {feat.device}; expected cpu or cuda")


register_crate_vmap(_dense_op, 9)
register_crate_vmap(_window_op, 5)


# --------------------------------------------------------------------------
# the entries the tick calls
# --------------------------------------------------------------------------


def _one(x):
    """A crate's operand as a batch of one."""
    return x.reshape((1,) + tuple(x.shape))


def neighbor_forces_dense(pos, vel, alive, noise, diameter, surface_smoothing, target_pressure,
                          ignored_pressure, spring_overlap_balance, scene) -> PairSums:
    """The dense backend's pair sums of one crate (the arguments of
    ``cellwise.neighbor_forces_dense``) through the ``sand_crate::
    dense_pairs`` operator: CPU tensors run that plain version; CUDA tensors
    launch D1's two passes (under vmap once for all crates); tensors
    elsewhere raise."""
    on_cpu_or_cuda("dense_pairs", pos)
    out = torch.ops.sand_crate.dense_pairs(
        *(_one(x) for x in (pos, vel, alive, noise, diameter, surface_smoothing,
                            target_pressure, ignored_pressure, spring_overlap_balance)),
        int(scene.enable_spring))
    p_i, dv, pr, sp, vs, cnt = (o[0] for o in out)
    return PairSums(p_i=p_i, dv_tension=dv, pressure_real=pr, spring_real=sp, visc_vsum=vs,
                    nbr_cnt=cnt, overflow=torch.zeros((), dtype=torch.int32, device=pos.device))


def window_pass(feat, halo, n_out, mode, diam, smoothing, target_p, balance, enable_spring,
                n_chunks, cs) -> torch.Tensor:
    """One window pass of one crate (the arguments of
    ``ops/chunked.py::_pass_scan_plain``) -> (p_pad, n_out) through the
    ``sand_crate::window_pairs`` operator: CPU tensors run that plain
    version; CUDA tensors launch D2 (under vmap once for all crates);
    tensors elsewhere raise."""
    on_cpu_or_cuda("window_pairs", feat)
    spring = bool(enable_spring) and mode == "b"
    if n_out != window_outputs(mode, spring):
        raise ValueError(f"window_pairs: mode {mode!r} (spring {spring}) writes "
                         f"{window_outputs(mode, spring)} sums, not {n_out}")
    out = torch.ops.sand_crate.window_pairs(
        _one(feat), *(_one(x) for x in (diam, smoothing, target_p, balance)), halo, cs,
        n_chunks, _MODES.index(mode), int(spring))
    return out[0]
