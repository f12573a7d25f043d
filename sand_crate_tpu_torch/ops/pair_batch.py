"""Pair sums of batched crates: the dense all-pairs passes (D1) and the
chunked window passes (D2) as hand-written CUDA kernels, one launch a pass
for every crate of a vmapped batch.

Neither replaces a ``pl.pallas_call``: D1 is the counterpart of the XLA
fusion of ``sand_crate_tpu/cellwise.py:334-392`` (``neighbor_forces_dense``),
D2 of the XLA loop of ``sand_crate_tpu/ops/chunked.py:50`` (``_pass_scan``).

* D1, ``dense_pass_kernel<MODE, SPRING>`` of ``csrc/pair_batch.cu``: pass A
  (counts, weight sums, surface normals and, in its epilogue, ``p_i``), then
  pass B (tension, pressure, the spring where the scene enables it, the
  neighbour velocities).  Its plain twin is ``cellwise.neighbor_forces_dense``
  (each pass alone: ``cellwise.dense_pass_a`` / ``dense_pass_b``).
* D2, ``window_pass_kernel<MODE, SPRING>``: one pass over the first
  ``n_chunks`` cs-wide self chunks of a (p_pad, F) cell-sorted feature slab,
  each against its fixed window ``[c cs - H, c cs + cs + H)``; rows past
  ``n_chunks * cs`` get exact zeros.  Its plain twin is
  ``ops/chunked.py::_pass_scan_plain``.

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
float sums are taken in an order of their own, fixed by the crate's shape
(never by the batch), so a vmapped batch equals each crate alone bit for
bit on the card and the float fields agree with the plain twin to f32
rounding of a reordered sum (see the source's note).
"""

from __future__ import annotations

import ctypes
import types

import torch

from .. import cellwise
from ..cellwise import PairSums
from . import cuda_build

# Kernel launches since the last reset, counted where each pass launches.
LAUNCHES = {"dense_a": 0, "dense_b": 0, "window_a": 0, "window_b": 0}

# The operators' per-crate coefficient operands, (B,) each.
DENSE_COEFS = ("diameter", "surface_smoothing", "target_pressure", "ignored_pressure",
               "spring_overlap_balance")
WINDOW_COEFS = ("diameter", "surface_smoothing", "target_pressure", "spring_overlap_balance")
# Feature columns a window pass reads, and the sums it writes.
WINDOW_FEATURES = {"a": 6, "b": 11}

# f32 operations the pair sums need, each compare, clamp side, sqrt, rsqrt
# and division counted as one: what chip_smoke's bounds charge.  Every pair
# of two alive slots that a pass may count is tested (rx, ry, d2 = rx rx +
# ry ry, d2 <= diam^2: PAIR_TEST_OPS); D2 first tests each alive window
# pair's row delta (its difference and two compares: ROW_TEST_OPS), and
# only the pairs within one row take the d2 test.  Only a pair that counts
# (within one diameter) needs the rest: the noisy offset, its length, the
# clamps, the direction and the weight (14), then the pass's terms and sums
# (COUNTED_PAIR_OPS).
PAIR_TEST_OPS = 6
ROW_TEST_OPS = 3
COUNTED_PAIR_OPS = {"a": 14 + 8, "b": 14 + 20, "b_spring": 14 + 25}


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


class _DenseArgs(ctypes.Structure):
    """csrc/pair_batch.cu's DenseArgs, field for field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("pos", "vel", "alive", "noise") + DENSE_COEFS
                 + ("p_i", "cnt", "s", "dv_tension", "pressure_real", "spring_real",
                    "visc_vsum")]
                + [("B", ctypes.c_int), ("P", ctypes.c_int)])


class _WindowArgs(ctypes.Structure):
    """csrc/pair_batch.cu's WindowArgs, field for field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("feat",) + WINDOW_COEFS + ("out",)]
                + [(k, ctypes.c_int) for k in ("B", "p_pad", "F", "halo", "cs", "n_chunks")])


def _lib():
    lib = cuda_build.load("pair_batch")
    for fn, args in ((lib.sc_dense_pass, _DenseArgs), (lib.sc_window_pass, _WindowArgs)):
        if fn.argtypes is None:  # pointers as c_void_p: never cut to int
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


def _call(fn, args, mode: int, spring: bool, device, what: str) -> None:
    with torch.cuda.device(device):  # launch on the tensors' card
        err = fn(ctypes.byref(args), mode, int(spring), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: cudaError {err}")


def dense_pass_a(pos, alive, noise, diameter, ignored_pressure):
    """D1 pass A over a leading crate axis (CUDA tensors: pos, noise
    (B, P, 2), alive (B, P), coefficients (B,)) -> (p_i (B, P), s (B, P, 2),
    cnt (B, P)); one launch, counted in ``LAUNCHES["dense_a"]``."""
    B, P = pos.shape[:2]
    f32, dev = torch.float32, pos.device
    t = _checked("dense_pairs pass A", dev, pos=(pos, (B, P, 2), f32),
                 alive=(alive, (B, P), torch.bool), noise=(noise, (B, P, 2), f32),
                 diameter=(diameter, (B,), f32), ignored_pressure=(ignored_pressure, (B,), f32))
    p_i = torch.empty((B, P), dtype=f32, device=dev)
    cnt = torch.empty((B, P), dtype=f32, device=dev)
    s = torch.empty((B, P, 2), dtype=f32, device=dev)
    if B * P:
        a = _DenseArgs(B=B, P=P, p_i=p_i.data_ptr(), cnt=cnt.data_ptr(), s=s.data_ptr(),
                       **{k: v.data_ptr() for k, v in t.items()})
        _call(_lib().sc_dense_pass, a, 0, False, dev, "dense pass A")
        LAUNCHES["dense_a"] += 1
    return p_i, s, cnt


def dense_pass_b(pos, vel, alive, noise, p_i, s, diameter, surface_smoothing, target_pressure,
                 spring_overlap_balance, spring: bool):
    """D1 pass B over a leading crate axis from pass A's ``p_i`` and ``s``
    -> (dv_tension, pressure_real, spring_real, visc_vsum), each (B, P, 2)
    (``spring_real`` zeros without ``spring``); one launch, counted in
    ``LAUNCHES["dense_b"]``."""
    B, P = pos.shape[:2]
    f32, dev = torch.float32, pos.device
    t = _checked("dense_pairs pass B", dev, pos=(pos, (B, P, 2), f32),
                 vel=(vel, (B, P, 2), f32), alive=(alive, (B, P), torch.bool),
                 noise=(noise, (B, P, 2), f32), p_i=(p_i, (B, P), f32), s=(s, (B, P, 2), f32),
                 diameter=(diameter, (B,), f32), surface_smoothing=(surface_smoothing, (B,), f32),
                 target_pressure=(target_pressure, (B,), f32),
                 spring_overlap_balance=(spring_overlap_balance, (B,), f32))
    outs = [torch.empty((B, P, 2), dtype=f32, device=dev) for _ in range(4)]
    if B * P:
        names = ("dv_tension", "pressure_real", "spring_real", "visc_vsum")
        a = _DenseArgs(B=B, P=P, **{k: v.data_ptr() for k, v in t.items()},
                       **{k: o.data_ptr() for k, o in zip(names, outs)})
        _call(_lib().sc_dense_pass, a, 1, spring, dev, "dense pass B")
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
        _call(_lib().sc_window_pass, a, 0 if mode == "a" else 1, spring, dev,
              f"window pass {mode}")
        LAUNCHES["window_" + mode] += 1
    return out


# --------------------------------------------------------------------------
# the operators
# --------------------------------------------------------------------------

_DENSE_SCHEMA = ("(Tensor pos, Tensor vel, Tensor alive, Tensor noise, "
                 + ", ".join(f"Tensor {k}" for k in DENSE_COEFS)
                 + ", int spring) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_WINDOW_SCHEMA = ("(Tensor feat, " + ", ".join(f"Tensor {k}" for k in WINDOW_COEFS)
                  + ", int halo, int cs, int n_chunks, int mode, int spring) -> Tensor")
_MODES = ("a", "b")


def _crates_plain(plain, per_crate, *rest):
    """An operator's plain version: each crate alone, stacked."""
    outs = [plain(*(x[b] for x in per_crate), *rest) for b in range(per_crate[0].shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


@torch.library.custom_op("sand_crate::dense_pairs", mutates_args=(), schema=_DENSE_SCHEMA)
def _dense_op(pos, vel, alive, noise, diameter, surface_smoothing, target_pressure,
              ignored_pressure, spring_overlap_balance, spring):
    """D1 over a leading crate axis: (p_i, dv_tension, pressure_real,
    spring_real, visc_vsum, nbr_cnt), each with the crate axis."""
    per_crate = (pos, vel, alive, noise, diameter, surface_smoothing, target_pressure,
                 ignored_pressure, spring_overlap_balance)
    if pos.device.type == "cuda":
        p_i, s, cnt = dense_pass_a(pos, alive, noise, diameter, ignored_pressure)
        dv, pr, sp, vs = dense_pass_b(pos, vel, alive, noise, p_i, s, diameter,
                                      surface_smoothing, target_pressure, spring_overlap_balance,
                                      bool(spring))
        return p_i, dv, pr, sp, vs, cnt
    if pos.device.type == "cpu":
        if pos.shape[0] == 0:
            raise ValueError("dense_pairs: a batch of no crates")
        return _crates_plain(dense_pairs_plain, per_crate, bool(spring))
    raise ValueError(f"dense_pairs: tensors on {pos.device}; expected cpu or cuda")


@torch.library.custom_op("sand_crate::window_pairs", mutates_args=(), schema=_WINDOW_SCHEMA)
def _window_op(feat, diameter, surface_smoothing, target_pressure, spring_overlap_balance, halo,
               cs, n_chunks, mode, spring):
    """D2 over a leading crate axis: (B, p_pad, n_out)."""
    per_crate = (feat, diameter, surface_smoothing, target_pressure, spring_overlap_balance)
    if feat.device.type == "cuda":
        return window_kernel(*per_crate, halo, cs, n_chunks, _MODES[mode], bool(spring))
    if feat.device.type == "cpu":
        if feat.shape[0] == 0:
            raise ValueError("window_pairs: a batch of no crates")
        return _crates_plain(window_pairs_plain, per_crate, halo, cs, n_chunks, _MODES[mode],
                             bool(spring))
    raise ValueError(f"window_pairs: tensors on {feat.device}; expected cpu or cuda")


def _fold(x, dim, n):
    """A per-crate operand under vmap as (n * B, ...): the vmapped dim moved
    to the front (an unbatched operand expanded to the n vmapped crates),
    merged with the operator's own crate axis B."""
    x = x.unsqueeze(0).expand((n,) + x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _unfold(out, n):
    return out.reshape((n, out.shape[0] // n) + tuple(out.shape[1:]))


def _dense_vmap(info, in_dims, *args):
    n_per = 9
    n = info.batch_size
    folded = [_fold(x, d, n) for x, d in zip(args[:n_per], in_dims[:n_per])]
    out = _dense_op(*folded, *args[n_per:])
    return tuple(_unfold(o, n) for o in out), (0,) * 6


def _window_vmap(info, in_dims, *args):
    n_per = 5
    n = info.batch_size
    folded = [_fold(x, d, n) for x, d in zip(args[:n_per], in_dims[:n_per])]
    return _unfold(_window_op(*folded, *args[n_per:]), n), 0


_dense_op.register_vmap(_dense_vmap)
_window_op.register_vmap(_window_vmap)


# --------------------------------------------------------------------------
# the entries the tick calls
# --------------------------------------------------------------------------


def _one(x):
    """A crate's operand as a batch of one."""
    return x.reshape((1,) + tuple(x.shape))


def _on_cpu_or_cuda(what: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {t.device}; expected cpu or cuda")


def neighbor_forces_dense(pos, vel, alive, noise, diameter, surface_smoothing, target_pressure,
                          ignored_pressure, spring_overlap_balance, scene) -> PairSums:
    """The dense backend's pair sums of one crate (the arguments of
    ``cellwise.neighbor_forces_dense``) through the ``sand_crate::
    dense_pairs`` operator: CPU tensors run that plain version; CUDA tensors
    launch D1's two passes (under vmap once for all crates); tensors
    elsewhere raise."""
    _on_cpu_or_cuda("dense_pairs", pos)
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
    _on_cpu_or_cuda("window_pairs", feat)
    spring = bool(enable_spring) and mode == "b"
    if n_out != window_outputs(mode, spring):
        raise ValueError(f"window_pairs: mode {mode!r} (spring {spring}) writes "
                         f"{window_outputs(mode, spring)} sums, not {n_out}")
    out = torch.ops.sand_crate.window_pairs(
        _one(feat), *(_one(x) for x in (diam, smoothing, target_p, balance)), halo, cs,
        n_chunks, _MODES.index(mode), int(spring))
    return out[0]
