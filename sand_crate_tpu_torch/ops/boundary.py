"""The ghost pass of the tick: the virtual colliders with their hard-wall
fix, in full and positions-only.

The counterpart of an XLA fusion of the JAX step, not of a
``pl.pallas_call``: ``_ghost_core`` (``sand_crate_tpu/physics.py:331-363``,
the virtual colliders and the hard-wall projection, crate.py:97-99,
202-243), a per-particle function over the crate's S segments.

* :func:`ghost_pass_plain` computes it as plane-wide torch ops over (S, P)
  planes; :func:`ghost_pos_plain` its fixed position alone (the sorted
  backends' cell sort reads nothing else).
* :func:`ghost_pass` and :func:`ghost_pos` dispatch on the tensors'
  device: CPU tensors run the plain version; CUDA tensors launch the
  hand-written kernel of ``csrc/boundary.cu`` (``ghost_kernel<true>`` and
  ``<false>``: a thread per slot in a grid-stride loop, the segments staged
  in shared memory, built by ``nvcc`` at first use) on the current stream
  and count each launch in ``LAUNCHES``; tensors anywhere else raise.  The
  kernels give the plain versions' bits on the card: the same IEEE f32
  operations in the same order, the segment-axis sums in the order of
  torch's dim-0 reduction.

On the card each launch goes through a custom operator
(``torch.ops.sand_crate.ghost_pass``, ``torch.ops.sand_crate.ghost_pos``)
whose kernel takes a leading crate axis: ``torch.func.vmap`` (batched
crates, ``sweep.py``) reaches its vmap rule, which moves the crate dims to
the front and launches once over all crates.  A solo crate is a batch of
one.  On the CPU the wrappers call the plain versions, which vmap natively.

The continuous-collision clamp (``apply_continuous_collision``,
``physics.py:738-749``) is a stage of the tick's velocity update
(``ops/kick.py``: ``kick.continuous_collision`` is that stage alone).
"""

import ctypes

import torch

from .. import geometry as geo
from . import cuda_build

EPS = 1e-12

# Kernel launches since the last reset, counted where each kernel launches.
LAUNCHES = {"ghost": 0, "ghost_pos": 0}


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def ghost_geom(prepos, alive, segments, particle_radius, seg_valid):
    """Ghost-contact geometry on pre-fix positions (crate.py:202-243), as
    (S, P) planes: nearest points, the ghost mask (within 1.2 r of a valid
    segment, alive), the mirror ghost offsets."""
    px, py = prepos[:, 0], prepos[:, 1]
    nx_, ny_, seg_dist = geo.points_to_segments_soa(px, py, segments)
    gmask = (seg_dist <= particle_radius * 1.2) & seg_valid[:, None] & alive[None]
    gm = gmask.to(prepos.dtype)  # (S, P)
    gvx = 2.0 * (px[None] - nx_)  # mirror ghost offsets (S, P)
    gvy = 2.0 * (py[None] - ny_)
    return nx_, ny_, gm, gvx, gvy


def ghost_vel(nx_, ny_, body_lin_vel, body_ang_vel, seg_body, body_center):
    """Ghost velocity from the owning body's point-velocity field at contact:
    v = lin + ang * rot90_cw(contact - center) (rigid_body.py:28-34)."""
    b_lin = body_lin_vel[seg_body]  # (S, 2)
    b_ang = body_ang_vel[seg_body][:, None]  # (S, 1)
    b_cx = body_center[seg_body, 0][:, None]
    b_cy = body_center[seg_body, 1][:, None]
    gvelx = b_lin[:, 0][:, None] + b_ang * (ny_ - b_cy)
    gvely = b_lin[:, 1][:, None] - b_ang * (nx_ - b_cx)
    return gvelx, gvely


def ghost_reductions(gm, gvx, gvy, gvelx, gvely):
    """(g_cnt, gsum, gvel_sum): the ghost sums over the segment axis."""
    g_cnt = gm.sum(dim=0)
    gsum = torch.stack([(gm * gvx).sum(dim=0), (gm * gvy).sum(dim=0)], -1)
    gvel_sum = torch.stack([(gm * gvelx).sum(dim=0), (gm * gvely).sum(dim=0)], -1)
    return g_cnt, gsum, gvel_sum


def _hard_wall(prepos, alive, particle_radius, gm, gvx, gvy):
    """The hard wall projection (crate.py:202-211): each ghost within r
    pushes the particle out to r along its mirror offset."""
    gnorm = torch.sqrt(torch.clamp(gvx * gvx + gvy * gvy, min=0.0))  # (S, P)
    vrd = torch.clamp(particle_radius / torch.clamp(gnorm, min=EPS), min=0.5) - 0.5
    correction = torch.stack(
        [(gm * gvx * vrd).sum(dim=0), (gm * gvy * vrd).sum(dim=0)], dim=-1
    )
    return torch.where(alive[:, None], prepos + correction, prepos)


def ghost_pass_plain(prepos, alive, segments, body_lin_vel, body_ang_vel, particle_radius,
                     seg_valid, seg_body, body_center):
    """Hard-wall-corrected position plus the three ghost reductions
    (crate.py:97-99, 202-243) -> (pos (P, 2), g_cnt (P,), gsum (P, 2),
    gvel_sum (P, 2)).

    A pure per-particle function of the PRE-fix position (the S-axis
    reduction order is fixed), so re-running it on a permutation of prepos
    gives the permuted outputs."""
    nx_, ny_, gm, gvx, gvy = ghost_geom(prepos, alive, segments, particle_radius, seg_valid)
    gvelx, gvely = ghost_vel(nx_, ny_, body_lin_vel, body_ang_vel, seg_body, body_center)
    pos = _hard_wall(prepos, alive, particle_radius, gm, gvx, gvy)
    g_cnt, gsum, gvel_sum = ghost_reductions(gm, gvx, gvy, gvelx, gvely)
    return pos, g_cnt, gsum, gvel_sum


def ghost_pos_plain(prepos, alive, segments, particle_radius, seg_valid):
    """The hard-wall-corrected position (P, 2) alone: ghost_pass_plain's
    ``pos``, bit for bit."""
    _, _, gm, gvx, gvy = ghost_geom(prepos, alive, segments, particle_radius, seg_valid)
    return _hard_wall(prepos, alive, particle_radius, gm, gvx, gvy)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _check(fn, name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape}, got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _lib():
    lib = cuda_build.load("boundary")
    if lib.sc_ghost_pass.argtypes is None:  # pointers as c_void_p: ctypes would cut them to int
        lib.sc_ghost_pass.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.sc_ghost_pass.restype = ctypes.c_int
        lib.sc_ghost_pos.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.sc_ghost_pos.restype = ctypes.c_int
    return lib


def _ghost_launch(prepos, alive, segments, lin, ang, radius, seg_valid, seg_body, body_center,
                  full=True):
    """The kernel over a leading crate axis B; ``full=False`` is the
    positions-only pass (lin, ang, seg_body and body_center unused)."""
    B, P = prepos.shape[:2]
    S = seg_valid.shape[0]
    f32 = torch.float32
    fn = "ghost_pass" if full else "ghost_pos"
    checks = [("prepos", prepos, f32, (B, P, 2)), ("alive", alive, torch.bool, (B, P)),
              ("segments", segments, f32, (B, S, 2, 2)), ("particle_radius", radius, f32, (B,)),
              ("seg_valid", seg_valid, torch.bool, (S,))]
    if full:
        NB = body_center.shape[0]
        checks += [("body_lin_vel", lin, f32, (B, NB, 2)), ("body_ang_vel", ang, f32, (B, NB)),
                   ("seg_body", seg_body, torch.int64, (S,)),
                   ("body_center", body_center, f32, (NB, 2))]
    for name, t, dtype, shape in checks:
        _check(fn, name, t, dtype, shape, prepos.device)
    if prepos.device.type != "cuda":
        raise ValueError(f"{fn}: tensors on {prepos.device}, expected the CUDA device")
    pos = torch.empty_like(prepos)
    stream = torch.cuda.current_stream(prepos.device).cuda_stream
    with torch.cuda.device(prepos.device):  # launch on the tensors' card
        if full:
            g_cnt = torch.empty((B, P), dtype=f32, device=prepos.device)
            gsum = torch.empty_like(prepos)
            gvel_sum = torch.empty_like(prepos)
            err = _lib().sc_ghost_pass(
                prepos.data_ptr(), alive.data_ptr(), segments.data_ptr(), lin.data_ptr(),
                ang.data_ptr(), radius.data_ptr(), seg_valid.data_ptr(), seg_body.data_ptr(),
                body_center.data_ptr(), pos.data_ptr(), g_cnt.data_ptr(), gsum.data_ptr(),
                gvel_sum.data_ptr(), B, P, S, NB, stream,
            )
        else:
            err = _lib().sc_ghost_pos(
                prepos.data_ptr(), alive.data_ptr(), segments.data_ptr(), radius.data_ptr(),
                seg_valid.data_ptr(), pos.data_ptr(), B, P, S, stream,
            )
    if err != 0:
        raise RuntimeError(f"{fn} kernel failed: cudaError {err}")
    LAUNCHES["ghost" if full else "ghost_pos"] += 1
    return (pos, g_cnt, gsum, gvel_sum) if full else pos


def _crates_plain(plain, per_crate, shared):
    """A crate-axis operator's plain version: each crate alone, stacked."""
    outs = [plain(*(x[b] for x in per_crate), *shared) for b in range(per_crate[0].shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


@torch.library.custom_op(
    "sand_crate::ghost_pass", mutates_args=(),
    schema="(Tensor prepos, Tensor alive, Tensor segments, Tensor body_lin_vel, "
           "Tensor body_ang_vel, Tensor particle_radius, Tensor seg_valid, Tensor seg_body, "
           "Tensor body_center) -> (Tensor, Tensor, Tensor, Tensor)",
)
def _ghost_op(prepos, alive, segments, body_lin_vel, body_ang_vel, particle_radius, seg_valid,
              seg_body, body_center):
    """The ghost pass over a leading crate axis: per crate (B, ...) inputs,
    the scene's seg_valid, seg_body and body_center shared."""
    per_crate = (prepos, alive, segments, body_lin_vel, body_ang_vel, particle_radius)
    shared = (seg_valid, seg_body, body_center)
    if prepos.device.type == "cuda":
        return _ghost_launch(*per_crate, *shared)
    if prepos.device.type == "cpu":
        return _crates_plain(ghost_pass_plain, per_crate, shared)
    raise ValueError(f"ghost_pass: tensors on {prepos.device}; expected cpu or cuda")


@torch.library.custom_op(
    "sand_crate::ghost_pos", mutates_args=(),
    schema="(Tensor prepos, Tensor alive, Tensor segments, Tensor particle_radius, "
           "Tensor seg_valid) -> Tensor",
)
def _ghost_pos_op(prepos, alive, segments, particle_radius, seg_valid):
    """The positions-only ghost pass over a leading crate axis; seg_valid
    shared."""
    per_crate = (prepos, alive, segments, particle_radius)
    if prepos.device.type == "cuda":
        return _ghost_launch(prepos, alive, segments, None, None, particle_radius, seg_valid,
                             None, None, full=False)
    if prepos.device.type == "cpu":
        return _crates_plain(ghost_pos_plain, per_crate, (seg_valid,))
    raise ValueError(f"ghost_pos: tensors on {prepos.device}; expected cpu or cuda")


def _fold(x, dim, n):
    """A per-crate operand under vmap as (n * B, ...): the vmapped dim moved
    to the front (an unbatched operand expanded to the n vmapped crates),
    merged with the operator's own crate axis B."""
    x = x.unsqueeze(0).expand((n,) + x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape((-1,) + tuple(x.shape[2:])).contiguous()


def _vmap_rule(op, n_per_crate, name):
    def rule(info, in_dims, *args):
        if any(d is not None for d in in_dims[n_per_crate:]):
            raise ValueError(f"{name}: the scene's tensors are shared by the crates and "
                             f"cannot be vmapped")
        n = info.batch_size
        folded = [_fold(x, d, n) for x, d in zip(args[:n_per_crate], in_dims[:n_per_crate])]
        out = op(*folded, *args[n_per_crate:])
        if isinstance(out, torch.Tensor):
            return out.reshape((n, -1) + tuple(out.shape[1:])), 0
        return tuple(o.reshape((n, -1) + tuple(o.shape[1:])) for o in out), (0,) * len(out)

    return rule


_ghost_op.register_vmap(_vmap_rule(_ghost_op, 6, "ghost_pass"))
_ghost_pos_op.register_vmap(_vmap_rule(_ghost_pos_op, 4, "ghost_pos"))


# --------------------------------------------------------------------------
# the wrappers the tick calls
# --------------------------------------------------------------------------


def _device(fn, t):
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: tensors on {t.device}; expected cpu or cuda")
    return kind


def ghost_pass(prepos, alive, segments, body_lin_vel, body_ang_vel, particle_radius, seg_valid,
               seg_body, body_center):
    """The ghost pass of one crate -> (pos, g_cnt, gsum, gvel_sum), as
    :func:`ghost_pass_plain`.  CPU tensors run the plain version; CUDA
    tensors launch ``ghost_kernel<true>`` of ``csrc/boundary.cu`` on the
    current stream (counted in ``LAUNCHES["ghost"]``; under vmap once for
    all crates); tensors elsewhere raise."""
    args = (prepos, alive, segments, body_lin_vel, body_ang_vel, particle_radius, seg_valid,
            seg_body, body_center)
    if _device("ghost_pass", prepos) == "cpu":
        return ghost_pass_plain(*args)
    return ghost_operator(*args)


def ghost_pos(prepos, alive, segments, particle_radius, seg_valid):
    """The positions-only ghost pass of one crate -> the fixed positions,
    as :func:`ghost_pos_plain`.  CUDA tensors launch ``ghost_kernel<false>``
    (counted in ``LAUNCHES["ghost_pos"]``)."""
    args = (prepos, alive, segments, particle_radius, seg_valid)
    if _device("ghost_pos", prepos) == "cpu":
        return ghost_pos_plain(*args)
    return ghost_pos_operator(*args)


def ghost_operator(prepos, alive, segments, body_lin_vel, body_ang_vel, particle_radius,
                   seg_valid, seg_body, body_center):
    """One crate's ghost pass through the ``sand_crate::ghost_pass``
    operator, as a batch of one (the wrapper's CUDA branch; on CPU tensors
    the operator runs the plain version, which the tests use to hold its
    vmap rule)."""
    per_crate = [x.contiguous()[None] for x in (prepos, alive, segments, body_lin_vel,
                                                body_ang_vel)]
    per_crate.append(particle_radius.reshape(1))
    out = torch.ops.sand_crate.ghost_pass(*per_crate, seg_valid.contiguous(),
                                          seg_body.contiguous(), body_center.contiguous())
    return tuple(o[0] for o in out)


def ghost_pos_operator(prepos, alive, segments, particle_radius, seg_valid):
    """One crate's positions-only pass through the ``sand_crate::ghost_pos``
    operator, as a batch of one."""
    per_crate = [x.contiguous()[None] for x in (prepos, alive, segments)]
    return torch.ops.sand_crate.ghost_pos(*per_crate, particle_radius.reshape(1),
                                          seg_valid.contiguous())[0]
