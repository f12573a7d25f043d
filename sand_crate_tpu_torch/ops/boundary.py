"""The boundary chain of the tick: the ghost pass with its hard-wall fix,
and the continuous-collision clamp.

The counterparts of two XLA fusions of the JAX step, not of a
``pl.pallas_call``: ``_ghost_core`` (``sand_crate_tpu/physics.py:331-363``,
the virtual colliders and the hard-wall projection, crate.py:97-99,
202-243) and ``apply_continuous_collision`` (``physics.py:738-749``, the
velocity clamp, crate.py:177-200).  Each is a per-particle function over
the crate's S segments (2S padded walls for the clamp).

* :func:`ghost_pass_plain` and :func:`continuous_collision_plain` compute
  them as plane-wide torch ops over (S, P) and (2S, P) planes.
* :func:`ghost_pass` and :func:`continuous_collision` dispatch on the
  tensors' device: CPU tensors run the plain version; CUDA tensors launch
  the hand-written kernels of ``csrc/boundary.cu`` (a thread per particle,
  the segments staged in shared memory, built by ``nvcc`` at first use) on
  the current stream and count each launch in ``LAUNCHES``; tensors
  anywhere else raise.  The kernels give the plain versions' bits on the
  card: the same IEEE f32 operations in the same order, the segment-axis
  sums and minimum in the order of torch's dim-0 reduction.

On the card each launch goes through a custom operator
(``torch.ops.sand_crate.ghost_pass``, ``torch.ops.sand_crate.ccd``) whose
kernels take a leading crate axis: ``torch.func.vmap`` (batched crates,
``sweep.py``) reaches its vmap rule, which moves the crate dims to the
front and launches once over all crates.  A solo crate is a batch of one.
On the CPU the wrappers call the plain versions, which vmap natively.
"""

import ctypes

import torch

from .. import geometry as geo
from . import cuda_build

EPS = 1e-12

# Kernel launches since the last reset, counted where each kernel launches.
LAUNCHES = {"ghost": 0, "ccd": 0}


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


def ghost_pass_plain(prepos, alive, segments, body_lin_vel, body_ang_vel, particle_radius,
                     seg_valid, seg_body, body_center):
    """Hard-wall-corrected position plus the three ghost reductions
    (crate.py:97-99, 202-243) -> (pos (P, 2), g_cnt (P,), gsum (P, 2),
    gvel_sum (P, 2)).

    A pure per-particle function of the PRE-fix position (the S-axis
    reduction order is fixed), so re-running it on a permutation of prepos
    gives the permuted outputs."""
    r = particle_radius
    nx_, ny_, gm, gvx, gvy = ghost_geom(prepos, alive, segments, r, seg_valid)
    gvelx, gvely = ghost_vel(nx_, ny_, body_lin_vel, body_ang_vel, seg_body, body_center)

    # -- hard wall projection (crate.py:202-211) ----------------------------
    gnorm = torch.sqrt(torch.clamp(gvx * gvx + gvy * gvy, min=0.0))  # (S, P)
    vrd = torch.clamp(r / torch.clamp(gnorm, min=EPS), min=0.5) - 0.5
    correction = torch.stack(
        [(gm * gvx * vrd).sum(dim=0), (gm * gvy * vrd).sum(dim=0)], dim=-1
    )
    pos = torch.where(alive[:, None], prepos + correction, prepos)
    g_cnt, gsum, gvel_sum = ghost_reductions(gm, gvx, gvy, gvelx, gvely)
    return pos, g_cnt, gsum, gvel_sum


def continuous_collision_plain(pos, vel, alive, segments, particle_radius, dt, seg_valid):
    """The continuous collision velocity clamp (crate.py:177-200) -> the
    new velocity (P, 2): each alive particle's move ``vel * dt`` is cut at
    its first crossing of a padded wall it approaches."""
    walls = geo.pad_segments(segments, particle_radius)  # (2S,2,2)
    wall_valid = torch.cat([seg_valid, seg_valid])
    crossing, t_hit = geo.segment_crossings_soa(
        pos[:, 0], pos[:, 1], vel[:, 0] * dt, vel[:, 1] * dt, walls
    )  # (2S, P)
    crossing = crossing & wall_valid[:, None] & alive[None]
    factor = torch.where(crossing, t_hit, torch.inf).amin(dim=0)
    fix = torch.clamp(factor, max=1.0)  # 1 where no crossing
    return vel * fix[:, None]


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _check(fn, name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} is on {t.device}, expected the CUDA device")
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
        lib.sc_ccd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.sc_ccd.restype = ctypes.c_int
    return lib


def _ghost_launch(prepos, alive, segments, lin, ang, radius, seg_valid, seg_body, body_center):
    B, P = prepos.shape[:2]
    S, NB = seg_valid.shape[0], body_center.shape[0]
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("prepos", prepos, f32, (B, P, 2)), ("alive", alive, torch.bool, (B, P)),
        ("segments", segments, f32, (B, S, 2, 2)), ("body_lin_vel", lin, f32, (B, NB, 2)),
        ("body_ang_vel", ang, f32, (B, NB)), ("particle_radius", radius, f32, (B,)),
        ("seg_valid", seg_valid, torch.bool, (S,)), ("seg_body", seg_body, torch.int64, (S,)),
        ("body_center", body_center, f32, (NB, 2)),
    ):
        _check("ghost_pass", name, t, dtype, shape)
        if t.device != prepos.device:
            raise ValueError(f"ghost_pass: {name} is on {t.device}, prepos on {prepos.device}")
    pos = torch.empty_like(prepos)
    g_cnt = torch.empty((B, P), dtype=f32, device=prepos.device)
    gsum = torch.empty_like(prepos)
    gvel_sum = torch.empty_like(prepos)
    with torch.cuda.device(prepos.device):  # launch on the tensors' card
        err = _lib().sc_ghost_pass(
            prepos.data_ptr(), alive.data_ptr(), segments.data_ptr(), lin.data_ptr(),
            ang.data_ptr(), radius.data_ptr(), seg_valid.data_ptr(), seg_body.data_ptr(),
            body_center.data_ptr(), pos.data_ptr(), g_cnt.data_ptr(), gsum.data_ptr(),
            gvel_sum.data_ptr(), B, P, S, NB, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ghost_pass kernel failed: cudaError {err}")
    LAUNCHES["ghost"] += 1
    return pos, g_cnt, gsum, gvel_sum


def _ccd_launch(pos, vel, alive, segments, radius, dt, seg_valid):
    B, P = pos.shape[:2]
    S = seg_valid.shape[0]
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("pos", pos, f32, (B, P, 2)), ("vel", vel, f32, (B, P, 2)),
        ("alive", alive, torch.bool, (B, P)), ("segments", segments, f32, (B, S, 2, 2)),
        ("particle_radius", radius, f32, (B,)), ("dt", dt, f32, (B,)),
        ("seg_valid", seg_valid, torch.bool, (S,)),
    ):
        _check("continuous_collision", name, t, dtype, shape)
        if t.device != pos.device:
            raise ValueError(f"continuous_collision: {name} is on {t.device}, pos on "
                             f"{pos.device}")
    out = torch.empty_like(vel)
    with torch.cuda.device(pos.device):
        err = _lib().sc_ccd(
            pos.data_ptr(), vel.data_ptr(), alive.data_ptr(), segments.data_ptr(),
            radius.data_ptr(), dt.data_ptr(), seg_valid.data_ptr(), out.data_ptr(), B, P, S,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"continuous_collision kernel failed: cudaError {err}")
    LAUNCHES["ccd"] += 1
    return out


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
    "sand_crate::ccd", mutates_args=(),
    schema="(Tensor pos, Tensor vel, Tensor alive, Tensor segments, Tensor particle_radius, "
           "Tensor dt, Tensor seg_valid) -> Tensor",
)
def _ccd_op(pos, vel, alive, segments, particle_radius, dt, seg_valid):
    """The continuous-collision clamp over a leading crate axis; seg_valid
    shared."""
    per_crate = (pos, vel, alive, segments, particle_radius, dt)
    if pos.device.type == "cuda":
        return _ccd_launch(*per_crate, seg_valid)
    if pos.device.type == "cpu":
        return _crates_plain(continuous_collision_plain, per_crate, (seg_valid,))
    raise ValueError(f"continuous_collision: tensors on {pos.device}; expected cpu or cuda")


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
_ccd_op.register_vmap(_vmap_rule(_ccd_op, 6, "continuous_collision"))


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
    tensors launch ``ghost_kernel`` of ``csrc/boundary.cu`` on the current
    stream (counted in ``LAUNCHES["ghost"]``; under vmap once for all
    crates); tensors elsewhere raise."""
    args = (prepos, alive, segments, body_lin_vel, body_ang_vel, particle_radius, seg_valid,
            seg_body, body_center)
    if _device("ghost_pass", prepos) == "cpu":
        return ghost_pass_plain(*args)
    return ghost_operator(*args)


def continuous_collision(pos, vel, alive, segments, particle_radius, dt, seg_valid):
    """The continuous-collision clamp of one crate -> the new velocity, as
    :func:`continuous_collision_plain`.  CPU tensors run the plain version;
    CUDA tensors launch ``ccd_kernel`` of ``csrc/boundary.cu`` on the
    current stream (counted in ``LAUNCHES["ccd"]``; under vmap once for
    all crates); tensors elsewhere raise."""
    args = (pos, vel, alive, segments, particle_radius, dt, seg_valid)
    if _device("continuous_collision", pos) == "cpu":
        return continuous_collision_plain(*args)
    return ccd_operator(*args)


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


def ccd_operator(pos, vel, alive, segments, particle_radius, dt, seg_valid):
    """One crate's clamp through the ``sand_crate::ccd`` operator, as a
    batch of one (the wrapper's CUDA branch)."""
    per_crate = [x.contiguous()[None] for x in (pos, vel, alive, segments)]
    per_crate += [particle_radius.reshape(1), dt.reshape(1)]
    return torch.ops.sand_crate.ccd(*per_crate, seg_valid.contiguous())[0]
