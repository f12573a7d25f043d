"""Scene construction: config -> (Scene, initial CrateState).

Host-side (NumPy) one-time work, the counterpart of ``sand_crate_tpu/scene.py``:
body placement (scale -> rotate -> translate, reference rigid_body.py:36-40),
emitter setup and the neighbor grid, producing tensors on ``device``.  The
initial particles come from the same numpy RNG as the JAX package, so the
two initial states are equal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import BODY_FIXED, BODY_MOTORED, Config, InitialParticlesConfig, WorldConfig
from .state import CrateState, Params, Scene, resolve_device, scene_from_numpy

FORCES_MODES = ("pmajor", "pallas", "cellwise", "dense", "chunked", "gather")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def place_segments(
    segments: np.ndarray,
    scale: tuple[float, float],
    rotation_deg: float,
    position: tuple[float, float],
) -> np.ndarray:
    """scale -> rotate (degrees) -> translate, matching rigid_body.py:36-40.

    pygame.Vector2.rotate(theta) maps (x, y) -> (x cos - y sin, x sin + y cos).
    """
    seg = np.asarray(segments, dtype=np.float64) * np.asarray(scale)[None, None, :]
    th = math.radians(rotation_deg)
    c, s = math.cos(th), math.sin(th)
    rot = np.array([[c, s], [-s, c]])  # row-vector convention: p' = p @ rot
    seg = seg @ rot
    seg = seg + np.asarray(position)[None, None, :]
    return seg


def row_block(grid_nx: int) -> int:
    """The grid rows a JAX Pallas pass kernel takes at a time (the JAX
    Scene's ``row_block``, sand_crate_tpu/scene.py:188-190): 8, halved
    while a block of padded rows (nx + 2 rounded up to 128 lanes) exceeds
    4608 cells.  The port keeps no such blocks; grid_ny is a multiple of it
    so that both packages' cell ids agree."""
    nxp = _round_up(grid_nx + 2, 128)
    rb = 8
    while rb > 1 and rb * nxp > 4608:
        rb //= 2
    return rb


def default_capacity(max_particles: int) -> int:
    return max(128, _round_up(int(max_particles), 128))


def auto_forces_mode(capacity: int) -> str:
    """The backend ``forces_mode="auto"`` picks for a crate of ``capacity``
    slots, on every device, so a CPU run takes the path the card takes:
    dense all-pairs up to 4096, the p-major kernels above.

    On its accelerator the JAX package runs chunked from 2049 to 4096
    (sand_crate_tpu/scene.py:85-100).  On the H100 the chunked backend's
    loop over self chunks ran a capacity-4096 crate (wave_machine) about 5x
    slower than dense, and dense was ahead of p-major too (chip_smoke.py
    phase (j), PERF.md), so the port's dense range reaches 4096; chunked
    serves batched crates (sweep.py)."""
    return "dense" if capacity <= 4096 else "pmajor"


def build_all(
    config: Config, *, seed: int = 0, capacity: int | None = None, device="cuda",
    **scene_kwargs
) -> tuple[Scene, CrateState, Params]:
    """One-stop: parsed config -> (Scene, initial CrateState, Params) on
    ``device`` (the card unless the caller asks for the CPU)."""
    world = config.world_config
    scene = build_scene(world, capacity=capacity, device=device, **scene_kwargs)
    state = init_state(world, scene, seed=seed)
    params = Params.from_coefficients(world.coefficients, scene.segments0.device)
    return scene, state, params


def build_scene(
    world: WorldConfig,
    *,
    capacity: int | None = None,
    enable_spring: bool = False,
    forces_mode: str = "auto",
    max_neighbors: int = 20,
    cell_capacity: int | None = None,
    chunk_halo: int | None = None,
    chunk_cs: int = 256,
    fold_pairs: bool | None = None,
    pmajor_symm: bool | None = None,
    device="cuda",
    dtype=torch.float32,
) -> Scene:
    """Build the immutable Scene from a parsed world config.

    ``forces_mode``: one of :data:`FORCES_MODES` ("pallas" is the slot-grid
    kernel backend, "cellwise" the cell grid in plain torch, "gather" the
    fixed-K neighbor lists), or "auto", which picks by capacity
    (:func:`auto_forces_mode`; it picks only "dense" or "pmajor").
    ``max_neighbors``: the gather backend's K (default 20, the reference's
    cap).  ``cell_capacity``: slots per cell of the pallas and cellwise
    grids and of the gather cell table (default 16, as in the JAX
    package).  ``chunk_halo`` / ``chunk_cs``: the chunked backend's
    halo (default: about two grid rows of the sorted slab, as in the JAX
    package) and self-chunk width.  ``device`` defaults to the card;
    without one it raises, and the caller asks for the CPU with
    ``device="cpu"``.
    """
    device = resolve_device(device, "build_scene")
    coeff = world.coefficients
    diameter = 2.0 * float(coeff["particle_radius"])
    capacity = capacity or default_capacity(int(coeff["max_particles"]))
    if forces_mode == "auto":
        forces_mode = auto_forces_mode(capacity)
    if forces_mode not in FORCES_MODES:
        raise ValueError(f"unknown forces_mode {forces_mode!r}")
    if cell_capacity is None:
        cell_capacity = 16

    # ---- rigid bodies ----
    seg_list, seg_body = [], []
    body_kind, body_center, motor_lin, motor_ang = [], [], [], []
    init_lin_vel, init_ang_vel = [], []
    motor_exprs = []
    for b_idx, body in enumerate(world.rigid_bodies):
        seg = place_segments(body.segments, body.scale, body.rotation, body.position)
        seg_list.append(seg)
        seg_body.extend([b_idx] * len(seg))
        body_kind.append(body.kind)
        body_center.append(body.position)
        motor_lin.append([body.motor_vx.as_tuple(), body.motor_vy.as_tuple()])
        motor_ang.append(body.motor_ang.as_tuple())
        init_lin_vel.append(body.center_velocity)
        init_ang_vel.append(body.angular_velocity0)
        if body.kind == BODY_MOTORED:
            for ch, spec in enumerate((body.motor_vx, body.motor_vy, body.motor_ang)):
                if spec.expr is not None:
                    motor_exprs.append((b_idx, ch, spec.expr))

    num_bodies = max(1, len(world.rigid_bodies))
    if seg_list:
        segments0 = np.concatenate(seg_list, axis=0)
        seg_valid = np.ones(len(segments0), bool)
    else:
        # Degenerate far-away segment so the (S, P) boundary math always has
        # at least one (masked) row.
        segments0 = np.array([[[1e6, 1e6], [1e6 + 1.0, 1e6]]])
        seg_valid = np.zeros(1, bool)
        seg_body = [0]
    if not world.rigid_bodies:
        body_kind, body_center = [BODY_FIXED], [(0.0, 0.0)]
        motor_lin, motor_ang = [[(0.0,) * 4, (0.0,) * 4]], [(0.0,) * 4]
        init_lin_vel, init_ang_vel = [(0.0, 0.0)], [0.0]

    # ---- emitters ----
    sources = world.particle_sources
    num_sources = len(sources)
    if num_sources:
        src = dict(
            src_position=np.array([s.position for s in sources], float),
            src_velocity=np.array([s.velocity for s in sources], float),
            src_radius=np.array([s.radius for s in sources], float),
            src_flow=np.array([s.flow for s in sources], float),
            src_noise=np.array([s.noise for s in sources], float),
            src_active_ticks=np.array([s.active_ticks for s in sources], np.int32),
        )
    else:
        src = dict(
            src_position=np.zeros((1, 2)),
            src_velocity=np.zeros((1, 2)),
            src_radius=np.zeros(1),
            src_flow=np.zeros(1),
            src_noise=np.zeros(1),
            src_active_ticks=np.zeros(1, np.int32),
        )

    # ---- neighbor grid ----
    # Cell size = one diameter: candidates for the <=diameter cutoff live in
    # the 3x3 cell neighborhood.  Positions live in [-r, 1+r] (out-of-box
    # culling, crate.py:149-159); one margin cell each side.
    cell_size = diameter
    grid_nx = int(math.ceil(1.0 / cell_size)) + 3
    # grid_ny is rounded up exactly as the JAX package rounds it (to its
    # Pallas row block), so both packages give every particle the same cell
    # id and the same dead sentinel nx * ny.
    grid_ny = _round_up(grid_nx, row_block(grid_nx))

    # ---- chunked-backend halo (JAX scene.py:194-206) ----
    if chunk_halo is None:
        chunk_halo = min(_round_up(capacity, 128), max(256, _round_up(2 * grid_nx, 128)))

    # ---- p-major pair options (JAX defaults, scene.py:208-221) ----
    if fold_pairs is None:
        fold_pairs = forces_mode == "pmajor" and not enable_spring
    if pmajor_symm is None:
        pmajor_symm = forces_mode == "pmajor"

    # ---- spawn cap ----
    dt = float(coeff["dt"])
    exp_spawn = max((float(s.flow) * dt for s in sources), default=0.0)
    max_spawn = int(min(capacity, _round_up(int(exp_spawn + 6 * exp_spawn**0.5 + 8), 8)))

    return scene_from_numpy(
        dict(
            segments0=segments0,
            seg_body=np.asarray(seg_body, np.int32),
            seg_valid=seg_valid,
            body_kind=np.asarray(body_kind, np.int32),
            body_center=np.asarray(body_center, float),
            motor_lin=np.asarray(motor_lin, float),
            motor_ang=np.asarray(motor_ang, float),
            init_lin_vel=np.asarray(init_lin_vel, float),
            init_ang_vel=np.asarray(init_ang_vel, float),
            **src,
            capacity=capacity,
            num_bodies=num_bodies,
            num_sources=num_sources,
            cell_size=cell_size,
            grid_nx=grid_nx,
            grid_ny=grid_ny,
            max_spawn=max_spawn,
            enable_spring=enable_spring,
            forces_mode=forces_mode,
            max_neighbors=int(max_neighbors),
            cell_capacity=int(cell_capacity),
            chunk_halo=int(chunk_halo),
            chunk_cs=int(chunk_cs),
            fold_pairs=bool(fold_pairs),
            pmajor_symm=bool(pmajor_symm),
            motor_exprs=tuple(motor_exprs),
        ),
        device,
        dtype,
    )


def _initial_block_particles(
    blocks: list[InitialParticlesConfig], capacity: int, seed: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Generate bulk-seeded particles for ``world.initial_particles`` blocks."""
    rng = np.random.default_rng(seed)
    pos_list, vel_list = [], []
    for blk in blocks:
        xs = np.arange(blk.x0, blk.x1, blk.spacing)
        ys = np.arange(blk.y0, blk.y1, blk.spacing)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        p = np.stack([gx.ravel(), gy.ravel()], axis=-1)
        if blk.jitter:
            p = p + (rng.random(p.shape) - 0.5) * blk.spacing * blk.jitter
        v = np.broadcast_to(np.asarray(blk.velocity, np.float64), p.shape)
        pos_list.append(p)
        vel_list.append(v)
    if not pos_list:
        return np.zeros((0, 2)), np.zeros((0, 2)), 0
    pos = np.concatenate(pos_list)[:capacity]
    vel = np.concatenate(vel_list)[:capacity]
    return pos, vel, len(pos)


def init_state(
    world: WorldConfig, scene: Scene, *, seed: int = 0, dtype=torch.float32
) -> CrateState:
    """Initial CrateState on the scene's device (reference crate.py:23-33)."""
    P = scene.capacity
    device = scene.segments0.device
    pos = np.zeros((P, 2))
    vel = np.zeros((P, 2))
    alive = np.zeros(P, bool)
    if world.initial_particles:
        p0, v0, n0 = _initial_block_particles(world.initial_particles, P, seed)
        pos[:n0], vel[:n0], alive[:n0] = p0, v0, True
    return CrateState(
        pos=torch.as_tensor(pos, dtype=dtype, device=device),
        vel=torch.as_tensor(vel, dtype=dtype, device=device),
        alive=torch.as_tensor(alive, device=device),
        pressure=torch.zeros(P, dtype=dtype, device=device),
        uid=torch.arange(P, dtype=torch.int32, device=device),
        segments=scene.segments0,
        body_lin_vel=scene.init_lin_vel,
        body_ang_vel=scene.init_ang_vel,
        time=torch.zeros((), dtype=dtype, device=device),
        tick=torch.zeros((), dtype=torch.int32, device=device),
    )

