"""The boundary chain of the tick (ops/boundary.py): the ghost pass with its
hard-wall fix and the continuous-collision clamp (the velocity update's CCD
stage, ops/kick.py).

On the CPU: the port's wrappers (the plain versions there) against the JAX
package's ``_ghost_core`` and ``apply_continuous_collision`` on every hard
case of ops/boundary_cases.py, at test_torch_step.py's tolerance (rtol
1e-5, atol 1e-6: the same f32 operations, XLA may round the segment-axis
sums in another order); the tick's functions are the plain versions; the
batched paths (vmap of the wrappers, and the crate-axis operators with
their vmap rule, which the card takes) equal each crate alone bit for bit;
and the 1M dam break's wall escapes, rows recorded on the card, pass
through the port's, the JAX package's and the float64 oracle's clamps
alike.

``cuda``-marked tests (skipped without a card) hold the ghost kernel of
csrc/boundary.cu and the velocity update's CCD stage (csrc/kick.cu) to
their plain versions bit for bit, solo, vmapped and inside a captured
graph, with the launch counters rising.  This module
imports JAX only inside the tests that compare with it, so on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_boundary.py
"""

import types

import numpy as np
import pytest
import torch

from sand_crate_tpu_torch import physics as tphys
from sand_crate_tpu_torch.ops import boundary, boundary_cases, kick

torch.set_num_threads(1)

CASES = sorted(boundary_cases.CASES)


def _crates(case, device="cpu"):
    """The case's crates, each as a solo case's tensors."""
    c = boundary_cases.inputs(case, device)
    if case == "batch":
        return [boundary_cases.crate(c, b) for b in range(c["r"].shape[0])]
    return [c]


def _namespaces(c):
    """The case as the JAX package's (params, scene) fields that the two
    functions read, and its tensors as jax arrays."""
    import jax.numpy as jnp

    j = {k: jnp.asarray(v.numpy()) for k, v in c.items()}
    params = types.SimpleNamespace(particle_radius=j["r"], dt=j["dt"])
    scene = types.SimpleNamespace(seg_valid=j["seg_valid"], seg_body=j["seg_body"],
                                  body_center=j["body_center"])
    return j, params, scene


def _close(got, ref, what):
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}[{k}]")


def _same_bits(got, want, what):
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what}[{k}]"
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"{what}[{k}] differs"


@pytest.mark.parametrize("case", CASES)
def test_case_holds_what_it_claims(case):
    facts = boundary_cases.facts(case)
    assert facts["holds"], facts


@pytest.mark.parametrize("case", CASES)
def test_ghost_pass_matches_jax(case):
    from sand_crate_tpu import physics as jphys

    for b, c in enumerate(_crates(case)):
        j, params, scene = _namespaces(c)
        ref = jphys._ghost_core(j["prepos"], j["alive"], j["segments"], j["lin"], j["ang"],
                                params, scene)
        got = boundary.ghost_pass(*boundary_cases.ghost_args(c))
        _close(got, tuple(ref), f"{case} crate {b} ghost pass")


@pytest.mark.parametrize("case", CASES)
def test_continuous_collision_matches_jax(case):
    from sand_crate_tpu import physics as jphys

    for b, c in enumerate(_crates(case)):
        j, params, scene = _namespaces(c)
        ref, _ = jphys.apply_continuous_collision(j["prepos"], j["vel"], j["alive"],
                                                  j["segments"], params, scene)
        got = kick.continuous_collision(*boundary_cases.ccd_args(c))
        _close((got,), (ref,), f"{case} crate {b} continuous collision")


@pytest.mark.parametrize("case", CASES)
def test_tick_functions_are_the_plain_versions(case):
    """physics._ghost_core and the velocity update's CCD stage give the
    plain versions' bits (and the clamp's norm row its masked |dv|)."""
    for c in _crates(case):
        params = types.SimpleNamespace(particle_radius=c["r"], dt=c["dt"])
        scene = types.SimpleNamespace(seg_valid=c["seg_valid"], seg_body=c["seg_body"],
                                      body_center=c["body_center"])
        ghost = tphys._ghost_core(c["prepos"], c["alive"], c["segments"], c["lin"], c["ang"],
                                  params, scene)
        _same_bits(tuple(ghost), boundary.ghost_pass_plain(*boundary_cases.ghost_args(c)),
                   f"{case} _ghost_core")
        out = kick.update(kick.CCD | kick.NORMS, c["vel"], c["prepos"], c["alive"],
                          *(None,) * 9, c["segments"], c["dt"], *(None,) * 6, c["r"],
                          c["seg_valid"])
        want = kick.continuous_collision_plain(*boundary_cases.ccd_args(c))
        _same_bits(out.vel, want, f"{case} the CCD stage")
        dv = want - c["vel"]
        norm = torch.sqrt(torch.clamp(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1], min=0.0))
        _same_bits(out.norms[0], torch.where(c["alive"], norm, 0.0), f"{case} norm row")


def _batched(c):
    g, v = boundary_cases.ghost_args(c), boundary_cases.ccd_args(c)
    return g, v, (0,) * 6 + (None,) * 3, (0,) * 6 + (None,)


@pytest.mark.parametrize("wrappers", ["wrappers", "operators"])
def test_vmap_equals_each_crate_alone(wrappers):
    """torch.func.vmap over the batch case's three crates (radii, steps and
    bodies of their own), randomness="different" as sweep.batched_step
    runs it: on the CPU the wrappers' plain versions vmap natively; the
    operators' path (the wrappers' CUDA branch, here on CPU tensors) goes
    through the vmap rule.  Each equals the crate alone bit for bit."""
    c = boundary_cases.inputs("batch", "cpu")
    g, v, g_dims, v_dims = _batched(c)
    ghost_fn, ccd_fn = ((boundary.ghost_pass, kick.continuous_collision)
                        if wrappers == "wrappers" else
                        (boundary.ghost_operator, kick.ccd_operator))
    ghost = torch.func.vmap(ghost_fn, in_dims=g_dims, randomness="different")(*g)
    ccd = torch.func.vmap(ccd_fn, in_dims=v_dims, randomness="different")(*v)
    for b, one in enumerate(_crates("batch")):
        _same_bits(tuple(o[b] for o in ghost),
                   boundary.ghost_pass_plain(*boundary_cases.ghost_args(one)), f"ghost {b}")
        _same_bits(ccd[b], kick.continuous_collision_plain(*boundary_cases.ccd_args(one)),
                   f"ccd {b}")


def test_operator_vmap_rule_takes_unbatched_operands():
    """The vmap rule expands a per-crate operand that is not vmapped (here
    the radius, the step and the body velocities) to every crate."""
    c = boundary_cases.inputs("motored", "cpu")
    stack = torch.stack([c["prepos"], c["prepos"] + 0.01, c["prepos"] - 0.02])
    g = (stack,) + boundary_cases.ghost_args(c)[1:]
    dims = (0,) + (None,) * 8
    out = torch.func.vmap(boundary.ghost_operator, in_dims=dims)(*g)
    for b in range(3):
        want = boundary.ghost_pass_plain(stack[b], *boundary_cases.ghost_args(c)[1:])
        _same_bits(tuple(o[b] for o in out), want, f"crate {b}")
    v = (stack,) + boundary_cases.ccd_args(c)[1:]
    out = torch.func.vmap(kick.ccd_operator, in_dims=(0,) + (None,) * 6)(*v)
    for b in range(3):
        _same_bits(out[b], kick.continuous_collision_plain(
            stack[b], *boundary_cases.ccd_args(c)[1:]), f"ccd crate {b}")


def test_other_devices_raise():
    c = {k: v.to("meta") for k, v in boundary_cases.inputs("small", "cpu").items()}
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        boundary.ghost_pass(*boundary_cases.ghost_args(c))
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        kick.continuous_collision(*boundary_cases.ccd_args(c))


# --------------------------------------------------------------------------
# the 1M dam break's wall escapes (ROADMAP queue 3's open check)
# --------------------------------------------------------------------------

# Every particle that left [-r, 1 + r] in the first 1000 ticks of the 1M
# dam break (chip_smoke (q2), the port on an H100): the tick, its pre-fix
# position, its hard-wall-fixed position (the clamp's start) and its
# velocity into the clamp.  All sit in the top-left corner cell, within
# 1.2 r of the left and top walls (two ghosts).
ESCAPE_R = 0.0003263127291575074  # the rescaled dam break's f32 radius
ESCAPE_DT = 0.0020000000949949026
ESCAPES = [
    (424, (0.0003263126709498465, 0.9996362328529358), (0.00032631270005367696, 0.9996362328529358),
     (-1.9848814010620117, -6.36637020111084)),
    (447, (0.0003263126709498465, 0.9996246099472046), (0.00032631270005367696, 0.9996246099472046),
     (-7.37451171875, -8.630603790283203)),
    (506, (0.0003263126709498465, 0.9996181130409241), (0.00032631270005367696, 0.9996181130409241),
     (-4.833383560180664, -5.871488571166992)),
    (520, (0.0003263126709498465, 0.9996338486671448), (0.00032631270005367696, 0.9996338486671448),
     (-6.693423271179199, -10.074945449829102)),
    (565, (0.0003263126709498465, 0.9996147751808167), (0.00032631270005367696, 0.9996147751808167),
     (-0.8052034378051758, -5.601102828979492)),
    (570, (0.0003263126709498465, 0.9996204376220703), (0.00032631270005367696, 0.9996204376220703),
     (-12.528615951538086, -14.056697845458984)),
    (573, (0.0003263126709498465, 0.9996522068977356), (0.00032631270005367696, 0.9996522068977356),
     (-0.6664886474609375, -8.857446670532227)),
    (576, (0.0003263126709498465, 0.9996283054351807), (0.00032631270005367696, 0.9996283054351807),
     (-17.399057388305664, -17.025421142578125)),
    (595, (0.0003263126709498465, 0.9996317625045776), (0.00032631270005367696, 0.9996317625045776),
     (-3.0509300231933594, -9.017688751220703)),
]
BOX = [[[0.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [1.0, 0.0]],
       [[1.0, 0.0], [1.0, 1.0]], [[0.0, 1.0], [1.0, 1.0]]]
EPS = 1e-12


def _rot90cw(v):
    return np.stack([v[..., 1], -v[..., 0]], -1)


def _oracle_fix(pos, r, segments):
    """numpy_ref.step_numpy's ghost geometry and hard-wall fix
    (numpy_ref.py:176-195), float64, a fixed box."""
    a = segments[:, 0]
    ab = segments[:, 1] - a
    ap = pos[:, None] - a[None]
    tproj = np.clip((ap * ab[None]).sum(-1) / np.maximum((ab * ab).sum(-1), EPS)[None], 0, 1)
    contact = a[None] + ab[None] * tproj[..., None]
    gm = (np.linalg.norm(contact - pos[:, None], axis=-1) <= r * 1.2).astype(float)
    gvec = 2.0 * (pos[:, None] - contact)
    vrd = np.maximum(r / np.maximum(np.linalg.norm(gvec, axis=-1), EPS), 0.5)
    return pos + np.einsum("ns,nsd->nd", gm * (vrd - 0.5), gvec)


def _oracle_clamp(pos, vel, r, dt, segments):
    """numpy_ref.step_numpy's CCD velocity clamp (numpy_ref.py:260-293),
    float64: the same lines on explicit operands."""
    a = segments[:, 0]
    ab = segments[:, 1] - a
    nrm = _rot90cw(ab)
    off = nrm * r / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), EPS)
    walls = np.concatenate([np.stack([a + off, segments[:, 1] + off], axis=1),
                            np.stack([segments[:, 1] - off, a - off], axis=1)])
    c = walls[:, 0][None]
    d = walls[:, 1][None]
    aa = pos[:, None]
    bb = (pos + vel * dt)[:, None]

    def orient(p1, q1, r1):
        return np.sign((q1[..., 0] - p1[..., 0]) * (r1[..., 1] - q1[..., 1])
                       - (q1[..., 1] - p1[..., 1]) * (r1[..., 0] - q1[..., 0]))

    approaching = (_rot90cw(d - c) * (bb - aa)).sum(-1) < 0
    crossing = (approaching & (orient(aa, bb, c) != orient(aa, bb, d))
                & (orient(c, d, aa) != orient(c, d, bb)))
    cd = d - c
    den = cd[..., 0] * (vel * dt)[:, None, 1] - cd[..., 1] * (vel * dt)[:, None, 0]
    num = (aa - c)[..., 0] * cd[..., 1] - (aa - c)[..., 1] * cd[..., 0]
    t_hit = num / np.where(np.abs(den) > EPS, den, np.where(den >= 0, EPS, -EPS))
    factor = np.min(np.where(crossing, t_hit, np.inf), axis=1)
    return vel * np.minimum(1.0, factor)[:, None]


def _outside(end, r):
    return bool(((end < -r) | (end > 1.0 + r)).any())


@pytest.mark.parametrize("tick, prepos, pos, vel", ESCAPES, ids=[str(e[0]) for e in ESCAPES])
def test_escape_passes_every_clamp(tick, prepos, pos, vel):
    """Each recorded escape: the port's and the JAX package's f32 hard-wall
    fix put the particle at the same position, one ulp short of the left
    wall's padded line x = r (on the wall's side of it), and from there the
    port's, the JAX package's and the float64 oracle's clamps all let its
    move through the wall: the reference's behaviour in f32, not a fault of
    the port.  The oracle's own float64 fix lands on the line (past r) and
    its clamp then stops the particle."""
    import jax.numpy as jnp

    from sand_crate_tpu import physics as jphys

    f32 = np.float32
    r, dt = f32(ESCAPE_R), f32(ESCAPE_DT)
    box = np.asarray(BOX, f32)
    alive = np.array([True])
    t = torch.as_tensor
    seg_valid, seg_body = torch.ones(4, dtype=torch.bool), torch.zeros(4, dtype=torch.int64)
    fixed = boundary.ghost_pass_plain(
        t(np.array([prepos], f32)), t(alive), t(box), torch.zeros(1, 2), torch.zeros(1),
        t(r), seg_valid, seg_body, torch.zeros(1, 2))[0]
    params = types.SimpleNamespace(particle_radius=jnp.float32(r), dt=jnp.float32(dt))
    scene = types.SimpleNamespace(seg_valid=jnp.ones(4, bool), seg_body=jnp.zeros(4, jnp.int32),
                                  body_center=jnp.zeros((1, 2), jnp.float32))
    jfixed = jphys._ghost_core(jnp.asarray([prepos], jnp.float32), jnp.asarray(alive),
                               jnp.asarray(box), jnp.zeros((1, 2), jnp.float32),
                               jnp.zeros(1, jnp.float32), params, scene).pos
    start = np.array([pos], f32)
    assert np.array_equal(fixed.numpy(), start) and np.array_equal(np.asarray(jfixed), start)
    assert start[0, 0] < r  # past the padded line, on the wall's side

    v = np.array([vel], f32)
    port = kick.continuous_collision_plain(t(start), t(v), t(alive), t(box), t(r), t(dt),
                                               seg_valid).numpy()
    jax_vel, _ = jphys.apply_continuous_collision(jnp.asarray(start), jnp.asarray(v),
                                                  jnp.asarray(alive), jnp.asarray(box),
                                                  params, scene)
    oracle = _oracle_clamp(start.astype(float), v.astype(float), float(r), float(dt),
                           box.astype(float))
    assert _outside(start + dt * port, r)
    assert _outside(start + dt * np.asarray(jax_vel), r)
    assert _outside(start.astype(float) + float(dt) * oracle, float(r))

    fixed64 = _oracle_fix(np.array([prepos]), float(r), box.astype(float))
    assert fixed64[0, 0] >= float(r)
    stopped = _oracle_clamp(fixed64, v.astype(float), float(r), float(dt), box.astype(float))
    assert not _outside(fixed64 + float(dt) * stopped, float(r))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ccd_op(pos, vel, alive, segments, r, dt, seg_valid):
    """The clamp over a leading crate axis through the velocity update's
    operator (its CCD stage alone)."""
    return torch.ops.sand_crate.velocity_update(vel, pos, alive, *(None,) * 9, segments, dt,
                                                *(None,) * 6, r, seg_valid, kick.CCD)[0]


def _launches():
    return {**boundary.LAUNCHES, **kick.LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernels_bit_identical_to_plain(cuda, case):
    """The ghost pass (both instantiations) and the update's CCD stage on
    every hard case: the plain versions' bits (NaN payloads and signed
    zeros included); the three-crate case through the crate-axis
    operators, one launch each."""
    c = boundary_cases.inputs(case, cuda)
    before = _launches()
    if case == "batch":
        ghost = torch.ops.sand_crate.ghost_pass(*boundary_cases.ghost_args(c))
        ccd = _ccd_op(*boundary_cases.ccd_args(c))
        for b, one in enumerate(_crates(case, cuda)):
            _same_bits(tuple(o[b] for o in ghost),
                       boundary.ghost_pass_plain(*boundary_cases.ghost_args(one)), f"ghost {b}")
            _same_bits(ccd[b], kick.continuous_collision_plain(
                *boundary_cases.ccd_args(one)), f"ccd {b}")
    else:
        g, v = boundary_cases.ghost_args(c), boundary_cases.ccd_args(c)
        _same_bits(boundary.ghost_pass(*g), boundary.ghost_pass_plain(*g), "ghost")
        _same_bits(kick.continuous_collision(*v), kick.continuous_collision_plain(*v),
                   "ccd")
    assert _launches() == {**before, "ghost": before["ghost"] + 1, "ccd": before["ccd"] + 1}


@pytest.mark.cuda
def test_vmapped_kernels_launch_once_for_all_crates(cuda):
    c = boundary_cases.inputs("batch", cuda)
    g, v, g_dims, v_dims = _batched(c)
    before = _launches()
    ghost = torch.func.vmap(boundary.ghost_pass, in_dims=g_dims, randomness="different")(*g)
    ccd = torch.func.vmap(kick.continuous_collision, in_dims=v_dims,
                          randomness="different")(*v)
    assert _launches() == {**before, "ghost": before["ghost"] + 1, "ccd": before["ccd"] + 1}
    for b, one in enumerate(_crates("batch", cuda)):
        _same_bits(tuple(o[b] for o in ghost),
                   boundary.ghost_pass_plain(*boundary_cases.ghost_args(one)), f"ghost {b}")
        _same_bits(ccd[b], kick.continuous_collision_plain(*boundary_cases.ccd_args(one)),
                   f"ccd {b}")


@pytest.mark.cuda
def test_captured_tick_replays_the_kernels(cuda):
    """A crate's replayed tick (a captured CUDA graph) runs the boundary
    kernels and the velocity update: the counters rise by the
    positions-only and the full ghost pass once a tick each (p-major) and
    the update once, and the replays equal the eager loop with the plain
    versions in place of the kernels bit for bit."""
    from sand_crate_tpu_torch import Crate, load_config_dict
    from sand_crate_tpu_torch.graphs import clone

    world = load_config_dict({"world": {
        "coefficients": {
            "dt": 0.002, "particle_radius": 0.0022, "wall_collision_decay": 0.2,
            "spring_overlap_balance": 0.5, "spring_amplifier": 100,
            "pressure_amplifier": 30, "ignored_pressure": 0.3,
            "collider_noise_level": 0.1, "viscosity": 8, "max_particles": 25000,
            "surface_smoothing": 100, "target_pressure": -2, "gravity": [0, 9.8],
        },
        "particle_sources": [],
        "initial_particles": [{"block": {"x0": 0.02, "y0": 0.1, "x1": 0.42, "y1": 0.98,
                                         "spacing": 0.004, "velocity": [0.0, 0.0],
                                         "jitter": 0.2}}],
        "rigid_bodies": [{"fixed": {"name": "box", "segments": BOX}}],
    }}).world_config
    crate = Crate(world, device=cuda, forces_mode="pmajor")
    state0, gen0 = clone(crate.state), crate.generator.get_state()
    boundary.LAUNCHES.update(ghost=0, ghost_pos=0)
    kick.LAUNCHES.update(velocity_update=0, velocity_update_stage=0, ccd=0)
    crate.run(6)
    want = {"ghost": 6, "ghost_pos": 6, "velocity_update": 6, "velocity_update_stage": 0,
            "ccd": 0}
    assert _launches() == want
    gen = torch.Generator(device=cuda)
    gen.set_state(gen0)
    kept = boundary.ghost_pass, boundary.ghost_pos, kick.update
    boundary.ghost_pass, boundary.ghost_pos = boundary.ghost_pass_plain, boundary.ghost_pos_plain
    kick.update = kick.update_plain
    try:
        state = state0
        for _ in range(6):
            state, _ = tphys.step(state, crate.params, crate.scene, gen)
    finally:
        boundary.ghost_pass, boundary.ghost_pos, kick.update = kept
    assert _launches() == want
    for name, a, b in zip(state._fields, crate.state, state):
        assert torch.equal(a, b), name
