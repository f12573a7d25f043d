"""The tick's velocity update (ops/kick.py) and the positions-only ghost
pass (ops/boundary.py).

On the CPU: every hard case of ops/kick_cases.py holds what it claims; the
plain velocity update, fused (one call of every stage) and staged (one call
a stage, then the integrate), against the JAX package's chain
``apply_tension`` ... ``apply_continuous_collision`` + ``finish_tick`` on
the same seeded inputs, at test_torch_step.py::test_kicks_match_jax's
tolerance (rtol 1e-5, atol 1e-6: the same f32 operations, but XLA may fuse
the normalisations and round the mean-|dv| sums in another order); staged
equals fused bit for bit; ``torch.func.vmap`` of the update (the plain
version, and the operator's path through its vmap rule) equals each crate
alone bit for bit; the positions-only ghost pass equals the full pass's
position bit for bit and the JAX package's ``_ghost_core`` position at the
same tolerance; the seven per-kick functions ``physics.apply_*`` against
the JAX package's at that tolerance (velocity and mean |dv|), and against
the plain update of their single stage bit for bit.

``cuda``-marked tests (skipped without a card) hold ``kick_kernel`` of
csrc/kick.cu, fused and a stage at a time (``physics.apply_*`` too: one
launch each), and ``ghost_kernel<false>`` to
their plain versions bit for bit on the hard cases and on a random 1M
state, and vmapped with one launch (a captured tick replaying them:
tests/test_torch_boundary.py).  This module
imports JAX only inside the tests that compare with it, so on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kicks.py
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sand_crate_tpu_torch.ops import boundary, boundary_cases, kick, kick_cases

torch.set_num_threads(1)

CASES = sorted(kick_cases.CASES)
GHOST_CASES = sorted(boundary_cases.CASES)
RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_step.py::test_kicks_match_jax
COEFS = ("dt", "gravity", "pressure_amplifier", "spring_amplifier", "spring_overlap_balance",
         "viscosity", "wall_collision_decay", "particle_radius")


def _crates(case, device="cpu"):
    """The case's crates, each as a solo case's tensors."""
    c = kick_cases.inputs(case, device)
    if case == "batch":
        return [kick_cases.crate(c, b) for b in range(c["dt"].shape[0])]
    return [c]


def _same_bits(got, want, what):
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for k, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None, f"{what}[{k}]"
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what}[{k}]"
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"{what}[{k}] differs"


def staged(c, update=kick.update):
    """The update a stage a call, as the instrumented tick runs it: the
    kicks' norm rows stacked (no spring row where the case disables it),
    then the integrate."""
    ops = kick_cases.args(c)
    vel, rows = ops[0], []
    for stage in kick.KICKS:
        if stage == kick.SPRING and not c["spring"]:
            continue
        out = update(stage | kick.NORMS, vel, *ops[1:])
        vel, rows = out.vel, rows + [out.norms]
    out = update(kick.INTEGRATE, vel, *ops[1:])
    return out._replace(norms=torch.cat(rows))


def fused(c, update=kick.update):
    return update(kick_cases.stages(c), *kick_cases.args(c))


def _jax_chain(c):
    """The JAX package's kicks, clamp and finish_tick on the case's inputs
    -> (vel, pos, pressure, force_dv, max_speed, non_finite)."""
    import jax
    import jax.numpy as jnp

    from sand_crate_tpu import physics as jphys
    from sand_crate_tpu.cellwise import PairSums as JaxPairSums
    from sand_crate_tpu.state import CrateState as JaxCrateState

    j = {k: jnp.asarray(v.numpy()) for k, v in c.items() if isinstance(v, torch.Tensor)}
    params = types.SimpleNamespace(**{k: j[k] for k in COEFS})
    scene = types.SimpleNamespace(seg_valid=j["seg_valid"])
    i32 = jnp.zeros((), jnp.int32)
    sums = JaxPairSums(*(j[k] for k in JaxPairSums._fields[:-1]), overflow=i32)
    ghost = jphys.GhostInfo(j["pos"], j["g_cnt"], j["gsum"], j["gvel_sum"])
    vel, alive = j["vel"], j["alive"]
    log = []
    for name, fn in (
        ("tension", lambda v: jphys.apply_tension(v, alive, sums, params)),
        ("gravity", lambda v: jphys.apply_gravity(v, alive, params)),
        ("pressure", lambda v: jphys.apply_pressure_force(v, alive, sums, ghost, params)),
        ("spring", lambda v: jphys.apply_spring(v, alive, sums, ghost, params)),
        ("viscosity", lambda v: jphys.apply_viscosity(v, alive, sums, params)),
        ("wall_bounce", lambda v: jphys.apply_wall_bounce(v, alive, ghost, params)),
        ("ccd", lambda v: jphys.apply_continuous_collision(j["pos"], v, alive, j["segments"],
                                                           params, scene)),
    ):
        if name == "spring" and not c["spring"]:
            log.append(jnp.zeros((), jnp.float32))
            continue
        vel, dv = fn(vel)
        log.append(dv)
    P = vel.shape[0]
    state = JaxCrateState(
        pos=j["pos"], vel=j["vel"], alive=alive, pressure=jnp.zeros(P, jnp.float32),
        uid=jnp.arange(P, dtype=jnp.int32), segments=j["segments"],
        body_lin_vel=jnp.zeros((1, 2), jnp.float32), body_ang_vel=jnp.zeros(1, jnp.float32),
        time=jnp.zeros((), jnp.float32), tick=i32, key=jax.random.PRNGKey(0))
    ops = jphys.TickOperands(pos=j["pos"], vel=j["vel"], alive=alive, uid=state.uid,
                             ghost=ghost, sums=sums)
    new, diag = jphys.finish_tick(state, ops, vel, state.body_lin_vel, log, i32, params)
    return (new.vel, new.pos, new.pressure, diag.force_dv, diag.max_speed, diag.non_finite)


@pytest.mark.parametrize("case", CASES)
def test_case_holds_what_it_claims(case):
    facts = kick_cases.facts(case)
    assert facts["holds"], facts


@pytest.mark.parametrize("mode", ["fused", "staged"])
@pytest.mark.parametrize("case", CASES)
def test_plain_update_matches_jax(case, mode):
    for b, c in enumerate(_crates(case)):
        out = (fused if mode == "fused" else staged)(c)
        got = (out.vel, out.pos, out.pressure, kick.force_dv(out.norms, out.cnt), out.max_speed)
        ref = _jax_chain(c)
        for k, (g, r) in enumerate(zip(got, ref)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} crate {b} {mode}[{k}]")
        assert int(out.non_finite) == int(ref[5])


def test_fused_leaves_out_a_disabled_spring():
    """Without the scene's spring the fused update runs no spring stage and
    writes six norm rows; force_dv logs the spring's mean as +0, as the JAX
    package's step does."""
    assert kick.fused(False) & kick.SPRING == 0 and kick.fused(True) & kick.SPRING
    assert kick.norm_rows(kick.fused(False)) == len(kick.KICKS) - 1
    c = kick_cases.inputs("random", "cpu")
    out = fused(c)
    assert out.norms.shape == (len(kick.KICKS) - 1, c["vel"].shape[0])
    means = kick.force_dv(out.norms, out.cnt)
    k = kick.KICKS.index(kick.SPRING)
    assert means.shape == (len(kick.KICKS),)
    _same_bits(means[k], torch.zeros(()), "the spring's mean")
    _same_bits(torch.cat([means[:k], means[k + 1:]]), out.norms.sum(dim=-1) / out.cnt,
               "the other means")


def test_launch_kinds():
    """The launch counter's key: the update of more than one stage, one
    stage, or the clamp alone (with or without its norm row)."""
    assert kick.launch_kind(kick.fused(True)) == "velocity_update"
    assert kick.launch_kind(kick.fused(False, norms=False)) == "velocity_update"
    assert kick.launch_kind(kick.CCD) == kick.launch_kind(kick.CCD | kick.NORMS) == "ccd"
    for stage in kick.KICKS[:-1] + (kick.INTEGRATE,):
        assert kick.launch_kind(stage | kick.NORMS) == "velocity_update_stage"


@pytest.mark.parametrize("case", CASES)
def test_staged_equals_fused(case):
    """One stage a call gives the fused call's bits: velocity, position,
    pressure, norm rows, max_speed, non_finite, cnt and the means."""
    for c in _crates(case):
        a, b = staged(c), fused(c)
        _same_bits(tuple(a), tuple(b), f"{case} staged vs fused")
        _same_bits(kick.force_dv(a.norms, a.cnt), kick.force_dv(b.norms, b.cnt), f"{case} means")


@pytest.mark.parametrize("path", ["plain", "operator"])
def test_vmap_equals_each_crate_alone(path):
    """torch.func.vmap over the batch case's three crates (steps, radii and
    coefficients of their own), randomness="different" as
    sweep.batched_step runs it: the plain version vmaps natively; the
    operator's path (the wrapper's CUDA branch, here on CPU tensors) goes
    through its vmap rule.  Each equals the crate alone bit for bit."""
    c = kick_cases.inputs("batch", "cpu")
    st = kick_cases.stages(c)
    fn = kick.update if path == "plain" else kick.operator_update
    dims = (0,) * len(kick.PER_CRATE) + (None,)
    out = torch.func.vmap(lambda *o: tuple(fn(st, *o)), in_dims=dims,
                          randomness="different")(*kick_cases.args(c))
    for b, one in enumerate(_crates("batch")):
        _same_bits(tuple(o[b] for o in out), tuple(kick.update_plain(st, *kick_cases.args(one))),
                   f"{path} crate {b}")


def test_operator_vmap_rule_takes_unbatched_operands():
    """The vmap rule expands a per-crate operand that is not vmapped (here
    every one but the velocity) to every crate."""
    c = kick_cases.inputs("random", "cpu")
    st = kick_cases.stages(c)
    ops = kick_cases.args(c)
    stack = torch.stack([ops[0], ops[0] * 0.5, -ops[0]])
    dims = (0,) + (None,) * len(kick.PER_CRATE)
    out = torch.func.vmap(lambda *o: tuple(kick.operator_update(st, *o)), in_dims=dims)(
        stack, *ops[1:])
    for b in range(3):
        _same_bits(tuple(o[b] for o in out), tuple(kick.update_plain(st, stack[b], *ops[1:])),
                   f"crate {b}")


APPLY = sorted(kick_cases.APPLY)


def _jax_apply(name, c):
    """(the JAX package's apply_<name>, its arguments) on the solo case c."""
    import jax.numpy as jnp

    from sand_crate_tpu import physics as jphys
    from sand_crate_tpu.cellwise import PairSums as JaxPairSums

    t = {k: jnp.asarray(v.numpy()) for k, v in c.items() if isinstance(v, torch.Tensor)}
    return getattr(jphys, "apply_" + name), kick_cases.apply_arguments(
        name, t, JaxPairSums, jphys.GhostInfo, jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("name", APPLY)
def test_apply_functions_match_jax(name):
    """physics.apply_<name> on every case's crates: the JAX package's
    apply_<name> at the file's tolerance (velocity and mean |dv| over the
    alive slots), and the plain update of its single stage bit for bit."""
    for case in CASES:
        for b, c in enumerate(_crates(case)):
            fn, args = kick_cases.apply_call(name, c)
            vel, mean = fn(*args)
            jfn, jargs = _jax_apply(name, c)
            jvel, jmean = jfn(*jargs)
            for k, (g, r) in enumerate(((vel, jvel), (mean, jmean))):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} {case} crate {b} [{k}]")
            _same_bits((vel, mean), kick_cases.apply_plain(name, c),
                       f"{name} {case} crate {b} vs plain")


def test_other_devices_raise():
    c = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
         for k, v in kick_cases.inputs("one", "cpu").items()}
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        fused(c)
    g = {k: v.to("meta") for k, v in boundary_cases.inputs("small", "cpu").items()}
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        boundary.ghost_pos(*_ghost_pos_args(g))


def _ghost_pos_args(c):
    return (c["prepos"], c["alive"], c["segments"], c["r"], c["seg_valid"])


def _ghost_crates(case, device="cpu"):
    c = boundary_cases.inputs(case, device)
    if case == "batch":
        return [boundary_cases.crate(c, b) for b in range(c["r"].shape[0])]
    return [c]


@pytest.mark.parametrize("case", GHOST_CASES)
def test_ghost_pos_equals_full_pass_and_jax(case):
    """The positions-only pass: the full pass's position bit for bit (the
    plain versions and the wrappers), and JAX's _ghost_core position at the
    tolerance above (XLA may round the segment-axis sums in another order)."""
    import jax.numpy as jnp

    from sand_crate_tpu import physics as jphys

    for b, c in enumerate(_ghost_crates(case)):
        full = boundary.ghost_pass(*boundary_cases.ghost_args(c))[0]
        _same_bits(boundary.ghost_pos(*_ghost_pos_args(c)), full, f"{case} crate {b}")
        _same_bits(boundary.ghost_pos_plain(*_ghost_pos_args(c)),
                   boundary.ghost_pass_plain(*boundary_cases.ghost_args(c))[0], f"{case} plain")
        j = {k: jnp.asarray(v.numpy()) for k, v in c.items()}
        params = types.SimpleNamespace(particle_radius=j["r"], dt=j["dt"])
        scene = types.SimpleNamespace(seg_valid=j["seg_valid"], seg_body=j["seg_body"],
                                      body_center=j["body_center"])
        ref = jphys._ghost_core(j["prepos"], j["alive"], j["segments"], j["lin"], j["ang"],
                                params, scene).pos
        np.testing.assert_allclose(full.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case} crate {b}")


def test_ghost_pos_operator_vmap():
    """The positions-only operator under vmap (the batch case's crates, and
    an unbatched radius) equals each crate alone bit for bit."""
    c = boundary_cases.inputs("batch", "cpu")
    out = torch.func.vmap(boundary.ghost_pos_operator, in_dims=(0, 0, 0, 0, None))(
        *_ghost_pos_args(c))
    for b, one in enumerate(_ghost_crates("batch")):
        _same_bits(out[b], boundary.ghost_pos_plain(*_ghost_pos_args(one)), f"crate {b}")
    r = c["r"][0]
    out = torch.func.vmap(boundary.ghost_pos_operator, in_dims=(0, 0, 0, None, None))(
        c["prepos"], c["alive"], c["segments"], r, c["seg_valid"])
    for b in range(3):
        _same_bits(out[b], boundary.ghost_pos_plain(c["prepos"][b], c["alive"][b],
                                                    c["segments"][b], r, c["seg_valid"]),
                   f"radius shared, crate {b}")


def test_sorted_tick_takes_the_positions_only_pass():
    """physics.ghost_phase: the sorted backends take the fixed positions
    alone (sums None), equal to the full pass's; dense keeps the full pass."""
    from sand_crate_tpu_torch import Crate, physics
    from sand_crate_tpu_torch.config import load_config

    world = load_config(Path(__file__).resolve().parent.parent / "configs"
                        / "stirring_cup.yaml").world_config
    for mode, full in (("pmajor", False), ("chunked", False), ("dense", True)):
        crate = Crate(world, device="cpu", forces_mode=mode)
        crate.run(3)
        st, pr, sc = crate.state, crate.params, crate.scene
        ghost = physics.ghost_phase(st, pr, sc)
        want = boundary.ghost_pass_plain(st.pos, st.alive, st.segments, st.body_lin_vel,
                                         st.body_ang_vel, pr.particle_radius, sc.seg_valid,
                                         sc.seg_body, sc.body_center)
        _same_bits(ghost.pos, want[0], mode)
        assert (ghost.g_cnt is not None) == full, mode


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(c, label):
    """The kernel fused and a stage at a time against the plain version,
    and staged against fused; each call launches the kernel once, counted
    by its kind."""
    before = dict(kick.LAUNCHES)
    f = fused(c)
    assert kick.LAUNCHES == {**before, "velocity_update": before["velocity_update"] + 1}
    _same_bits(tuple(f), tuple(fused(c, kick.update_plain)), f"{label} fused")
    before = dict(kick.LAUNCHES)
    s = staged(c)
    stages = len(kick.KICKS) - (0 if c["spring"] else 1)  # the kicks but the clamp, the integrate
    assert kick.LAUNCHES == {**before, "ccd": before["ccd"] + 1,
                             "velocity_update_stage": before["velocity_update_stage"] + stages}
    _same_bits(tuple(s), tuple(staged(c, kick.update_plain)), f"{label} staged")
    _same_bits(tuple(s), tuple(f), f"{label} staged vs fused")
    _same_bits(kick.force_dv(s.norms, s.cnt), kick.force_dv(f.norms, f.cnt), f"{label} means")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kick_kernel_bit_identical_to_plain(cuda, case):
    """Every hard case, fused and staged: the plain version's bits (NaN
    placement and signed zeros included); the three-crate case through the
    operator, one launch, each crate equal to its plain version."""
    c = kick_cases.inputs(case, cuda)
    if case == "batch":
        before = kick.LAUNCHES["velocity_update"]
        st = kick_cases.stages(c)
        out = torch.ops.sand_crate.velocity_update(*kick_cases.args(c), st)
        assert kick.LAUNCHES["velocity_update"] == before + 1
        for b, one in enumerate(_crates(case, cuda)):
            got = kick._kick_out(st, tuple(o[b] for o in out))
            _same_bits(tuple(got), tuple(kick.update_plain(st, *kick_cases.args(one))),
                       f"crate {b}")
    else:
        _kernel_vs_plain(c, case)


@pytest.mark.cuda
def test_kick_kernel_at_1m(cuda):
    """A random state of 1,050,112 slots (the 1M dam break's capacity), in
    the p-major layout: fused and staged, bit for bit."""
    t = kick_cases.random_state(1_050_112, 5, cuda)
    _kernel_vs_plain(t, "1M")


@pytest.mark.cuda
@pytest.mark.parametrize("case", GHOST_CASES)
def test_ghost_pos_kernel_bit_identical_to_plain(cuda, case):
    c = boundary_cases.inputs(case, cuda)
    before = boundary.LAUNCHES["ghost_pos"]
    if case == "batch":
        out = torch.ops.sand_crate.ghost_pos(*_ghost_pos_args(c))
        for b, one in enumerate(_ghost_crates(case, cuda)):
            _same_bits(out[b], boundary.ghost_pos_plain(*_ghost_pos_args(one)), f"crate {b}")
    else:
        _same_bits(boundary.ghost_pos(*_ghost_pos_args(c)),
                   boundary.ghost_pos_plain(*_ghost_pos_args(c)), case)
        _same_bits(boundary.ghost_pos(*_ghost_pos_args(c)),
                   boundary.ghost_pass(*boundary_cases.ghost_args(c))[0], f"{case} vs full")
    assert boundary.LAUNCHES["ghost_pos"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("name", APPLY)
def test_apply_functions_launch_the_kernel_once(cuda, name):
    """physics.apply_<name> on the card, on every solo hard case: one
    launch of the update kernel of its launch kind, bit for bit the plain
    update of its single stage."""
    kind = kick.launch_kind(kick_cases.APPLY[name][0])
    for case in CASES:
        if case == "batch":
            continue
        c = kick_cases.inputs(case, cuda)
        fn, args = kick_cases.apply_call(name, c)
        before = dict(kick.LAUNCHES)
        got = fn(*args)
        assert kick.LAUNCHES == {**before, kind: before[kind] + 1}, case
        _same_bits(got, kick_cases.apply_plain(name, c), f"{name} {case}")


@pytest.mark.cuda
def test_vmapped_update_launches_once(cuda):
    c = kick_cases.inputs("batch", cuda)
    st = kick_cases.stages(c)
    before = kick.LAUNCHES["velocity_update"]
    dims = (0,) * len(kick.PER_CRATE) + (None,)
    out = torch.func.vmap(lambda *o: tuple(kick.update(st, *o)), in_dims=dims,
                          randomness="different")(*kick_cases.args(c))
    assert kick.LAUNCHES["velocity_update"] == before + 1
    for b, one in enumerate(_crates("batch", cuda)):
        _same_bits(tuple(o[b] for o in out), tuple(kick.update_plain(st, *kick_cases.args(one))),
                   f"crate {b}")
