"""The p-major pair glue: ``pmajor.pair_prep`` and ``pmajor.pass_b_prep``.

On CPU tensors the two entries run the plain torch chain (``pass_a_slab``,
``candidate_ranges``; ``finalize_cp``, ``pass_b_slab``) through the
operators ``sand_crate::pm_prep`` / ``::pm_slab_b``, crate by crate under
their vmap rules, and the launch wrappers check their operands before any
launch.  The cases marked ``cuda`` hold the kernels to the plain chain bit
for bit on the card (skipped without one).  This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_pm_prep.py
"""

import re
from pathlib import Path

import pytest
import torch

from sand_crate_tpu_torch import Params, graphs, load_config
from sand_crate_tpu_torch.bench import dam_break_world
from sand_crate_tpu_torch.collectives import LocalGroup
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.ops import cuda_build, pmajor, pmajor_cases
from sand_crate_tpu_torch.scene import build_scene
from sand_crate_tpu_torch.spatial import make_spatial_step, split_state
from sand_crate_tpu_torch.sweep import DEFAULT_RANDOM_RANGES, BatchedCrates, random_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CASES = sorted(pmajor_cases.CASES)


def _scene(device):
    return build_scene(dam_break_world(20000), device=device)


def _case_inputs(case, scene, device):
    """A case's sorted particles, its noise amplitude and tick, and the
    plain pass A sums over its plain slab (for pass B's prep)."""
    pos, vel, alive, cid = pmajor_cases.sorted_particles(case, scene, device)
    d = scene.cell_size
    amp = torch.tensor(0.1 * d, dtype=torch.float32, device=device)
    tick = torch.tensor(5, dtype=torch.int32, device=device)
    coef = torch.tensor([d, -2.0, 0.5], dtype=torch.float32, device=device)
    slab = pmajor.pass_a_slab(pos, vel, alive, cid, amp, tick, scene, symm=True)
    ranges = pmajor.candidate_ranges(cid, alive, scene.grid_nx, scene.grid_ny)
    out_a = pmajor.pm_pass_plain(slab, ranges, coef, "a", symm=True)
    return (pos, vel, alive, cid, amp, tick), coef, out_a


def _glue_scalars(device):
    """ignored_pressure, surface_smoothing, pressure_amplifier."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in (0.3, 100.0, 30.0))


def _plain_b(slab_a, out_a, ign, sm, pa):
    cp = pmajor.finalize_cp(out_a[0], out_a[3], ign)
    cp_slab = cp if pa is None else cp * (1.0 + pa)
    return pmajor.pass_b_slab(slab_a, out_a, cp_slab, sm), cp


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_entries_on_cpu_are_the_plain_chain(case):
    """pair_prep (symm on and off, ranges on and off) and pass_b_prep (fold
    on and off) on CPU tensors give the plain functions' outputs exactly,
    count no launch and build nothing."""
    scene = _scene("cpu")
    args, _, out_a = _case_inputs(case, scene, "cpu")
    pos, vel, alive, cid, amp, tick = args
    before = dict(pmajor.LAUNCHES)
    for symm in (True, False):
        want = pmajor.pass_a_slab(*args, scene, symm=symm)
        ranges = pmajor.candidate_ranges(cid, alive, scene.grid_nx, scene.grid_ny)
        slab, got = pmajor.pair_prep(*args, scene, symm=symm)
        assert torch.equal(slab, want) and torch.equal(got, ranges)
        slab, got = pmajor.pair_prep(*args, scene, symm=symm, ranges=False)
        assert torch.equal(slab, want) and got is None
    slab_a = pmajor.pass_a_slab(*args, scene, symm=True)
    ign, sm, pa = _glue_scalars("cpu")
    for amplifier in (None, pa):
        slab_b, cp = pmajor.pass_b_prep(slab_a, out_a, ign, sm, amplifier)
        want_b, want_cp = _plain_b(slab_a, out_a, ign, sm, amplifier)
        assert torch.equal(slab_b, want_b) and torch.equal(cp, want_cp)
    assert pmajor.LAUNCHES == before and "pm_prep" not in cuda_build._LIBS


@pytest.mark.parametrize("symm", [True, False], ids=["symm", "one_sided"])
@pytest.mark.parametrize("ranges", [True, False], ids=["ranges", "no_ranges"])
def test_prep_vmap_rule_on_cpu_matches_a_crate_loop(symm, ranges):
    """sand_crate::pm_prep under torch.func.vmap on the batched hard inputs
    (the cases padded with dead slots, an empty crate, a noise amplitude
    and tick per crate) == the plain chain crate by crate; without ranges
    it returns an empty (0, P) block per crate."""
    scene = _scene("cpu")
    nx, ny = scene.grid_nx, scene.grid_ny
    pos, vel, alive, cid = pmajor_cases.batch_particles(scene, "cpu")
    _, amp, tick = pmajor_cases.batch_coefs(pos.shape[0], scene.cell_size, "cpu")
    slab, rng = torch.func.vmap(
        lambda p, v, a, c, m, t: torch.ops.sand_crate.pm_prep(
            p[None], v[None], a[None], c[None], m[None], t[None], nx, ny, int(symm),
            int(ranges)))(pos, vel, alive, cid, amp, tick)
    for b in range(pos.shape[0]):
        want, want_r = pmajor.pair_prep_plain(pos[b], vel[b], alive[b], cid[b], amp[b], tick[b],
                                              scene, symm=symm, ranges=ranges)
        assert torch.equal(slab[b, 0], want)
        if ranges:
            assert torch.equal(rng[b, 0], want_r)
        else:
            assert want_r is None and rng.shape[2:] == (0, pos.shape[1])


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "split"])
def test_slab_b_vmap_rule_on_cpu_matches_a_crate_loop(fold):
    """sand_crate::pm_slab_b under torch.func.vmap, with an ignored
    pressure, a smoothing and an amplifier per crate == pass_b_prep_plain
    crate by crate."""
    scene = _scene("cpu")
    nx, ny = scene.grid_nx, scene.grid_ny
    pos, vel, alive, cid = pmajor_cases.batch_particles(scene, "cpu", names=("random", "dead_tail",
                                                                             "ragged_tile"))
    coef, amp, tick = pmajor_cases.batch_coefs(pos.shape[0], scene.cell_size, "cpu")
    B = pos.shape[0]
    slab_a = torch.stack([pmajor.pass_a_slab(pos[b], vel[b], alive[b], cid[b], amp[b], tick[b],
                                             scene, symm=False) for b in range(B)])
    out_a = torch.stack([pmajor.pm_pass_plain(
        slab_a[b], pmajor.candidate_ranges(cid[b], alive[b], nx, ny), coef[b], "a")
        for b in range(B)])
    ign = torch.tensor([0.3, 0.0, 1.5])
    sm = torch.tensor([100.0, 3.0, 0.5])
    pa = torch.tensor([30.0, 2.0, 0.0])
    slab_b, cp = torch.func.vmap(
        lambda s, o, i, m, a: torch.ops.sand_crate.pm_slab_b(
            s[None], o[None], i[None], m[None], a[None], int(fold)))(slab_a, out_a, ign, sm, pa)
    for b in range(B):
        want, want_cp = pmajor.pass_b_prep_plain(slab_a[b], out_a[b], ign[b], sm[b],
                                                 pa[b] if fold else None)
        assert torch.equal(slab_b[b, 0], want) and torch.equal(cp[b, 0], want_cp)


def _prep_operands(P=40, B=2):
    f32 = torch.float32
    return dict(pos=torch.zeros((B, P, 2)), vel=torch.zeros((B, P, 2)),
                alive=torch.ones((B, P), dtype=torch.bool),
                sorted_cid=torch.zeros((B, P), dtype=torch.int32),
                noise_amp=torch.zeros(B, dtype=f32), tick=torch.zeros(B, dtype=torch.int32))


def _slab_b_operands(P=40, B=2):
    return dict(slab_a=torch.zeros((B, P, 8)), out_a=torch.zeros((B, 6, P)),
                ignored_pressure=torch.zeros(B), surface_smoothing=torch.zeros(B),
                pressure_amplifier=torch.zeros(B))


def _faulty(ops, name, fault):
    t = ops[name]
    if fault == "dtype":
        t = t.double() if t.is_floating_point() else t.to(torch.int64)
    elif fault == "shape":
        t = t[:, :-1] if t.dim() > 1 else t[:-1]
    else:  # a strided view of the right shape
        t = torch.repeat_interleave(t, 2, dim=-1)[..., ::2]
        assert not t.is_contiguous()
    return {**ops, name: t}


@pytest.mark.parametrize("fault", ["dtype", "shape", "noncontiguous", "device"])
@pytest.mark.parametrize("which", ["prep", "slab_b"])
def test_launch_wrappers_check_operands_before_launching(which, fault):
    """Each launch wrapper raises ValueError on an operand of the wrong
    dtype, shape or layout, or off the card, naming it, before it loads or
    launches anything (CPU tensors here: no card is reached)."""
    if which == "prep":
        ops, launch = _prep_operands(), pmajor._launch_prep
        names, extra = list(ops), dict(nx=4, ny=10, symm=False, ranges=True)
    else:
        ops, launch = _slab_b_operands(), pmajor._launch_slab_b
        names, extra = list(ops), dict(fold=True)
    before = dict(pmajor.LAUNCHES)
    cases = ([(None, ops)] if fault == "device"
             else [(n, _faulty(ops, n, fault)) for n in names])
    for name, bad in cases:
        with pytest.raises(ValueError) as err:
            launch(**bad, **extra)
        msg = str(err.value)
        assert (name in msg) if name else ("CUDA device" in msg), msg
    assert pmajor.LAUNCHES == before and "pm_prep" not in cuda_build._LIBS


def test_pmsub_leaves_the_ranges_out(monkeypatch):
    """The tick asks pair_prep for the ranges on K1/K2's schedules and not
    under SAND_CRATE_PMSUB=1 (K10 reads chunk_windows), where the prep
    returns none."""
    crate = Crate(dam_break_world(3000), forces_mode="pmajor", device="cpu")
    crate.run(2)
    asked = []
    real = pmajor.pair_prep

    def spy(*args, **kw):
        out = real(*args, **kw)
        asked.append((kw["ranges"], out[1] is None))
        return out

    monkeypatch.setattr(pmajor, "pair_prep", spy)
    st = crate.state
    for knob, want in (("SAND_CRATE_PMAJOR_GATE", (True, False)),
                       ("SAND_CRATE_PMSUB", (False, True))):
        monkeypatch.setenv(knob, "1")
        pmajor.neighbor_forces_pmajor(st.pos, st.vel, st.alive, crate.params.diameter * 0.1,
                                      st.tick, crate.params.diameter,
                                      crate.params.surface_smoothing,
                                      crate.params.target_pressure,
                                      crate.params.ignored_pressure,
                                      crate.params.spring_overlap_balance, crate.scene)
        monkeypatch.delenv(knob)
        assert asked.pop() == want, knob


@pytest.mark.parametrize("knob", [None, "SAND_CRATE_PMSUB"], ids=["default", "pmsub"])
def test_band_route_takes_the_prep_without_ranges(monkeypatch, knob):
    """A p-major band step asks pair_prep once a band for slab A alone (its
    ranges are the spliced slab's), two-sided only on the default schedule,
    and gets pass_a_slab's slab."""
    crate = Crate(dam_break_world(3000), forces_mode="pmajor", device="cpu")
    crate.run(2)
    scene, D = crate.scene, 2
    asked = []
    real = pmajor.pair_prep

    def spy(*args, **kw):
        slab, rng = real(*args, **kw)
        want = pmajor.pass_a_slab(*args, symm=kw["symm"])
        asked.append((kw["ranges"], kw["symm"], rng is None and torch.equal(slab, want)))
        return slab, rng

    monkeypatch.setattr(pmajor, "pair_prep", spy)
    if knob:
        monkeypatch.setenv(knob, "1")
    group = LocalGroup(D, device="cpu")
    try:
        make_spatial_step(group, scene)(split_state(crate.state, scene, D), crate.params)
    finally:
        group.close()
    assert asked == [(False, scene.pmajor_symm and knob is None, True)] * D


def test_kernel_constants_mirror_the_plain_versions():
    """csrc/pm_prep.cu's hash multipliers are _u01's modulo 2^32, its alive
    offset is ALIVE_OFFSET and its amplitude scale pass_a_slab's."""
    src = (Path(pmajor.__file__).parent.parent / "csrc" / "pm_prep.cu").read_text()
    mults = [int(m) for m in re.findall(r"\*=? (\d+)u;", src)]
    assert mults == [(-1640531527) % 2**32, (-1028477387) % 2**32, (-2048144789) % 2**32]
    assert float(re.search(r"kAliveOffset = ([\d.]+)f;", src).group(1)) == pmajor.ALIVE_OFFSET
    assert re.search(r"kRsqrt2 = 0\.7071067811865476f;", src)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernels_bit_identical_to_the_plain_chain(cuda, case):
    """On the hard inputs of ops/pmajor_cases.py (several selves per cell, a
    range longer than a piece, tiles across grid rows, a ragged last tile,
    P under one tile, a dead tail; cells on the grid's edges where the
    cases reach them): slab A and the ranges (symm on and off, noise zero
    and not, ranges on and off) and slab B with p_i (fold on and off) equal
    the plain chain bit for bit, one call counted each, and K2 (split with
    the spring, and folded) sums the kernel's slab B as the plain one."""
    scene = _scene(cuda)
    args, coef, out_a = _case_inputs(case, scene, cuda)
    pos, vel, alive, cid, amp, tick = args
    ranges = pmajor.candidate_ranges(cid, alive, scene.grid_nx, scene.grid_ny)
    for symm in (True, False):
        for noise in (amp, torch.zeros_like(amp)):
            a = (pos, vel, alive, cid, noise, tick)
            want = pmajor.pass_a_slab(*a, scene, symm=symm)
            n0 = pmajor.LAUNCHES["prep"]
            slab, got = pmajor.pair_prep(*a, scene, symm=symm)
            assert torch.equal(slab, want) and torch.equal(got, ranges), (symm, noise)
            slab, got = pmajor.pair_prep(*a, scene, symm=symm, ranges=False)
            assert torch.equal(slab, want) and got is None
            assert pmajor.LAUNCHES["prep"] == n0 + 2
    slab_a = pmajor.pass_a_slab(*args, scene, symm=True)
    ign, sm, pa = _glue_scalars(cuda)
    for amplifier in (None, pa):
        n0 = pmajor.LAUNCHES["slab_b"]
        slab_b, cp = pmajor.pass_b_prep(slab_a, out_a, ign, sm, amplifier)
        want_b, want_cp = _plain_b(slab_a, out_a, ign, sm, amplifier)
        assert torch.equal(slab_b, want_b) and torch.equal(cp, want_cp), amplifier
        assert pmajor.LAUNCHES["slab_b"] == n0 + 1
        kw = dict(fold=True) if amplifier is not None else dict(spring=True)
        assert torch.equal(pmajor.pm_pass(slab_b, ranges, coef, "b", symm=True, **kw),
                           pmajor.pm_pass_plain(want_b, ranges, coef, "b", symm=True, **kw))


@pytest.mark.cuda
def test_crate_axis_kernels_bit_identical(cuda):
    """Under torch.func.vmap over the batched hard inputs (the cases padded
    with dead slots, an empty crate; noise, tick and coefficients per
    crate) each operator launches once for the batch and equals the plain
    chain crate by crate."""
    scene = _scene(cuda)
    nx, ny = scene.grid_nx, scene.grid_ny
    pos, vel, alive, cid = pmajor_cases.batch_particles(scene, cuda)
    coef, amp, tick = pmajor_cases.batch_coefs(pos.shape[0], scene.cell_size, cuda)
    B = pos.shape[0]
    for symm, ranges in ((True, True), (False, True), (False, False)):
        def prep(*crate):
            slab, rng = pmajor.pair_prep(*crate, scene, symm=symm, ranges=ranges)
            assert (rng is None) != ranges
            return (slab, rng) if ranges else slab

        n0 = pmajor.LAUNCHES["prep"]
        out = torch.func.vmap(prep)(pos, vel, alive, cid, amp, tick)
        slab, rng = out if ranges else (out, None)
        assert pmajor.LAUNCHES["prep"] == n0 + 1
        for b in range(B):
            want, want_r = pmajor.pair_prep_plain(pos[b], vel[b], alive[b], cid[b], amp[b],
                                                  tick[b], scene, symm=symm, ranges=ranges)
            assert torch.equal(slab[b], want), (symm, b)
            assert (rng is None) if not ranges else torch.equal(rng[b], want_r)
    slab_a = slab
    out_a = torch.stack([pmajor.pm_pass_plain(slab_a[b], pmajor.candidate_ranges(
        cid[b], alive[b], nx, ny), coef[b], "a") for b in range(B)])
    ign = torch.linspace(0.0, 1.0, B, device=cuda)
    sm = torch.linspace(1.0, 100.0, B, device=cuda)
    pa = torch.linspace(0.0, 30.0, B, device=cuda)
    for fold in (True, False):
        n0 = pmajor.LAUNCHES["slab_b"]
        slab_b, cp = torch.func.vmap(lambda s, o, i, m, a: pmajor.pass_b_prep(
            s, o, i, m, a if fold else None))(slab_a, out_a, ign, sm, pa)
        assert pmajor.LAUNCHES["slab_b"] == n0 + 1
        for b in range(B):
            want, want_cp = pmajor.pass_b_prep_plain(slab_a[b], out_a[b], ign[b], sm[b],
                                                     pa[b] if fold else None)
            assert torch.equal(slab_b[b], want) and torch.equal(cp[b], want_cp), (fold, b)


@pytest.mark.cuda
def test_prep_and_slab_b_counters_on_the_card(cuda):
    """Over N replays, LAUNCHES["prep"] and ["slab_b"] rise by N on the 1M
    p-major tick and by N for a vmapped p-major batch (one call for the
    batch), and by 0 on a dense batch.  (The band route takes the prep
    alone, once a band, and the plain slab B of its spliced slab:
    tests/test_torch_band_graph.py holds its p-major counters.)"""
    N = 5
    crate = Crate(dam_break_world(1_000_000), device=cuda)
    crate.run(1)
    before = dict(pmajor.LAUNCHES)
    replays = graphs.LAUNCHES["replay"]
    crate.run(N)
    assert graphs.LAUNCHES["replay"] == replays + N
    assert {k: pmajor.LAUNCHES[k] - before[k] for k in ("prep", "slab_b")} == {"prep": N,
                                                                              "slab_b": N}
    del crate
    config = load_config(REPO / "configs" / "stirring_cup.yaml")
    base = Params.from_coefficients(config.world_config.coefficients, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    params = random_params(gen, base, DEFAULT_RANDOM_RANGES, 4)
    for mode, want in (("pmajor", N), ("dense", 0)):
        batch = BatchedCrates(config, params, seed=3, forces_mode=mode, device=cuda)
        batch.run(1)
        before = dict(pmajor.LAUNCHES)
        batch.run(N)
        rise = {k: pmajor.LAUNCHES[k] - before[k] for k in ("prep", "slab_b")}
        assert rise == {"prep": want, "slab_b": want}, mode
