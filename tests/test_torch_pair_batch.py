"""The batched pair kernels' operators and plain versions (ops/pair_batch.py).

On the CPU: every hard case of ops/pair_batch_cases.py holds what it
claims; the dense plain version (``cellwise.neighbor_forces_dense``,
reached through ``pair_batch.neighbor_forces_dense``) against the JAX
package's ``neighbor_forces_dense`` compiled as its step runs it, and the chunked backend (whose window
passes go through ``pair_batch.window_pass``) against the JAX package's
``neighbor_forces_chunked``, on every case and crate: float fields at
tests/test_torch_dense_chunked.py::_assert_sums's tolerance (1e-5 relative
plus 1e-5 of the field's largest magnitude), neighbour counts and the
overflow exact, NaN in the same places; the operators
``sand_crate::dense_pairs`` and ``::window_pairs`` on CPU tensors (each
crate's plain version) under ``torch.func.vmap`` equal each crate alone bit
for bit, with coefficients of their own; other devices raise.

The kernels' skip rule (ops/pair_batch.py's torch mirror: the prologue's
plain twin ``dense_order_plain``, ``dense_visits``, ``window_visits``, with
the kernels' tile sizes) never skips a tile pair that holds a counted pair
or a non-finite slot, on every case, and does skip tiles on
``tiles_exact``.

``cuda``-marked tests (skipped without a card) hold D1 and D2
(csrc/pair_batch.cu) against their plain versions on the card on every
case and on a random batch of 1024 crates of 640 slots (counts exact, NaN
places equal, floats at that tolerance), D1's prologue against its plain
twin, and check that a vmapped call launches each kernel once and equals
each crate alone bit for bit.  This
module imports JAX only inside the tests that compare with it, so on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_pair_batch.py
"""

import numpy as np
import pytest
import torch

from sand_crate_tpu_torch import cellwise
from sand_crate_tpu_torch.ops import chunked, pair_batch
from sand_crate_tpu_torch.ops import pair_batch_cases as cases

torch.set_num_threads(1)

CASES = list(cases.CASES)
FIELDS = cases.FIELDS


def _fields(sums, spring=True):
    """A PairSums' fields in ``cases.FIELDS`` order (spring_real left out
    without the spring: the step reads it only then)."""
    return tuple(getattr(sums, k) for k in FIELDS if spring or k != "spring_real")


def _names(spring=True):
    return tuple(k for k in FIELDS if spring or k != "spring_real")


def _same_bits(got, want, what):
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what}[{k}]"
        assert torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)), \
            f"{what}[{k}] differs"


@pytest.mark.parametrize("case", CASES)
def test_case_holds_what_it_claims(case):
    facts = cases.facts(case)
    assert all(facts.values()), {k: v for k, v in facts.items() if not v}


@pytest.mark.parametrize("case", CASES)
def test_dense_plain_matches_jax(case):
    """The port's dense pair sums on the CPU (its plain version) against the
    JAX package's compiled ``neighbor_forces_dense`` (jitted, as its step
    runs it: XLA selects the masked weight and terms, so a dead slot at a
    NaN position leaves ``p_i`` finite) on the same inputs, crate by
    crate."""
    import jax
    import jax.numpy as jnp

    from sand_crate_tpu.cellwise import neighbor_forces_dense as jax_dense

    c = cases.inputs(case)
    sc = cases.scene(c)
    compiled = jax.jit(lambda *a: jax_dense(*a, sc))
    for b in range(cases.crates(c)):
        args = cases.dense_args(c, b)
        got = pair_batch.neighbor_forces_dense(*args, sc)
        ref = compiled(*(jnp.asarray(x.numpy()) for x in args))
        ref_f = tuple(torch.as_tensor(np.array(getattr(ref, k))) for k in _names(c["spring"]))
        cases.assert_sums(_fields(got, c["spring"]), ref_f, _names(c["spring"]))
        assert int(got.overflow) == int(ref.overflow) == 0
        if not c["spring"]:
            assert not bool(got.spring_real.any())


@pytest.mark.parametrize("case", CASES)
def test_chunked_plain_matches_jax(case):
    """The port's chunked pair sums on the CPU (the window passes' plain
    version) against the JAX package's ``neighbor_forces_chunked``, in
    particle order, crate by crate: the window loss and the sweep bound
    counted alike."""
    import jax.numpy as jnp

    from sand_crate_tpu.ops.chunked import neighbor_forces_chunked as jax_chunked

    c = cases.inputs(case)
    sc = cases.scene(c)
    tick = torch.tensor(cases.TICK, dtype=torch.int32)
    for b in range(cases.crates(c)):
        args = (c["pos"][b], c["vel"][b], c["alive"][b], c["noise_amp"][b], tick,
                *(c[k][b] for k in pair_batch.DENSE_COEFS))
        got = chunked.neighbor_forces_chunked(*args, sc, live_rows=c["live_rows"])
        live = None if c["live_rows"] is None else jnp.int32(c["live_rows"])
        ref = jax_chunked(*(jnp.asarray(x.numpy()) for x in args), sc, live_rows=live)
        ref_f = tuple(torch.as_tensor(np.array(getattr(ref, k))) for k in _names(c["spring"]))
        cases.assert_sums(_fields(got, c["spring"]), ref_f, _names(c["spring"]))
        assert int(got.overflow) == int(ref.overflow)


def _tile_any(bad: torch.Tensor, size: int) -> torch.Tensor:
    """(n,) bool -> (ceil(n / size),): the tiles of ``size`` holding one."""
    return pair_batch._tiled(bad[None], size, False)[0].any(-1)


def _held_by_visits(visit, full, counted, bad_self, bad_cand, ts):
    """Every counted pair (i, j) of ``counted`` lies in a visited tile pair,
    and every tile pair with a non-finite self or candidate is visited pair
    by pair."""
    i, j = counted.nonzero().unbind(1)
    assert bool(visit[i // ts, j // pair_batch.TILE].all()), "a counted pair in a skipped tile"
    computed = visit & full
    assert bool(computed[_tile_any(bad_self, ts)].all()), "a non-finite self tile skipped"
    assert bool(computed[:, _tile_any(bad_cand, pair_batch.TILE)].all()), \
        "a non-finite candidate tile skipped"


def _finite(*xs) -> torch.Tensor:
    return torch.stack([torch.isfinite(x) for x in xs]).all(0)


@pytest.mark.parametrize("case", CASES)
def test_skip_rule_is_conservative(case):
    """The rule the kernels skip candidate tiles by, as ops/pair_batch.py
    mirrors it with their tile sizes: D1 on the prologue's order (both
    passes: pass B's flags cover the velocities), D2 on each pass's slab and
    chunk windows.  No skipped tile pair holds a counted pair (f32 d2 <=
    diam^2, each product rounded, as the kernels take it) or a non-finite
    slot; on ``tiles_exact`` the rule skips tiles of both kernels."""
    c = cases.inputs(case)
    od = pair_batch.dense_order_plain(*(c[k] for k in ("pos", "vel", "alive", "noise",
                                                      "diameter")))
    B, P = od.order.shape
    assert all(torch.equal(od.order[b].sort().values, torch.arange(P, dtype=torch.int32))
               for b in range(B))
    skipped = {"dense": 0, "window": 0}
    for mode in "ab":
        visit, full = pair_batch.dense_visits(od, c["diameter"], mode)
        for b in range(B):
            alive = c["alive"][b][od.order[b].long()]
            px, py, qx, qy = od.pq[b].unbind(-1)
            diam = torch.clamp(c["diameter"][b], min=cellwise.EPS)
            rx, ry = px[:, None] - px[None, :], py[:, None] - py[None, :]
            counted = (rx * rx + ry * ry <= diam * diam) & alive[:, None] & alive[None, :]
            counted.fill_diagonal_(False)
            cand = (px, py, qx, qy) + (tuple(od.sv[b].unbind(-1)) if mode == "b" else ())
            _held_by_visits(visit[b], full[b], counted, ~_finite(px, py), ~_finite(*cand),
                            pair_batch.self_tile(P))
        skipped["dense"] += int((~visit).sum())
    for b in range(B):
        for feat, (halo, _, mode, diam, *_, n_chunks, cs) in cases.window_slabs(c, b):
            visit, full = pair_batch.window_visits(feat[None], diam[None], halo, cs, n_chunks)
            featp = torch.nn.functional.pad(feat, (0, 0, halo, halo))
            k = torch.arange(cs + 2 * halo)
            for ch in range(n_chunks):
                win, sf = featp[ch * cs: ch * cs + cs + 2 * halo], feat[ch * cs: ch * cs + cs]
                rx, ry = sf[:, 0:1] - win[None, :, 0], sf[:, 1:2] - win[None, :, 1]
                dr = win[None, :, 4] - sf[:, 4:5]
                counted = ((rx * rx + ry * ry <= diam * diam) & (sf[:, 5:6] > 0)
                           & (win[None, :, 5] > 0) & (dr >= -1.0) & (dr <= 1.0)
                           & (torch.arange(cs)[:, None] + halo != k[None, :]))
                _held_by_visits(visit[0, ch], full[0, ch], counted, ~_finite(sf[:, 0], sf[:, 1]),
                                ~_finite(*win[:, :4].unbind(-1)),
                                pair_batch.self_tile(feat.shape[0]))
            skipped["window"] += int((~visit).sum())
    if case == "tiles_exact":
        assert skipped["dense"] > 0 and skipped["window"] > 0, skipped


def test_dense_operator_vmap_equals_each_crate_alone():
    """torch.func.vmap of the dense operator's path over the batch case's
    three crates (coefficients of their own), randomness="different" as
    sweep.batched_step runs it: its vmap rule folds the crates into the
    operator's crate axis; each equals the crate alone bit for bit, and so
    does one call of the operator on the whole batch."""
    c = cases.inputs("batch")
    sc = cases.scene(c)
    out = torch.func.vmap(lambda *a: tuple(pair_batch.neighbor_forces_dense(*a, sc)[:6]),
                          randomness="different")(*cases.dense_args(c))
    whole = torch.ops.sand_crate.dense_pairs(*cases.dense_args(c), int(sc.enable_spring))
    for b in range(cases.crates(c)):
        want = pair_batch.dense_pairs_plain(*cases.dense_args(c, b), sc.enable_spring)
        _same_bits(tuple(o[b] for o in out), want, f"vmapped crate {b}")
        _same_bits(tuple(o[b] for o in whole), want, f"operator crate {b}")


def test_dense_operator_vmap_rule_takes_unbatched_operands():
    """The vmap rule expands an operand that is not vmapped (here every one
    but the positions) to every crate."""
    c = cases.inputs("spring")
    sc = cases.scene(c)
    args = cases.dense_args(c, 0)
    stack = torch.stack([args[0], args[0] * 0.98 + 0.01, args[0].flip(0)])
    dims = (0,) + (None,) * (len(args) - 1)
    out = torch.func.vmap(lambda *a: tuple(pair_batch.neighbor_forces_dense(*a, sc)[:6]),
                          in_dims=dims)(stack, *args[1:])
    for b in range(3):
        want = pair_batch.dense_pairs_plain(stack[b], *args[1:], sc.enable_spring)
        _same_bits(tuple(o[b] for o in out), want, f"crate {b}")


def test_window_operator_vmap_equals_each_crate_alone():
    """The window operator's path under torch.func.vmap over the batch
    case's slabs (pass A and pass B, as each crate's chunked sweep calls
    them): one call of the vmap rule, each crate equal to its plain pass
    alone bit for bit."""
    c = cases.inputs("batch")
    per_crate = [cases.window_slabs(c, b) for b in range(cases.crates(c))]
    for p in range(2):  # pass A, pass B
        feats = torch.stack([calls[p][0] for calls in per_crate])
        args = per_crate[0][p][1]
        halo, n_out, mode, *coef, spring, n_chunks, cs = args
        coefs = [torch.stack([calls[p][1][3 + k] for calls in per_crate]) for k in range(4)]
        out = torch.func.vmap(
            lambda f, d, s, t, q: pair_batch.window_pass(f, halo, n_out, mode, d, s, t, q,
                                                         spring, n_chunks, cs),
            randomness="different")(feats, *coefs)
        for b, calls in enumerate(per_crate):
            feat, a = calls[p]
            _same_bits((out[b],), (chunked._pass_scan_plain(feat, *a),), f"pass {mode} crate {b}")


def test_vmapped_entries_equal_each_crate_alone():
    """The tick's entries under torch.func.vmap on the CPU (through the
    operators' vmap rules, each crate's plain version) against each crate
    alone, bit for bit: the batch case's crates, dense and the whole
    chunked sweep (its slabs and loss count vmapped natively)."""
    c = cases.inputs("batch")
    dense, win = cases.vmapped_dense(c), cases.vmapped_chunked(c)
    for b in range(cases.crates(c)):
        alone = pair_batch.neighbor_forces_dense(*cases.dense_args(c, b), cases.scene(c))
        _same_bits(tuple(o[b] for o in dense), alone[:6], f"dense crate {b}")
        alone = cases.chunked_sums(c, b)
        _same_bits(tuple(o[b] for o in win), tuple(alone), f"chunked crate {b}")


def test_batch_slabs_are_each_crates_slabs():
    """cases.batch_slabs (chip_smoke's settled batches) records, under vmap,
    the slabs each crate's sweep hands its window passes."""
    c = cases.inputs("batch")
    per = [cases.sorted_args(c, b) for b in range(cases.crates(c))]
    pos, vel, alive, cid = (torch.stack([p[k] for p in per]) for k in range(4))
    rest = [torch.stack([p[k] for p in per]) for k in (4, 6, 7, 8, 9, 10)]
    args = (pos, vel, alive, cid, rest[0], per[0][5], *rest[1:])
    dims = (0,) * 5 + (None,) + (0,) * 5
    feat_a, feat_b = cases.batch_slabs(args, dims, per[0][-2], per[0][-1])
    s_pos, s_vel, s_alive, s_cid = cases.sorted_batch(c["pos"], c["vel"], c["alive"],
                                                      cases.scene(c))
    assert torch.equal(s_pos, pos) and torch.equal(s_cid, cid) and torch.equal(s_alive, alive)
    for b in range(cases.crates(c)):
        (fa, _), (fb, _) = cases.window_slabs(c, b)
        _same_bits((feat_a[b], feat_b[b]), (fa, fb), f"crate {b}")


def test_window_operator_checks_its_sums():
    c = cases.inputs("spring")
    feat, args = cases.window_slabs(c, 0)[1]
    halo, n_out, mode, d, s, t, q, spring, n_chunks, cs = args
    with pytest.raises(ValueError, match="writes 8 sums, not 6"):
        pair_batch.window_pass(feat, halo, 6, mode, d, s, t, q, spring, n_chunks, cs)


def test_other_devices_raise():
    c = cases.inputs("lone", "meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        pair_batch.neighbor_forces_dense(*cases.dense_args(c, 0), cases.scene(c))
    z = torch.zeros((), device="meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        pair_batch.window_pass(torch.zeros((64, 6), device="meta"), 8, 4, "a", z, z, z, z,
                               False, 2, 32)


def test_tick_routes_through_the_entries(monkeypatch):
    """physics.neighbor_stage reaches the dense entry and the chunked
    backend the window entry (where the card's kernels launch)."""
    import copy

    from sand_crate_tpu_torch import load_config_dict
    from sand_crate_tpu_torch.bench import STIRRING_CUP
    from sand_crate_tpu_torch.engine import Crate

    seen = []
    real_dense, real_window = pair_batch.neighbor_forces_dense, pair_batch.window_pass
    monkeypatch.setattr(pair_batch, "neighbor_forces_dense",
                        lambda *a: seen.append("dense") or real_dense(*a))
    monkeypatch.setattr(pair_batch, "window_pass",
                        lambda *a: seen.append("window_" + a[3]) or real_window(*a))
    world = load_config_dict(copy.deepcopy(STIRRING_CUP)).world_config
    for mode in ("dense", "chunked"):
        crate = Crate(world, device="cpu", forces_mode=mode)
        crate.run(2)
    assert seen == ["dense"] * 2 + ["window_a", "window_b"] * 2


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dense_launched(before: dict) -> dict:
    """``before`` with D1's prologue and each pass launched once more."""
    return {**before, **{k: before[k] + 1 for k in ("dense_order", "dense_a", "dense_b")}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_dense_order_kernel_matches_plain(cuda, case):
    """D1's prologue on every case (all crates at once): the order and the
    sorted fields bit for bit its plain twin's, the tile records equal (a
    box's zero may differ in sign); one launch."""
    c = cases.inputs(case, cuda)
    args = tuple(c[k] for k in ("pos", "vel", "alive", "noise", "diameter"))
    before = dict(pair_batch.LAUNCHES)
    got = pair_batch.dense_order(*args)
    assert pair_batch.LAUNCHES == {**before, "dense_order": before["dense_order"] + 1}
    want = pair_batch.dense_order_plain(*args)
    assert torch.equal(got.order, want.order)
    _same_bits((got.pq, got.sv), (want.pq, want.sv), "sorted fields")
    assert torch.equal(got.tiles[..., 6:], want.tiles[..., 6:])
    boxes = (t.tiles[..., :6].view(torch.float32) for t in (got, want))
    assert torch.equal(*boxes)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_dense_kernel_matches_plain(cuda, case):
    """D1 on every case, crate by crate: one launch of the prologue and of
    each pass, the plain version's counts and NaN places, floats at the
    tolerance."""
    c = cases.inputs(case, cuda)
    sc = cases.scene(c)
    for b in range(cases.crates(c)):
        args = cases.dense_args(c, b)
        before = dict(pair_batch.LAUNCHES)
        got = pair_batch.neighbor_forces_dense(*args, sc)
        assert pair_batch.LAUNCHES == _dense_launched(before)
        ref = cellwise.neighbor_forces_dense(*args, sc)
        cases.assert_sums(_fields(got), _fields(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_window_kernel_matches_plain(cuda, case):
    """D2 on every case through the chunked backend, crate by crate: one
    launch a pass, the plain version's counts, overflow and NaN places,
    floats at the tolerance."""
    c = cases.inputs(case, cuda)
    for b in range(cases.crates(c)):
        before = dict(pair_batch.LAUNCHES)
        got = cases.chunked_sums(c, b)
        assert pair_batch.LAUNCHES == {**before, "window_a": before["window_a"] + 1,
                                       "window_b": before["window_b"] + 1}
        ref = cases.chunked_sums(c, b, chunked._pass_scan_plain)
        cases.assert_sums(_fields(got), _fields(ref))
        assert int(got.overflow) == int(ref.overflow)


@pytest.mark.cuda
def test_dense_kernel_on_a_batch_of_1024(cuda):
    """A random batch of 1024 crates of 640 slots (run_datagen's), 10% dead,
    coefficients of their own: one launch a kernel for the whole batch,
    against the plain version vmapped over the crates."""
    rng = np.random.default_rng(3)
    B, P = 1024, 640
    side = cases.DIAM * np.sqrt(np.pi * P / 8.0)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=cuda)  # noqa: E731
    pos = t(0.1 + rng.random((B, P, 2)) * side)
    vel = t(rng.random((B, P, 2)) - 0.5)
    alive = t(rng.random((B, P)) < 0.9, torch.bool)
    noise = t((rng.random((B, P, 2)) - 0.5) * cases.DIAM * cases.NOISE)
    coefs = [t(np.full(B, v) * (1.0 + 0.2 * rng.random(B))) for v in cases.COEF.values()]
    before = dict(pair_batch.LAUNCHES)
    got = torch.ops.sand_crate.dense_pairs(pos, vel, alive, noise, *coefs, 0)
    assert pair_batch.LAUNCHES == _dense_launched(before)
    ref = torch.func.vmap(lambda *a: pair_batch.dense_pairs_plain(*a, False))(
        pos, vel, alive, noise, *coefs)
    cases.assert_sums(got, ref)


@pytest.mark.cuda
def test_vmapped_dense_launches_once(cuda):
    """torch.func.vmap of the dense entry over the batch case's crates: one
    launch a kernel, each crate bit for bit its kernel run alone."""
    c = cases.inputs("batch", cuda)
    sc = cases.scene(c)
    before = dict(pair_batch.LAUNCHES)
    out = cases.vmapped_dense(c)
    assert pair_batch.LAUNCHES == _dense_launched(before)
    for b in range(cases.crates(c)):
        alone = pair_batch.neighbor_forces_dense(*cases.dense_args(c, b), sc)
        _same_bits(tuple(o[b] for o in out), alone[:6], f"crate {b}")


@pytest.mark.cuda
def test_vmapped_window_launches_once(cuda):
    """torch.func.vmap of the chunked backend over the batch case's crates
    (sorted operands): one launch a pass, each crate bit for bit its kernel
    run alone."""
    c = cases.inputs("batch", cuda)
    before = dict(pair_batch.LAUNCHES)
    out = cases.vmapped_chunked(c)
    assert pair_batch.LAUNCHES == {**before, "window_a": before["window_a"] + 1,
                                   "window_b": before["window_b"] + 1}
    for b in range(cases.crates(c)):
        alone = cases.chunked_sums(c, b)
        _same_bits(tuple(o[b] for o in out), tuple(alone), f"crate {b}")
