"""Hard inputs for holding the batched pair kernels against their plain
versions.

D1 (``dense_pass_kernel``, ``csrc/pair_batch.cu``) sums every pair of a
crate; its plain version is ``cellwise.neighbor_forces_dense``.  D2
(``window_pass_kernel``) sums each cell-sorted self chunk against its fixed
window of the feature slab; its plain version is
``ops/chunked.py::_pass_scan_plain``, reached through
``neighbor_forces_chunked(_sorted)``.  Each case below puts particles where
a mask, a clamp, a NaN, a window edge or the launch shape has an edge:

* ``exact``: a pair exactly one diameter apart (d2 == diam^2, counted) and
  a pair one f32 ulp further (not counted);
* ``coincident``: two pairs of alive particles at one position, noise 0
  (the EPS floor of the distance);
* ``nan_pos`` / ``nan_vel``: a dead slot at a NaN position, or with a NaN
  velocity, as ``physics.cull_particles`` leaves a non-finite particle.
  As in the JAX package's compiled step, the masked weights, terms and
  (D2) neighbour velocities are selected, so ``p_i`` stays finite; the
  terms times the direction to the NaN slot are 0 * NaN, so every self's
  dense ``s`` and pass B sums are NaN, and so is every dense ``visc_vsum``
  with a NaN velocity (the compiled step multiplies it by the mask);
* ``all_dead``, ``lone``: no alive particle, one alive particle;
* ``p1000``, ``p4096``: clouds of 1000 and 4096 slots (4096: auto's top
  dense capacity, more than one self tile and two staged candidate tiles);
* ``spring``: pass B with the spring's sums;
* ``batch``: three crates with coefficients (diameter included) of their
  own, for the operators' crate axis and vmap rules;
* ``halo_row``: one dense grid row, wider than the chunk windows, so D2
  loses pairs (counted into the overflow alike);
* ``live_rows``: a sweep bound that skips the last chunk (its rows zeros);
* ``tiles_exact``: two crates of 1000 slots with diameters of their own,
  their particles in clusters several diameters apart (so the kernels skip
  most candidate tiles), and in each a pair exactly one diameter apart and
  a pair one f32 ulp further, each pair split across two sorted tiles, and
  three lines that fill the first three sorted tiles: the first two
  exactly one diameter apart (their boxes' gap is the diameter: the tile
  pair must be visited), the third an ulp further (skipped);
* ``nan_far``: 1000 slots in lines of 32, three grid rows apart (every line
  one sorted tile, every other tile out of reach), and two dead slots, one
  at a NaN position and one with an infinite velocity, whose tile every
  self tile must visit for the NaN places only.

Inputs are made from a numpy seed.  ``tests/test_torch_pair_batch.py`` and
``chip_smoke.py`` run every case, and :func:`facts` checks that each holds
what it claims.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from .. import cellwise
from . import chunked, pair_batch

DIAM = 2.0 ** -6  # a diameter whose multiples near 0.5 are exact in f32
COEF = dict(diameter=DIAM, surface_smoothing=100.0, target_pressure=-2.0,
            ignored_pressure=0.3, spring_overlap_balance=0.5)
NOISE = 0.1  # collider_noise_level: jitter amplitude over the diameter
TICK = 7  # the tick D2's hashed jitter is drawn for
TOL = 1e-5  # tests/test_torch_dense_chunked.py::_assert_sums
FIELDS = ("p_i", "dv_tension", "pressure_real", "spring_real", "visc_vsum", "nbr_cnt")
# D2 geometry per case: chunk size, halo, sweep bound
SMALL = dict(cs=32, halo=128, live_rows=None)

CASES = ("exact", "coincident", "nan_pos", "nan_vel", "all_dead", "lone", "p1000", "p4096",
         "spring", "batch", "halo_row", "live_rows", "tiles_exact", "nan_far")
# tiles_exact: the crates' diameters, the pairs' midpoints (a pair one
# diameter apart vertically at EXACT_AT, one an ulp further at ULP_AT) and the
# clusters' lattice (CLUSTERS columns x rows, CLUSTER_STEP diameters apart,
# CLUSTER_N particles within CLUSTER_R diameters of each centre)
TILE_DIAMS = (DIAM, 0.75 * DIAM)
EXACT_AT, ULP_AT = (0.5, 0.25), (0.25, 0.3125)
CLUSTERS, CLUSTER_STEP, CLUSTER_N, CLUSTER_R = (6, 5), 5.0, 28, 1.6
# and below them three lines of a tile's particles each (the first three
# sorted tiles), from LINE_AT up: the second exactly one diameter above the
# first (their tiles' box gap is exactly one diameter), the third one ulp
# past one diameter above the second
LINE_AT = (0.3, 0.03125)
# nan_far: lines of a tile's particles LINE_STEP diameters apart, LINE_GAP
# grid rows between lines, at half the usual diameter; its two bad slots
LINE_STEP, LINE_GAP, FAR_DIAM = 0.55, 3, DIAM / 2
NAN_SLOT, INF_SLOT = 17, 500


def _cloud(rng, P, lo=0.1, alive=1.0):
    """P slots in a square holding ~8 neighbours a particle."""
    side = DIAM * math.sqrt(math.pi * P / 8.0)
    return dict(pos=lo + rng.random((P, 2)) * side, vel=(rng.random((P, 2)) - 0.5) * 2.0,
                alive=rng.random(P) < alive,
                noise=(rng.random((P, 2)) - 0.5) * DIAM * NOISE)


def _case(name: str) -> dict:
    rng = np.random.default_rng(CASES.index(name) + 11)
    geo = dict(SMALL)
    spring = False
    if name == "exact":
        c = _cloud(rng, 60)
        far = np.float32(0.25 + DIAM)
        special = np.array([[0.5, 0.9], [0.5 + DIAM, 0.9],
                            [0.25, 0.8], [np.nextafter(far, np.float32(1.0)), 0.8]])
        c["pos"] = np.concatenate([c["pos"], special])
        c["vel"] = np.concatenate([c["vel"], rng.random((4, 2)) - 0.5])
        c["alive"] = np.concatenate([c["alive"], np.ones(4, bool)])
        c["noise"] = np.concatenate([c["noise"], (rng.random((4, 2)) - 0.5) * DIAM * NOISE])
    elif name == "coincident":
        c = _cloud(rng, 64)
        c["pos"][1] = c["pos"][0]
        c["pos"][3] = c["pos"][2]
        c["noise"][:] = 0.0
    elif name in ("nan_pos", "nan_vel"):
        c = _cloud(rng, 64, alive=0.8)
        c["alive"][40] = False
        c["pos" if name == "nan_pos" else "vel"][40] = np.nan
    elif name == "all_dead":
        c = _cloud(rng, 64, alive=0.0)
    elif name == "lone":
        c = _cloud(rng, 64, alive=0.0)
        c["alive"][17] = True
    elif name == "p1000":
        c = _cloud(rng, 1000, alive=0.95)
        geo = dict(cs=128, halo=128, live_rows=None)
    elif name == "p4096":
        c = _cloud(rng, 4096, alive=0.95)
        geo = dict(cs=256, halo=384, live_rows=None)
    elif name == "spring":
        c = _cloud(rng, 200, alive=0.9)
        spring = True
    elif name == "batch":
        crates = [_cloud(rng, 200, alive=0.9) for _ in range(3)]
        c = {k: np.stack([x[k] for x in crates]) for k in crates[0]}
        coef = dict(diameter=DIAM * np.array([1.0, 0.75, 1.25]),
                    surface_smoothing=np.array([100.0, 50.0, 150.0]),
                    target_pressure=np.array([-2.0, -1.0, -3.0]),
                    ignored_pressure=np.array([0.3, 0.1, 0.5]),
                    spring_overlap_balance=np.array([0.5, 0.3, 0.7]))
        return _finish(c, coef, geo, spring=True)
    elif name == "halo_row":  # 512 in one grid row, ~64 a cell: past the halo of 64
        P = 512
        x = rng.random(P) * 8 * DIAM + 0.3
        y = (rng.random(P) * 0.5 + 0.5) * DIAM + 0.5
        c = dict(pos=np.stack([x, y], -1), vel=rng.random((P, 2)) - 0.5, alive=np.ones(P, bool),
                 noise=(rng.random((P, 2)) - 0.5) * DIAM * NOISE)
        geo = dict(cs=128, halo=64, live_rows=None)
    elif name == "live_rows":  # 300 alive of 512: 3 of 4 chunks of 128 swept
        c = _cloud(rng, 512)
        c["alive"][:] = np.arange(512) < 300
        geo = dict(cs=128, halo=128, live_rows=300)
    elif name == "tiles_exact":
        crates = [_clusters(rng, d) for d in TILE_DIAMS]
        c = {k: np.stack([x[k] for x in crates]) for k in crates[0]}
        coef = {k: np.full(2, v) for k, v in COEF.items()}
        coef["diameter"] = np.array(TILE_DIAMS)
        return _finish(c, coef, dict(cs=128, halo=256, live_rows=None), spring=False)
    elif name == "nan_far":
        c = _lines(rng)
        coef = dict(COEF, diameter=FAR_DIAM)
        c = {k: v[None] for k, v in c.items()}
        return _finish(c, {k: np.array([v]) for k, v in coef.items()},
                       dict(cs=128, halo=128, live_rows=None), spring=False)
    else:
        raise KeyError(name)
    c = {k: v[None] for k, v in c.items()}
    return _finish(c, {k: np.array([v]) for k, v in COEF.items()}, geo, spring)


def _clusters(rng, d: float, P: int = 1000) -> dict:
    """tiles_exact's crate at diameter ``d``: clusters on a lattice right of
    the two pairs, the pairs, then dead slots up to ``P``, shuffled."""
    nx, ny = CLUSTERS
    # cluster rows through the pairs' grid rows, so that each pair's two
    # particles sort a cluster row's width apart
    centres = [(0.56 + CLUSTER_STEP * d * i + CLUSTER_R * d,
                EXACT_AT[1] + CLUSTER_STEP * d * (j - 2)) for j in range(ny) for i in range(nx)]
    pts = []
    for cx, cy in centres:
        r = CLUSTER_R * d * np.sqrt(rng.random(CLUSTER_N))
        a = rng.random(CLUSTER_N) * 2 * np.pi
        pts.append(np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], -1))
    # each pair straddles a grid row boundary (half a diameter either side
    # of its point), in the crate's own cells and in the slab's
    far = np.float32(ULP_AT[1] + d / 2)
    pairs = np.array([(EXACT_AT[0], EXACT_AT[1] - d / 2), (EXACT_AT[0], EXACT_AT[1] + d / 2),
                      (ULP_AT[0], ULP_AT[1] - d / 2),
                      (ULP_AT[0], np.nextafter(far, np.float32(1.0)))])
    x0, y0 = LINE_AT
    y1 = np.float32(y0 + d)
    ys = (y0, y1, np.nextafter(np.float32(y1 + d), np.float32(1.0)))
    per = pair_batch.TILE
    lines = [np.stack([x0 + 0.5 * d * np.arange(per), np.full(per, y)], -1) for y in ys]
    alive_pos = np.concatenate(lines + pts + [pairs])
    n = alive_pos.shape[0]
    pos = np.concatenate([alive_pos, 0.05 + rng.random((P - n, 2)) * 0.04])
    alive = np.arange(P) < n
    perm = rng.permutation(P)
    return dict(pos=pos[perm], vel=(rng.random((P, 2)) - 0.5)[perm], alive=alive[perm],
                noise=((rng.random((P, 2)) - 0.5) * d * NOISE)[perm])


def _lines(rng, P: int = 1000) -> dict:
    """nan_far's crate: lines of a tile's alive particles, each in one grid
    row, LINE_GAP rows apart, and two dead slots, at NAN_SLOT a NaN
    position and at INF_SLOT an infinite velocity; the other rows go to
    shuffled slots."""
    d = FAR_DIAM
    n = P - 2
    k = np.arange(n)
    line, at = k // pair_batch.TILE, k % pair_batch.TILE
    x = (8 + LINE_STEP * at) * d + (rng.random(n) - 0.5) * 0.1 * d
    y = (8.5 + LINE_GAP * line) * d + (rng.random(n) - 0.5) * 0.6 * d
    rows = dict(pos=np.concatenate([np.stack([x, y], -1), [[0.9, 0.9], [0.9, 0.95]]]),
                vel=np.concatenate([rng.random((n, 2)) - 0.5, [[0.1, 0.2], [0.3, 0.4]]]),
                alive=np.arange(P) < n, noise=(rng.random((P, 2)) - 0.5) * d * NOISE)
    rest = rng.permutation(np.setdiff1d(np.arange(P), [NAN_SLOT, INF_SLOT]))
    slot = np.concatenate([rest, [NAN_SLOT, INF_SLOT]])  # row r goes to slot[r]
    out = {}
    for key, v in rows.items():
        out[key] = np.empty_like(v)
        out[key][slot] = v
    out["pos"][NAN_SLOT] = np.nan
    out["vel"][INF_SLOT] = np.inf
    return out


def _finish(c, coef, geo, spring):
    cell = float(np.max(coef["diameter"]))  # cells at least a diameter wide
    n = int(math.ceil(1.0 / cell)) + 2
    return dict(c, **coef, spring=spring, cell=cell, grid=n, **geo)


def inputs(name: str, device="cpu") -> dict:
    """The case's tensors on ``device``, each with a leading crate axis B
    (1 but for ``batch``): pos, vel, noise (B, P, 2) f32, alive (B, P)
    bool, the coefficients (B,) f32; and its scene's numbers."""
    c = _case(name)
    out = {}
    for k, v in c.items():
        if isinstance(v, np.ndarray):
            dtype = torch.bool if v.dtype == bool else torch.float32
            v = torch.as_tensor(v.astype(bool if dtype == torch.bool else np.float32),
                                device=device)
        out[k] = v
    out["noise_amp"] = out["diameter"] * (0.0 if name == "coincident" else NOISE)
    return out


def crates(c: dict) -> int:
    return int(c["pos"].shape[0])


def scene(c: dict):
    """The scene numbers the dense and chunked functions read (both
    packages)."""
    return types.SimpleNamespace(grid_nx=c["grid"], grid_ny=c["grid"], cell_size=c["cell"],
                                 chunk_cs=c["cs"], chunk_halo=c["halo"],
                                 enable_spring=c["spring"])


def dense_args(c: dict, b: int | None = None) -> tuple:
    """The operands of ``neighbor_forces_dense`` but the scene: the whole
    batch (the operator's, crate axis first) or crate ``b``."""
    keys = ("pos", "vel", "alive", "noise") + pair_batch.DENSE_COEFS
    return tuple(c[k] if b is None else c[k][b] for k in keys)


def sorted_args(c: dict, b: int) -> tuple:
    """Crate ``b``'s operands of ``neighbor_forces_chunked_sorted``, cell
    sorted as ``neighbor_forces_chunked`` sorts them (scene, live_rows
    last)."""
    sc = scene(c)
    cid = cellwise.cell_ids_grid(c["pos"][b], c["alive"][b], sc)
    sorted_cid, order = torch.sort(cid, stable=True)
    tick = torch.tensor(TICK, dtype=torch.int32, device=c["pos"].device)
    return (c["pos"][b][order], c["vel"][b][order], c["alive"][b][order], sorted_cid,
            c["noise_amp"][b], tick, *(c[k][b] for k in pair_batch.DENSE_COEFS), sc,
            c["live_rows"])


def chunked_sums(c: dict, b: int, window_pass=None):
    """Crate ``b``'s chunked pair sums in sorted order, with
    ``pair_batch.window_pass`` (the device's dispatch) or ``window_pass``
    in its place (e.g. ``chunked._pass_scan_plain``)."""
    *args, live_rows = sorted_args(c, b)
    if window_pass is None:
        return chunked.neighbor_forces_chunked_sorted(*args, live_rows=live_rows)
    real = pair_batch.window_pass
    pair_batch.window_pass = window_pass
    try:
        return chunked.neighbor_forces_chunked_sorted(*args, live_rows=live_rows)
    finally:
        pair_batch.window_pass = real


def window_slabs(c: dict, b: int) -> list:
    """Crate ``b``'s two window passes as they are called: [(feat, args)]
    for pass A and pass B (pass B's slab from the plain pass A), args
    those of ``_pass_scan_plain`` after the slab."""
    calls = []

    def record(feat, *args):
        calls.append((feat, args))
        return chunked._pass_scan_plain(feat, *args)

    chunked_sums(c, b, record)
    return calls


def vmapped_dense(c: dict) -> tuple:
    """``torch.func.vmap`` of ``pair_batch.neighbor_forces_dense`` over the
    case's crates, as ``sweep.batched_step`` runs the tick -> its first six
    fields, each with the crate axis."""
    sc = scene(c)
    return torch.func.vmap(lambda *a: tuple(pair_batch.neighbor_forces_dense(*a, sc)[:6]),
                           randomness="different")(*dense_args(c))


def vmapped_chunked(c: dict) -> tuple:
    """``torch.func.vmap`` of ``neighbor_forces_chunked_sorted`` over the
    case's crates (each sorted as :func:`sorted_args` sorts it, the tick
    shared) -> every PairSums field with the crate axis."""
    per = [sorted_args(c, b) for b in range(crates(c))]
    sc, live_rows = per[0][-2:]
    stacked = [torch.stack([p[k] for p in per]) for k in range(len(per[0]) - 2)]
    dims = [0] * len(stacked)
    dims[5], stacked[5] = None, per[0][5]  # the tick
    return torch.func.vmap(
        lambda *a: tuple(chunked.neighbor_forces_chunked_sorted(*a, sc, live_rows=live_rows)),
        in_dims=tuple(dims), randomness="different")(*stacked)


def sorted_batch(pos, vel, alive, sc):
    """A batch's (B, P) particles in each crate's stable cell order ->
    (pos, vel, alive, sorted_cid), as the sorted backends' tick sorts."""
    cid = torch.func.vmap(lambda p, a: cellwise.cell_ids_grid(p, a, sc))(pos, alive)
    sorted_cid, order = torch.sort(cid, dim=1, stable=True)
    return (torch.take_along_dim(pos, order[..., None], dim=1),
            torch.take_along_dim(vel, order[..., None], dim=1),
            torch.take_along_dim(alive, order, dim=1), sorted_cid)


def batch_slabs(args, dims, sc, live_rows) -> tuple:
    """The (B, p_pad, F) slabs that a vmapped chunked sweep over ``args``
    (``neighbor_forces_chunked_sorted``'s operands before the scene,
    vmapped over ``dims``) hands its two window passes, pass B's from the
    plain pass A: (feat_a, feat_b)."""
    def run(*a):
        calls = []

        def record(feat, *rest):
            calls.append(feat)
            return chunked._pass_scan_plain(feat, *rest)

        real = pair_batch.window_pass
        pair_batch.window_pass = record
        try:
            chunked.neighbor_forces_chunked_sorted(*a, sc, live_rows=live_rows)
        finally:
            pair_batch.window_pass = real
        return tuple(calls)

    return torch.func.vmap(run, in_dims=dims, randomness="different")(*args)


def assert_sums(got, ref, names=FIELDS, tol=TOL) -> float:
    """``got`` against ``ref`` (tuples of tensors in ``names``' order):
    ``nbr_cnt`` bit for bit; every float field NaN and infinite in the same
    places, its finite entries within ``tol`` relative plus ``tol`` of the
    field's largest finite magnitude.  Returns the largest absolute
    difference; raises AssertionError naming the first field that fails."""
    worst = 0.0
    for name, a, r in zip(names, got, ref):
        if a.shape != r.shape or a.dtype != r.dtype:
            raise AssertionError(f"{name}: {a.dtype} {tuple(a.shape)} != "
                                 f"{r.dtype} {tuple(r.shape)}")
        a, r = a.double(), r.double()
        if name == "nbr_cnt":
            if not torch.equal(a, r):
                raise AssertionError(f"nbr_cnt differs at {int((a != r).sum())} slots")
            continue
        for what, fn in (("NaN", torch.isnan), ("inf", torch.isinf)):
            if not torch.equal(fn(a), fn(r)):
                raise AssertionError(f"{name}: {what} places differ "
                                     f"({int(fn(a).sum())} against {int(fn(r).sum())})")
        fin = torch.isfinite(r)
        if not bool(fin.any()):
            continue
        if not torch.equal(a[torch.isinf(r)], r[torch.isinf(r)]):
            raise AssertionError(f"{name}: infinities of other signs")
        a, r = a[fin], r[fin]
        err = (a - r).abs()
        limit = tol * r.abs() + tol * float(r.abs().max())
        if bool((err > limit).any()):
            k = int(torch.argmax(err - limit))
            raise AssertionError(f"{name}: {float(a[k])} against {float(r[k])} (|diff| "
                                 f"{float(err[k]):.3e} > {float(limit[k]):.3e})")
        worst = max(worst, float(err.max()))
    return worst


def facts(name: str) -> dict:
    """What the case claims, each True, from the plain versions on the CPU."""
    c = inputs(name)
    B = crates(c)
    dense = [pair_batch.dense_pairs_plain(*dense_args(c, b), c["spring"]) for b in range(B)]
    win = [chunked_sums(c, b, chunked._pass_scan_plain) for b in range(B)]
    p_i, dv, pr, sp, vs, cnt = dense[0]
    alive = c["alive"][0]
    out = {"finite inputs but the case's NaN": bool(
        torch.isfinite(c["pos"][c["alive"]]).all() and torch.isfinite(c["vel"][c["alive"]]).all())}
    if name == "exact":
        d2 = (c["pos"][0, 61] - c["pos"][0, 60]).pow(2).sum()
        diam2 = torch.tensor(DIAM, dtype=torch.float32) ** 2
        out["a pair at exactly one diameter (d2 == diam^2)"] = bool(d2 == diam2)
        out["it counts, alone"] = cnt[60:62].tolist() == [1.0, 1.0]
        out["one ulp further does not"] = cnt[62:64].tolist() == [0.0, 0.0]
        out["the same in the windows"] = sorted(win[0].nbr_cnt.tolist()) == sorted(cnt.tolist())
    elif name == "coincident":
        out["two coincident alive pairs, no noise"] = bool(
            torch.equal(c["pos"][0, 0], c["pos"][0, 1]) and not c["noise"].any()
            and float(c["noise_amp"][0]) == 0.0)
        out["each counts the other"] = bool((cnt[:4] >= 1).all())
        out["finite sums"] = all(bool(torch.isfinite(x).all()) for x in dense[0] + tuple(win[0]))
    elif name == "nan_pos":
        has = alive & (cnt > 0)
        out["a dead slot at a NaN position"] = bool(
            not alive[40] and torch.isnan(c["pos"][0, 40]).all())
        out["p_i finite (the masked weight selected)"] = bool(
            has.any() and torch.isfinite(p_i).all())
        out["every dv_tension NaN (0 * NaN through the direction)"] = bool(
            torch.isnan(dv).all())
        out["the windows that read it: NaN"] = bool(torch.isnan(win[0].dv_tension).any())
    elif name == "nan_vel":
        out["a dead slot with a NaN velocity"] = bool(
            not alive[40] and torch.isnan(c["vel"][0, 40]).all())
        out["every visc_vsum NaN"] = bool(torch.isnan(vs).all())
        out["p_i finite"] = bool(torch.isfinite(p_i).all())
        out["the windows select it out: finite"] = bool(torch.isfinite(win[0].visc_vsum).all())
    elif name == "all_dead":
        out["no alive slot"] = not bool(alive.any())
        out["every sum zero"] = all(not bool(x.any()) for x in dense[0] + tuple(win[0][:6]))
    elif name == "lone":
        out["one alive slot"] = int(alive.sum()) == 1
        out["no neighbour"] = not bool(cnt.any()) and not bool(win[0].nbr_cnt.any())
    elif name in ("p1000", "p4096"):
        P = 1000 if name == "p1000" else 4096
        out[f"{P} slots"] = c["pos"].shape[1] == P
        out["~8 neighbours"] = 4.0 <= float(cnt[alive].mean()) <= 12.0
        out["the windows lose nothing"] = int(win[0].overflow) == 0
        out["the same counts in the windows"] = bool(
            torch.equal(win[0].nbr_cnt.sort().values, cnt.sort().values))
    elif name == "spring":
        out["spring sums"] = bool(sp.abs().max() > 0) and bool(win[0].spring_real.abs().max() > 0)
    elif name == "batch":
        out["three crates"] = B == 3
        out["coefficients of their own"] = len(set(c["diameter"].tolist())) == 3
        out["the spring on"] = c["spring"] and bool(dense[2][3].abs().max() > 0)
        out["no window loss"] = all(int(w.overflow) == 0 for w in win)
    elif name == "halo_row":
        out["one grid row"] = len(set(torch.floor(c["pos"][0, :, 1] / c["cell"]).tolist())) == 1
        out["the windows lose pairs, counted"] = int(win[0].overflow) > 0
        out["fewer pairs than dense"] = float(win[0].nbr_cnt.sum()) < float(cnt.sum())
    elif name == "tiles_exact":
        out["two crates, diameters of their own"] = B == 2 and len(set(c["diameter"].tolist())) == 2
        for b in range(B):
            pos, alive, diam = c["pos"][b], c["alive"][b], c["diameter"][b]
            cnt = dense[b][5]
            pairs = [torch.nonzero(alive & (pos[:, 0] == x)).flatten() for x in (0.5, 0.25)]
            d2 = [(pos[i[0]] - pos[i[1]]).pow(2).sum() for i in pairs]
            out[f"crate {b}: a pair at exactly one diameter"] = bool(d2[0] == diam * diam)
            out[f"crate {b}: it counts, alone"] = cnt[pairs[0]].tolist() == [1.0, 1.0]
            out[f"crate {b}: one ulp further does not"] = (
                bool(d2[1] > diam * diam) and cnt[pairs[1]].tolist() == [0.0, 0.0])
            od = pair_batch.dense_order_plain(*(c[k][b:b + 1] for k in (
                "pos", "vel", "alive", "noise", "diameter")))
            at = torch.argsort(od.order[0])  # each slot's sorted index
            out[f"crate {b}: each pair split across two sorted tiles"] = all(
                int(at[i[0]]) // pair_batch.TILE != int(at[i[1]]) // pair_batch.TILE
                for i in pairs)
            slab = sorted_args(c, b)[0][:, 0]
            out[f"crate {b}: and across two slab tiles"] = all(
                len({int(r) // pair_batch.TILE for r in torch.nonzero(slab == x).flatten()}) == 2
                for x in (0.5, 0.25))
            visit, _ = pair_batch.dense_visits(od, c["diameter"][b:b + 1], "a")
            out[f"crate {b}: most candidate tiles skipped"] = float(visit.float().mean()) < 0.5
            lines = od.pq[0, :3 * pair_batch.TILE, 1].reshape(3, pair_batch.TILE)
            out[f"crate {b}: three lines, one a sorted tile"] = bool(
                (lines == lines[:, :1]).all() and (lines[1:, 0] > lines[:-1, 0]).all())
            xs = od.pq[0, :2 * pair_batch.TILE, 0].reshape(2, pair_batch.TILE).sort(-1).values
            gap = lines[1, 0] - lines[0, 0]
            out[f"crate {b}: lines 0, 1 exactly one diameter apart, visited"] = bool(
                torch.equal(xs[0], xs[1]) and gap * gap == diam * diam
                and visit[0, 0, 1] and visit[0, 1, 0])
            out[f"crate {b}: lines 1, 2 an ulp further, skipped"] = bool(
                lines[2, 0] - lines[1, 0] > diam and not visit[0, 1, 2] and not visit[0, 2, 1])
        out["the windows lose nothing"] = all(int(w.overflow) == 0 for w in win)
        out["the same counts in the windows"] = all(
            torch.equal(w.nbr_cnt.sort().values, d[5].sort().values) for w, d in zip(win, dense))
    elif name == "nan_far":
        pos, vel = c["pos"][0], c["vel"][0]
        out["a dead slot at a NaN position"] = bool(
            not alive[NAN_SLOT] and torch.isnan(pos[NAN_SLOT]).all())
        out["a dead slot with an infinite velocity"] = bool(
            not alive[INF_SLOT] and torch.isinf(vel[INF_SLOT]).all())
        args = {k: c[k][:1] for k in ("pos", "vel", "alive", "noise", "diameter")}
        clean = dict(args, pos=torch.nan_to_num(args["pos"], nan=0.9),
                     vel=torch.nan_to_num(args["vel"], posinf=0.0))
        for label, a in (("without the flag", clean), ("with it", args)):
            od = pair_batch.dense_order_plain(*a.values())
            at = torch.argsort(od.order[0])
            bad = int(at[NAN_SLOT]) // pair_batch.TILE
            out[f"{label}: both bad slots in one tile"] = (
                bad == int(at[INF_SLOT]) // pair_batch.TILE)
            visit, full = pair_batch.dense_visits(od, a["diameter"], "b")
            others = [t for t in range(visit.shape[1]) if t != bad]
            if a is clean:
                out["without the flag, every other tile skips theirs"] = not bool(
                    visit[0, others, bad].any())
                out["and every line tile every other line tile"] = bool(
                    (visit[0] == torch.eye(visit.shape[1], dtype=torch.bool)).all())
            else:
                out["with it, every tile visits theirs, pair by pair"] = bool(full[0, :, bad].all())
        out["every dense dv_tension and visc_vsum NaN"] = bool(
            torch.isnan(dv).all() and torch.isnan(vs).all())
        out["p_i finite"] = bool(torch.isfinite(p_i).all())
        nan_win = torch.isnan(win[0].dv_tension).any(-1)
        out["the windows that read it: NaN, the others finite"] = bool(
            nan_win.any() and not nan_win.all())
        out["the windows lose nothing"] = int(win[0].overflow) == 0
    elif name == "live_rows":
        p_pad = -(-c["pos"].shape[1] // c["cs"]) * c["cs"]
        n = chunked.live_chunks(c["live_rows"], p_pad, c["cs"])
        out["3 of 4 chunks swept"] = (n, p_pad // c["cs"]) == (3, 4)
        out["nothing lost"] = int(win[0].overflow) == 0
        out["the same counts as dense"] = bool(
            torch.equal(win[0].nbr_cnt.sort().values, cnt.sort().values))
    return out
