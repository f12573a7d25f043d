"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure raises and exits non-zero before the last line):

1. card: require CUDA; print the card's name and power limit (nvidia-smi).
2. build: compile the hand-written CUDA kernels (csrc/pmajor.cu) with nvcc.
3. world: the dam break (a dict equal to configs/dam_break.yaml) rescaled
   as bench.py rescales it, to 1,000,000 target particles (1,001,700 alive).
4. kernels: after SETTLE_TICKS ticks, both pair-pass kernels (pass A, and
   pass B folded and split) against their plain torch versions on the same
   device inputs: max abs/rel error per output row, neighbor counts exact,
   and the median times of both from CUDA events.  Then an independent
   check of both passes at that state: for a random sample of selves, the
   sums over every particle of the world within one diameter (brute force,
   no cell grid or candidate ranges), in float64.
5. main path: Crate.run for MAIN_TICKS ticks; the kernel launch counters
   must rise by one per pass per tick; no non-finite values, no overflow,
   the alive count conserved (closed box, no sources), uids a permutation,
   and no blow-up (speed bounds below).  Prints steps/s and the step p50
   with the card name.
6. trajectory: a ~10k-particle dam break for 20 ticks on the card, once on
   the kernel path and once with both pair passes swapped for their plain
   torch versions, compared uid-aligned at tests/test_pmajor.py:371-374's
   tolerance.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Imports neither JAX nor sand_crate_tpu.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

# configs/dam_break.yaml as a dict (PyYAML need not be installed);
# tests/test_torch_scene.py holds the two equal.
DAM_BREAK = {
    "playback": {
        "save_recording": False,
        "ticks_to_record": 600,
        "recording_output_dir_path": "data/recordings",
        "screen_x": 1000,
        "screen_y": 1000,
    },
    "world": {
        "coefficients": {
            "dt": 0.002,
            "particle_radius": 0.0015,
            "wall_collision_decay": 0.2,
            "spring_overlap_balance": 0.5,
            "spring_amplifier": 100,
            "pressure_amplifier": 30,
            "ignored_pressure": 0.3,
            "collider_noise_level": 0.1,
            "viscosity": 8,
            "max_particles": 100000,
            "surface_smoothing": 100,
            "target_pressure": -2,
            "gravity": [0, 9.8],
        },
        "particle_sources": [],
        "initial_particles": [
            {
                "block": {
                    "x0": 0.02,
                    "y0": 0.1,
                    "x1": 0.42,
                    "y1": 0.98,
                    "spacing": 0.00265,
                    "velocity": [0.0, 0.0],
                    "jitter": 0.2,
                }
            }
        ],
        "rigid_bodies": [
            {
                "fixed": {
                    "name": "box",
                    "segments": [
                        [[0.0, 0.0], [0.0, 1.0]],
                        [[0.0, 0.0], [1.0, 0.0]],
                        [[1.0, 0.0], [1.0, 1.0]],
                        [[0.0, 1.0], [1.0, 1.0]],
                    ],
                }
            }
        ],
    },
}

N_TARGET = 1_000_000  # bench.py's default size: 1,001,700 alive, capacity 1,050,112
SETTLE_TICKS = 50
MAIN_TICKS = 200
P50_TICKS = 30
TRAJ_PARTICLES = 10_000
TRAJ_TICKS = 20
# Kernel vs plain version, same inputs: both perform the same IEEE f32
# operations in the same order (csrc/pmajor.cu), so they are expected to
# agree bit for bit; the check allows 1e-4 of each row's largest magnitude,
# the error of a reordered f32 sum over up to a few hundred pair terms.
REL_TOL = 1e-4
# Brute-force reference: selves sampled, and the f32 kernel held against a
# float64 sum of the same pair terms (the error of an f32 sum of a few
# hundred terms is well under REL_TOL of the row's largest magnitude).
BRUTE_SAMPLE = 4096
BRUTE_CHUNK = 64
# Blow-up bounds after the main path's ticks.  FREE_FALL is the speed of a
# fall from the box's full height, sqrt(2 * 9.8 * 1.0); the bulk (the 99th
# speed percentile) stays below twice it.  Runaways (faster than
# RUNAWAY_SPEED, a fifth of the box per tick) stay below RUNAWAY_SHARE of
# the particles.
FREE_FALL = math.sqrt(2 * 9.8 * 1.0)
RUNAWAY_SPEED = 100.0
RUNAWAY_SHARE = 1e-3
SOURCE = "sand_crate_tpu_torch/csrc/pmajor.cu"
REPLACES = "sand_crate_tpu/ops/pmajor.py:183"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def dam_break_world(n_target: int):
    """bench.py's dam_break_world, on the port's config parser."""
    from sand_crate_tpu_torch import load_config_dict

    w = load_config_dict(copy.deepcopy(DAM_BREAK)).world_config
    area = (0.42 - 0.02) * (0.98 - 0.10)
    spacing = math.sqrt(area / n_target)
    w.initial_particles[0].spacing = spacing
    w.coefficients["particle_radius"] = spacing * 0.55
    w.coefficients["max_particles"] = int(n_target * 1.05)
    return w


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events),
    after one warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def compare(label, got, ref, exact_rows=()):
    """Per-row max abs / rel error of a kernel output against its plain
    version; raises past REL_TOL (or any difference in ``exact_rows``)."""
    worst = 0.0
    for k in range(ref.shape[0]):
        err = float((got[k] - ref[k]).abs().max())
        scale = max(float(ref[k].abs().max()), 1.0)
        print(f"  {label} row {k}: max_abs_err {err:.3e} max_rel_err {err / scale:.3e}")
        if k in exact_rows:
            check(err == 0.0, f"{label} row {k} (neighbor count) differs")
        check(err <= REL_TOL * scale, f"{label} row {k} error {err} > {REL_TOL} * {scale}")
        worst = max(worst, err)
    return worst


def kernels_vs_plain(crate):
    """Phase 4: both passes' kernels against their plain versions at the
    crate's current (settled) state, in the step's sorted order."""
    import torch

    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops import pmajor

    st, sc, pr = crate.state, crate.scene, crate.params
    sorted_cid, order = torch.sort(cell_ids_grid(st.pos, st.alive, sc), stable=True)
    slab_a, ranges = pmajor.pass_a_inputs(
        st.pos[order], st.vel[order], st.alive[order], sorted_cid,
        pr.diameter * pr.collider_noise_level, st.tick, sc,
    )
    coef = pmajor.coef_stack(pr.diameter, pr.target_pressure, pr.spring_overlap_balance)
    symm = sc.pmajor_symm
    spans = (ranges[3:] - ranges[:3]).sum(dim=0)[st.alive[order]].float()
    print(f"  candidates per alive particle: mean {float(spans.mean()):.2f} "
          f"max {int(spans.max())}")

    def pass_a():
        return pmajor.pm_pass(slab_a, ranges, coef, "a", symm=symm)

    def pass_a_plain():
        return pmajor.pm_pass_plain(slab_a, ranges, coef, "a", symm=symm)

    out_a = pass_a()
    err_a = compare("pass A", out_a, pass_a_plain(), exact_rows=(3,))
    rows = [dict(name="pm_pass_a", route="cuda", source=SOURCE, replaces=REPLACES,
                 max_abs_err=err_a, ms=cuda_ms(pass_a, 20), plain_ms=cuda_ms(pass_a_plain, 3))]

    cp = pmajor.finalize_cp(out_a[0], out_a[3], pr.ignored_pressure)
    err_b = {}
    for variant, fold in (("fold", True), ("split", False)):
        cp_slab = cp * (1.0 + pr.pressure_amplifier) if fold else cp
        slab_b = pmajor.pass_b_slab(slab_a, out_a, cp_slab, pr.surface_smoothing)

        def pass_b(slab_b=slab_b, fold=fold):
            return pmajor.pm_pass(slab_b, ranges, coef, "b", fold=fold, symm=symm)

        def pass_b_plain(slab_b=slab_b, fold=fold):
            return pmajor.pm_pass_plain(slab_b, ranges, coef, "b", fold=fold, symm=symm)

        out_b = pass_b()
        err_b[variant] = compare(f"pass B {variant}", out_b, pass_b_plain())
        brute_force(slab_a, slab_b, out_a, out_b, st.alive[order], coef, fold, symm)
        if fold:  # the main path's variant is the one timed and reported
            rows.append(dict(name="pm_pass_b", route="cuda", source=SOURCE,
                             replaces=REPLACES, max_abs_err=err_b[variant],
                             ms=cuda_ms(pass_b, 20), plain_ms=cuda_ms(pass_b_plain, 3)))
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (median, CUDA events)")
    return rows


def brute_force(slab_a, slab_b, out_a, out_b, alive, coef, fold, symm):
    """Passes A and B for BRUTE_SAMPLE random alive selves, against every
    particle of the world: the JAX kernel's pair mask (encoded distance <=
    diameter in f32, row within one, j != i) and its pair terms, summed in
    float64.  Neighbor counts must agree exactly."""
    import torch

    dev = slab_a.device
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.nonzero(alive).squeeze(1)
    idx = idx[torch.randperm(idx.numel(), generator=gen, device=dev)[:BRUTE_SAMPLE]]
    f64 = torch.float64
    diam, tp = float(coef[0]), float(coef[1])
    ref_a = torch.zeros((6, idx.numel()), dtype=f64, device=dev)
    ref_b = torch.zeros((out_b.shape[0], idx.numel()), dtype=f64, device=dev)
    for start in range(0, idx.numel(), BRUTE_CHUNK):
        sel = idx[start:start + BRUTE_CHUNK]
        s = slab_a[sel]
        rx = s[:, None, 0] - slab_a[None, :, 0]  # f32, as the kernel's mask
        ry = s[:, None, 1] - slab_a[None, :, 1]
        near = ((rx * rx + ry * ry) <= coef[0] * coef[0]) & (
            (slab_a[None, :, 6] - s[:, None, 6]).abs() <= 1.0
        )
        near[torch.arange(sel.numel(), device=dev), sel] = False
        k, j = torch.nonzero(near, as_tuple=True)
        i = sel[k]
        a_i, a_j = slab_a[i].to(f64), slab_a[j].to(f64)
        b_i, b_j = slab_b[i].to(f64), slab_b[j].to(f64)
        nr = (a_i[:, 2:4] if symm else a_i[:, 0:2]) - a_j[:, 2:4]
        nd = torch.clamp((nr * nr).sum(1), min=1e-24).sqrt()
        nh = nr / nd[:, None]
        w = 1.0 - torch.clamp(nd / diam, max=1.0)
        terms_a = [w, (1 - w) * w * nh[:, 0], (1 - w) * w * nh[:, 1],
                   torch.ones_like(w), a_j[:, 4], a_j[:, 5]]
        align = ((b_i[:, 5:7] - b_j[:, 5:7]) * nh).sum(1)
        t_coef = align + b_i[:, 4] + b_j[:, 4] - 2.0 * tp
        terms_b = [t_coef * nh[:, 0], t_coef * nh[:, 1]]
        if not fold:
            p_coef = b_i[:, 4] + b_j[:, 4]
            terms_b += [p_coef * nh[:, 0], p_coef * nh[:, 1]]
        for ref, terms in ((ref_a, terms_a), (ref_b, terms_b)):
            for r, t in enumerate(terms):
                ref[r].index_add_(0, k + start, t)
    if fold:  # pass A's output is the same in both variants: check it once
        compare("brute force, pass A", out_a[:, idx].to(f64), ref_a, exact_rows=(3,))
    compare(f"brute force, pass B {'fold' if fold else 'split'}", out_b[:, idx].to(f64), ref_b)
    print(f"  brute force: {idx.numel()} selves, {int(ref_a[3].sum())} pairs, "
          f"max count {int(ref_a[3].max())}")


def uid_aligned(crate):
    s = crate.state
    order = s.uid.long().cpu().argsort()
    return s.pos.cpu()[order], s.vel.cpu()[order], s.alive.cpu()[order]


def main() -> int:
    import torch

    # -- 1. card ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print("card (nvidia-smi name, power.limit):")
    print(smi, flush=True)

    from sand_crate_tpu_torch import Crate
    from sand_crate_tpu_torch.ops import cuda_build, pmajor
    from sand_crate_tpu_torch.physics import step

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load("pmajor")
    print(f"build: pmajor.cu in {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.BUILD_LOGS.get("pmajor", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. world --------------------------------------------------------------
    t0 = time.perf_counter()
    crate = Crate(dam_break_world(N_TARGET), device="cuda")
    n0 = crate.particle_count
    sc = crate.scene
    print(f"world: dam break, {n0} alive, capacity {sc.capacity}, grid "
          f"{sc.grid_nx}x{sc.grid_ny}, built in {time.perf_counter() - t0:.2f} s")
    check(n0 == 1_001_700 and sc.capacity == 1_050_112, "1M world size")

    # -- 4. kernels against their plain versions ---------------------------------
    t0 = time.perf_counter()
    crate.run(SETTLE_TICKS)
    print(f"settle: {SETTLE_TICKS} ticks in {time.perf_counter() - t0:.2f} s")
    print("kernels vs plain versions (same device inputs):")
    rows = kernels_vs_plain(crate)

    # -- 5. main path ------------------------------------------------------------
    for mode in pmajor.LAUNCHES:
        pmajor.LAUNCHES[mode] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diag = crate.run(MAIN_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pmajor.LAUNCHES)
    print(f"main path: Crate.run({MAIN_TICKS}) launches {launches}")
    check(launches == {"a": MAIN_TICKS, "b": MAIN_TICKS}, "kernel launches != 1 per pass per tick")
    check(int(diag.non_finite) == 0, f"non_finite {int(diag.non_finite)}")
    check(int(diag.neighbor_overflow) == 0, "neighbor_overflow")
    check(int(diag.particle_count) == n0, f"alive count {int(diag.particle_count)} != {n0}")
    st = crate.state
    uids = torch.sort(st.uid[st.alive]).values
    check(torch.equal(uids, torch.arange(n0, dtype=torch.int32, device="cuda")),
          "uid over alive slots is not a permutation")
    check(bool(torch.isfinite(st.pos).all()), "non-finite positions")
    speed = st.vel[st.alive].norm(dim=1)
    p99 = float(torch.quantile(speed, 0.99))
    runaways = int((speed > RUNAWAY_SPEED).sum())
    print(f"  max_speed {float(diag.max_speed):.4f} speed p50 {float(speed.median()):.4f} "
          f"p99 {p99:.4f}, {runaways} faster than {RUNAWAY_SPEED}; "
          f"force_dv {diag.force_dv.cpu().tolist()}")
    check(p99 <= 2 * FREE_FALL, f"speed p99 {p99} > twice the free-fall speed {FREE_FALL}")
    check(runaways <= RUNAWAY_SHARE * n0, f"{runaways} particles faster than {RUNAWAY_SPEED}")

    events = [torch.cuda.Event(enable_timing=True) for _ in range(P50_TICKS + 1)]
    state = crate.state
    events[0].record()
    for k in range(P50_TICKS):
        state, _ = step(state, crate.params, crate.scene, crate.generator)
        events[k + 1].record()
    torch.cuda.synchronize()
    p50 = statistics.median(events[k].elapsed_time(events[k + 1]) for k in range(P50_TICKS))
    print(f"main path on {smi}: {n0} particles, {MAIN_TICKS / wall:.3f} steps/s "
          f"({wall / MAIN_TICKS * 1000:.3f} ms/step mean over {MAIN_TICKS} ticks, "
          f"host clock + synchronize), step p50 {p50:.3f} ms "
          f"(CUDA events, {P50_TICKS} ticks)")

    # -- 6. trajectory: kernel path vs plain path, both on the card -------------
    world = dam_break_world(TRAJ_PARTICLES)
    with_kernels = Crate(world, device="cuda")
    with_plain = Crate(world, device="cuda")
    before = dict(pmajor.LAUNCHES)
    with_kernels.run(TRAJ_TICKS)
    after_kernels = dict(pmajor.LAUNCHES)
    kernel_pass = pmajor.pm_pass
    pmajor.pm_pass = pmajor.pm_pass_plain  # the step's passes, as plain torch
    try:
        with_plain.run(TRAJ_TICKS)
    finally:
        pmajor.pm_pass = kernel_pass
    check(all(after_kernels[m] - before[m] == TRAJ_TICKS for m in before)
          and pmajor.LAUNCHES == after_kernels,
          "trajectory: the kernel run must launch the kernels and the plain run none")
    pk, vk, ak = uid_aligned(with_kernels)
    pp, vp, ap = uid_aligned(with_plain)
    check(torch.equal(ak, ap), "trajectory alive masks differ")
    dpos = float((pk[ak] - pp[ap]).abs().max())
    dvel = float((vk[ak] - vp[ap]).abs().max())
    print(f"trajectory: {int(ak.sum())} particles x {TRAJ_TICKS} ticks, kernel path vs "
          f"plain path on the card: max |dpos| {dpos:.3e}, max |dvel| {dvel:.3e}")
    torch.testing.assert_close(pk[ak], pp[ap], rtol=2e-3, atol=2e-4)

    for r in rows:
        r["launches"] = launches[r["name"][-1]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
