"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure raises and exits non-zero before the last line; each
prints its wall time as "[phase] name: s"):

1. card: require CUDA; print the card's name and power limit (nvidia-smi).
2. build: compile the hand-written CUDA kernels (csrc/pmajor.cu with K1/K2
   and K10, csrc/grid_pair.cu with K3-K9, csrc/probes.cu, csrc/boundary.cu
   with B1 (full and positions-only), csrc/kick.cu with B2 (the velocity
   update), csrc/pair_batch.cu with D1 (the dense passes) and D2 (the
   chunked window passes); one nvcc each, started together) and print every
   kernel's ptxas registers and spills.
3. world: the dam break (configs/dam_break.yaml, read without PyYAML)
   rescaled as bench.py rescales it (tools.perf_probe.dam_break_world), to
   1,000,000 target particles (1,001,700 alive).
4. pmajor kernels: after SETTLE_TICKS ticks, K1/K2 (pass A, and pass B
   folded and split) against their plain torch versions on the same device
   inputs, with two-sided and with one-sided noise: bit for bit (max abs
   error 0, neighbor counts exact); the candidates each tile of 32 selves
   stages; the median device times of the main path's variants (two-sided,
   pass A and pass B folded) and of the one-sided ones, from CUDA events.
   Then an independent check of both passes at that state: for a random
   sample of selves, the sums over every particle of the world within one
   diameter (brute force, no cell grid or candidate ranges), in float64.
   Then the hard inputs of sand_crate_tpu_torch/ops/pmajor_cases.py (a
   range longer than a staged piece, tiles across grid rows, P not a
   multiple of the tile, P under one tile, a tail of dead selves), every
   pass and variant, both noise forms: bit for bit; and K10 on each, both
   chunk sizes, passes A, B folded, B split and B split with the spring
   (all four instantiations): bit for bit its plain version and K1/K2
   one-sided.
   (b) K10 at that state, chunks of 32 and 128 selves, passes A, B folded
   and B split with the spring: bit-identical to its plain version and to
   K1/K2 one-sided, its in-kernel ranges (window_ranges) equal to
   candidate_ranges'; the chunk windows it searches (mean and max), the
   candidates its warps stage and its selves walk, median times of K10 and
   K1/K2 one-sided, the bound.
5. pmajor main path: Crate.run for MAIN_TICKS ticks; the kernel launch
   counters must rise by one per pass per tick (the boundary kernels: the
   positions-only and the full ghost pass once a tick each, the velocity
   update once; so in every drive below); no non-finite values, no
   overflow, the alive count conserved (closed box, no sources), uids a
   permutation, and no blow-up (speed bounds below).  Prints steps/s and
   the step p50 with the card name.
   (c) the same under SAND_CRATE_PMSUB=1 (K10 launches, K1/K2 none), on a
   fresh world settled as in phase 4.
   (d) GATE_TICKS ticks under SAND_CRATE_PMAJOR_GATE=1 (K1/K2 launch, K10
   none); the gate's pair sums equal K10's bit for bit (both one-sided).
   (f) instrumented ticks (fold off, spring on) per schedule, in turns:
   the Collisions phase of K1/K2 two-sided, one-sided, and K10.  Then
   Crate(instrument=True) from the settled state: its phases replayed (one
   captured graph a phase) against the eager instrumented_tick for
   INSTRUMENT_TICKS ticks, bit for bit, both PhaseTimer tables side by
   side, and the fused step with fold off replayed under the profiler.
6. trajectories: a ~10k-particle dam break for 20 ticks on the card, once
   on the kernel path (Crate.run) and once with the pair passes and both
   boundary wrappers swapped for their plain torch versions (an explicit
   eager loop of physics.step: the plain versions read the host, which a
   graph capture refuses), compared uid-aligned at
   tests/test_pmajor.py:371-374's tolerance; on K1/K2 and on K10
   (SAND_CRATE_PMSUB=1).
7. grid kernels: the same 1M world on the slot-grid backend
   (forces_mode="pallas", cell_capacity 16), settled GRID_SETTLE_TICKS
   ticks; at that state the tick's slab-order kernels, pair_pass_a (K4+K5)
   and pair_pass_b_emit (K8+K9, spring off and on), bit for bit against
   their plain versions, pass A also equal to the dense plain pass A on the
   placed grid; the candidates a warp tile stages and a self walks; then
   the particle-order provider's kernels, place_grid (K3) and grid-mode
   pair_pass_b (K6+K7) on the placed G and PS, bit for bit, emit mode equal
   to grid mode plus gather_pair_sums; median times, and for place_grid the
   time of the one PyTorch call that does the same scatter (index_put_).
   Then the hard inputs of sand_crate_tpu_torch/ops/grid_cases.py (cells
   deeper than the capacity, a window longer than a staged piece, tiles
   across grid rows, the grid's edge rows and columns, P < 32, P not a
   multiple of 32, a dead tail), pass A at row offsets 0 and 5, emit with
   the spring off and on, and grid-mode pass B on G and PS placed from
   each case (spring off and on, row offsets 0 and 5): bit for bit.  Then the particle-order
   provider (neighbor_forces_pallas) is driven once with the counters
   reset: place_grid twice (G and PS), pass A and grid-mode pass B once,
   equal to the sorted provider.
8. grid main path: Crate.run for GRID_TICKS ticks at 1M on the slot grid;
   the counters rise by one per pass per tick and place_grid never runs,
   non_finite 0, the last tick's overflow equal to an independent count
   (bincount) of alive particles past 16 in a cell, alive count and uids
   kept, the same blow-up bounds; steps/s and step p50; one tick's peak
   allocation, below the dense grids G and PS that the tick no longer
   builds.
9. grid trajectory: as phase 6 on the slot-grid backend, the two
   slab-order passes and both boundary wrappers swapped for their plain
   versions.
(e) bench entry: python -m sand_crate_tpu_torch.bench --particles 1000000
   --ticks BENCH_TICKS as a subprocess; its JSON line parses and its stderr
   line shows overflow 0.
(f) instrument: Crate(instrument=True) on the 10k world (its first tick
   eager and captured, then one replayed graph a phase) equals a fused run
   with fold off over INSTRUMENT_TICKS ticks, bit for bit; the PhaseTimer;
   then the replayed and the eager phase tables, as at 1M.
(g) stream_frames on the 10k world equals a synchronous trajectory.
(h) probes (csrc/probes.cu, the ported kernels of tools/): P1 at phase 4's
   settled state and P2 at phase 7's settled grid, each variant against its
   plain version bit for bit; P4 and P3 at the tools' sizes likewise.  Then
   each probe's main (the tools' entry points; P1 and P2 on those same
   crates) with the launch counters reset just before and read just after:
   it prints G(mul+add)/s, us per visit, window widths, ms per variant
   beside the shipped (slab-order) pair_pass_a, and its times are the rows'
   ms; P1 also prints the range of its squared distances (inside
   inv_sqrt_rn's exact range) and each row's share of its bound.  P3 is
   timed on two inputs (the tool's, whose mask almost never holds, and
   equal rw columns) that must agree within PROBE_P3_SPREAD.  Then both P1
   modes, every P2 variant, both P3 forms and all three P4 kinds on the
   hard inputs of sand_crate_tpu_torch/probes/probe_cases.py (W 200 and
   1000, clamped windows, the slab's zero padding, nd2 at its floor, pairs
   at exactly one diameter, one block; an odd m, tr 1, 3 and 8, NXP 32,
   air blocks, coincident particles, pairs at exactly one diameter, far
   positions, noise with a tick and a row offset; an odd W, one visit and
   64, equal rw, coincident positions, a candidate at the cutoff; every
   step rounding, subnormal inputs, overflow to inf, a partial last block,
   0 iterations), and every P2 variant at M = 1..8 (each compiled m): bit
   for bit.
(i) recording and checkpoints on the stirring-cup world (an emitter and a
   motored cup): stream_frames -> TrajectoryWriter -> load_trajectory gives
   the frames back; a checkpoint saved at tick T and restored into a fresh
   Crate runs on as the uninterrupted crate does, held against two
   uninterrupted runs from one seed (bit for bit where those agree).
(j) batched crates and the small- and mid-crate backends (their pair
   kernels D1 (prologue and passes) on dense and D2 on chunked, once a pass
   a tick, K1/K2 on pmajor, and no other pair or probe kernel; the boundary
   counters rise by
   exactly their per-tick counts, the full ghost pass once a tick, the
   positions-only pass once on chunked, the velocity update once; a vmapped
   batch launches each once a tick for all its crates): (a)
   stirring_cup and wave_machine (bench.STIRRING_CUP, bench.WAVE_MACHINE)
   as one crate on dense, chunked and pmajor for SMALL_TICKS ticks each,
   dense and pmajor twice in turns, steps/s and step p50 per backend, the
   first run of each under the profiler too (the evidence for
   "auto"'s thresholds), non_finite and overflow 0, uids unique, the count
   within its budget, and after the sources stop the alive set kept; (b) a
   vmapped BatchedCrates of VMAP_CRATES crates without emitters against
   each crate stepped alone, dense and chunked; (c) run_datagen with
   DATAGEN_CRATES stirring_cup crates (the BASELINE.json config #5 size),
   DATAGEN_TICKS ticks sampled every DATAGEN_EVERY: every crate finite,
   overflow 0, particle-steps/s and peak memory; (d) WAVE_CRATES
   wave_machine crates for WAVE_TICKS ticks: particle-steps/s, overflow 0.
   (c) and (d) run on BatchedCrates' default backend and then on the other
   one (the evidence for its threshold), each profiled with its
   PROFILED_TOP costliest kernels by name (the breakdown of the batched
   dense and chunked ticks).
(k) the command line's main path: ``cli.main(["run", <configs/dam_break.yaml
   as JSON>, "--headless", "--no-record", "--ticks", CLI_TICKS,
   "--ticks-per-frame", 2])`` on the card (Playback -> Crate.stream_frames
   -> p-major at capacity 100,096): K1/K2 once a tick and nothing else, the
   state finite, uids unique, the next tick's overflow and non-finite count
   0, ticks/s; the last frame from the C rasterizer (native/rasterize.c,
   which must build) equal pixel for pixel to the numpy rasterizer; phase
   (i)'s recording replayed through ``cli.main(["replay", ...])``; then the
   wave machine (bench.WAVE_MACHINE) WAVE_BACKEND_TICKS ticks on dense
   (D1 once a pass a tick), gather and cellwise (plain torch, no pair
   kernel; overflow and non_finite 0), and at the dense crate's state the
   gather's and
   cellwise's pair sums (noise 0) equal to dense's within SUMS_TOL, the
   counts exactly, below the 20-neighbor cap and the cell capacity.
(l) the runaway check: the 1M dam break settled SETTLE_TICKS ticks on
   p-major, its state copied into crates on p-major, pallas and cellwise
   (the cell grid in plain torch, 16 slots a cell; RUNAWAY_CELLWISE_TICKS
   ticks), and on p-major without noise and with one-sided noise, each run
   RUNAWAY_TICKS ticks; every
   RUNAWAY_EVERY ticks each one's count of particles faster than
   RUNAWAY_SPEED, max speed, overflow, non-finite count and fullest cell,
   and its ms a tick and peak allocation; K1/K2 and the slab-order grid
   kernels once a tick; the first p-major runaways' neighbors and pair sums
   at the tick before they leave, on p-major and on the 16-slot grid, and
   p-major's p_i and counts on the over-full cells against a brute force
   (PILE_P_TOL); at the end each p-major runaway's speed, window width and
   neighbor count.
(m) spatial bands (sand_crate_tpu_torch/spatial.py) on a LocalGroup of
   BAND_SHARDS shards of the card: (m1) the 1M dam break settled
   SETTLE_TICKS ticks, split into uniform bands of 384 rows; one band tick
   with noise 0 against the single-device tick, positions matched by uid
   (BAND_POS_RTOL / BAND_POS_ATOL), and K1/K2 on the spliced slabs of
   bands 0 and 1 (sentinel halo entries included) bit for bit against
   their plain versions; BAND_DEFAULT_TICKS ticks at the JAX default
   mig_cap (printed: deferred movers, halo spill and the edge-row runs the
   step sends; each shard's spill must be its runs past the halo cap);
   BAND_TICKS ticks at BAND_MIG_CAP with noise: overflow (the halo spill)
   and migration_dropped 0 every tick, non_finite 0, uids unique, the alive
   set kept but for particles culled outside the box, K1/K2 and the pair
   prep (slab A alone) launched once per band per tick, the sent edge-row
   runs beside the halo cap; the
   band and single-device steps timed in turns (steps/s, p50); the same
   with rebalanced edges (the edges every BAND_EDGES_EVERY ticks,
   shard_alive max/mean against the uniform split's).  (m2) the pallas
   bands (16 slots): one tick against the single-device pallas tick, the
   overflow equal to an independent count; K4+K5 and K8+K9 on band 1's
   spliced slab bit for bit against their plain versions, and K4+K5 on
   the same slab in band-local rows with the row offset lo - 1 equal to
   both; BAND_GRID_TICKS more ticks (K4+K5 and K8+K9 once per band per
   tick).  (m3) tests/test_spatial.py's scenes on the card (cellwise,
   pallas, pmajor at its tick counts, pmajor and cellwise rebalanced, the
   spawn budget, spawn truncation and the halo spill), the sentinel case
   of tests/test_torch_spatial.py (K1/K2 == plain with the above-halo
   sentinels inside the selves' ranges, neighbor counts == a brute
   force), entry() and
   dryrun_multichip(4).  (m4) a line on DistGroup's NCCL leg (two cards).
(n) the engine tools (sand_crate_tpu_torch/tools/, the twins of tools/),
   called in-process with every kernel counter reset first; a non-zero
   return or a broken gate fails the run: (n1) soak: the 1M dam break on
   "auto" (p-major, K1/K2) for SOAK_TICKS ticks in chunks of SOAK_CHUNK,
   the tool's line per chunk (steps/s, overflow, non_finite, max speed,
   max cell occupancy, blob, duplicate uids) and beside it the alive
   count, the alive particles over RUNAWAY_SPEED and the fullest cell;
   the tool's verdict must be 0, K1/K2 launched once a tick; sustained
   steps/s.  (n2) the same chunk loop on a wave_machine crate
   (configs/wave_machine.yaml, read without PyYAML; dense) for
   WAVE_SOAK_TICKS ticks: verdict 0 and the alive count level once the
   source stops.  (n3) perf_probe at PROBE_SIZES.  (n4) occupancy_stats at
   1M after OCC_TICKS ticks.  (n5) rebalance_midscale at 65,536 particles
   on 8 LocalGroup shards of the card: all four gates.  (n6)
   spatial_balance uniform and rebalanced, 8 shards, BALANCE_TICKS ticks:
   max/mean at the last sample, no particle lost.  (n7) chunked_sweep
   --fill at FILL_CRATES crates: overflow 0 in every chunk.  (n8)
   small_n_probe at SMALL_N, cut to SMALL_N_CHUNKS chunks.  Each kernel
   row gains "tools_launches", its launches over phase (n).
(o) the compiled step loop (sand_crate_tpu_torch/graphs.py).  Every
   Crate.run, physics_tick, stream_frames, physics.rollout, trajectory and
   BatchedCrates.run above is a replay of a captured CUDA graph, and the
   launch counters count replays (a capture's rise, added once a replay).
   Here each gate holds GRAPH_TICKS replayed ticks against the explicit
   eager loop of physics.step from the same state, coefficients and
   generator state, bit for bit (state, last Diagnostics, generator
   state), with a replay a tick and no capture: (o1) the 1M dam break on
   p-major (default, SAND_CRATE_PMSUB=1, SAND_CRATE_PMAJOR_GATE=1) and
   pallas after GRAPH_SETTLE ticks; (o2) stirring_cup and wave_machine on
   dense, chunked and p-major after SMALL_TICKS ticks, with a viscosity
   edit in the middle of the run (no new capture); (o3) BatchedCrates on
   dense and chunked (the running max of the overflow too); (o4) a
   checkpoint restored into a crate whose graph is captured; (o5)
   stream_frames == physics.trajectory == the eager loop's frames.  Timing
   turns, graph / eager / eager / graph, of GRAPH_TURN_TICKS ticks (steps/s,
   step p50) and PROFILED_TICKS under the profiler (busy share, launches a
   tick with cudaGraphLaunch counted): the 1M cells, perf_probe's 10,132
   and 100,580, the single crates of (o2), run_datagen's 1024 stirring_cup
   crates (GRAPH_BATCH_TURN_TICKS), and at 1M a frame of 2 ticks as one
   replay of a 2-tick graph against two replays.

(p) the band step as one graph a tick (spatial.SpatialStep over
   graphs.BandGraph; every band call of (m) and (n) above replays it too,
   the counters counting replays).  The 1M dam break of (m), settled
   SETTLE_TICKS ticks, in BAND_SHARDS bands on a LocalGroup of the card at
   BAND_MIG_CAP, for each cell of BAND_GRAPH_CELLS (uniform p-major,
   rebalanced p-major, uniform pallas): the first call (eager, then the
   capture) and its peak memory; GRAPH_TICKS replayed ticks == the explicit
   eager band loop (spatial_step over group.run, eager_band_loop) from the
   same state and shard generator states, bit for bit in state, every stat
   and every generator, a replay a tick, no capture, the kernel counters
   rising once a band a tick; then graph / eager / eager / graph turns of
   GRAPH_TURN_TICKS (steps/s, step p50) and PROFILED_TICKS under the
   profiler (busy share, launches a tick with cudaGraphLaunch counted).
   The boundary counters rise once a band a tick (the band step runs the
   full ghost pass and the velocity update once).
(q) the boundary chain (csrc/boundary.cu, ops/boundary.py) and the
   velocity update (csrc/kick.cu, ops/kick.py), after (b) at phase 4's
   settled 1M state: the tick's inputs in slot order and in its sorted
   order; ghost_pass (B1) and ghost_pos (B1 positions-only) against their
   plain torch versions, every output, bit for bit (NaN in the same places,
   the bits of signed zeros and NaN payloads too), ghost_pos equal to
   ghost_pass's position; the tick's velocity update (B2) on the sorted
   operands and p-major pair sums of that state (transposed views, the
   folded sums' expanded zero plane), fused and a stage a launch, each bit
   for bit its plain version, staged equal to fused (force_dv too), and its
   CCD stage alone; torch.sign on the card printed; the median times, plain
   times and bounds of B1 full (sorted order), B1 positions-only (slot
   order), the update fused, a stage a launch (the sum) and the clamp
   alone (the rows of the kernels line, their launches from phase 5); every
   case of ops/boundary_cases.py and ops/kick_cases.py (each checked to
   hold what it claims) bit for bit, the three-crate cases through the
   crate-axis operators (one launch); and torch.func.vmap of the wrappers
   over BOUNDARY_CRATES crates (the case's and the 1M state's with radii,
   steps and viscosities of their own), one launch each, against each
   crate alone, kernel and plain.  The boundary counters of (f), (j), (o)
   and (p) rise by their per-tick counts (the instrumented tick: the update
   once a kick phase and once to integrate).
(q3) after (q): the seven per-kick functions of physics (apply_tension
   ... apply_continuous_collision) on every solo case of ops/kick_cases.py:
   one launch of B2 each, counted as its kind (a single stage, the clamp
   as ccd), bit for bit the plain update of its single stage.
(q2) queue 3's open check, after (f): the 1M dam break of (n1) for
   ESCAPE_TICKS ticks, a replay a tick; each tick that leaves an alive
   particle outside [-r, 1 + r] is run again eagerly from the state before
   it (bit for bit the replay) with the ghost pass's and the velocity
   update's inputs kept (the velocity into the clamp from the plain stages
   before it), and each escaping particle's row (pre-fix and fixed position,
   velocity into and out of the clamp, the segments, r, dt) is printed as
   JSON (tests/test_torch_boundary.py holds such rows on the CPU).

(r) the batched pair kernels (csrc/pair_batch.cu, ops/pair_batch.py), before
   (j): D1 (its prologue, which orders each crate, and the dense passes)
   and D2 (the chunked window passes) against their plain versions on
   every case of ops/pair_batch_cases.py (each checked to hold what it
   claims; counts bit for bit, NaN in the same places, floats within
   PAIR_TOL relative plus PAIR_TOL of the field's largest magnitude; the
   prologue's order and sorted fields bit for bit its plain twin's, its
   tile records equal), the three-crate case vmapped (one launch a kernel,
   each crate bit for bit alone), with the share of candidate tiles the
   kernels skip and the pairs they test (ops/pair_batch.py's mirror of
   their rule); then at the settled states of the 1024-crate stirring_cup
   batch (run_datagen's, dense) and the 64-crate wave_machine batch
   ((j)(d)'s, chunked), each kernel on each: the whole operator, the
   prologue and each pass alone against the plain versions vmapped over
   the crates, a few crates alone bit for bit their rows of the batch,
   median times of each kernel and of its plain version, the tiles
   skipped and pairs tested, and the bounds (D1 at 1024 x 640 and D2 at
   64 x 4096 are the rows of the kernels line, their launches those of
   (j)(c) and (j)(d)): the larger of the bytes (each input read once, each
   output written once) at 3.35 TB/s and the terms of the pairs the run
   counts (its neighbour counts' sum, COUNTED_PAIR_OPS each) at the
   published 67 TFLOP/s f32 peak (ops/measure.py: these floats are held
   at a tolerance, so a kernel may fuse them); beside it the all-pairs
   figure, which charges the pair test to every pair that could count (D1:
   each ordered pair of alive slots; D2: the row test to each alive window
   pair, the d2 test to those within one row) and which a kernel that skips
   tiles beats.  Then the dense and the chunked trajectories: a dam break
   of capacity 3712 for TRAJ_TICKS ticks on the kernel path and with the
   pair entries and the boundary wrappers swapped for their plain versions,
   as phase 6.

(s) batched crates on every backend, after (j): (s0) K1/K2 (pm_pass_crates),
   K10 (pms_pass_crates, chunks of 32 and 128)
   and the slab-order grid passes K4+K5 and K8+K9 (pair_pass_a_crates,
   pair_pass_b_emit_crates) with a crate axis on the batched hard inputs of
   ops/pmajor_cases.py and ops/grid_cases.py (every case padded to one
   size, an empty crate, coefficients, noise and ticks of their own): one
   launch a pass for the batch, bit for bit the plain version and each
   crate's solo launch.  (s1) WAVE_CRATES wave_machine crates (capacity
   4096, coefficients of their own, the emitter on), settled PAIR_SETTLE
   ticks on dense, that state and generator state copied into a
   BatchedCrates on each of BATCH_MODES (pmajor twice: K1/K2, then K10
   under SAND_CRATE_PMSUB=1): BATCH_SETTLE ticks (the eager tick
   and the capture), BATCH_CHECK_TICKS replayed
   ticks == the eager vmapped loop bit for bit (state, diagnostics, the
   overflow's running max, the generator), non_finite 0, each crate's uids
   unique, no particle lost but those culled outside the box, the pair
   kernels once a pass a tick for the whole batch (D1, D2, K1/K2, K10, K4+K5
   and K8+K9; none on gather and cellwise); BATCH_TIMED_TICKS replayed ticks:
   crate-steps/s, step p50, the card memory the batch holds (its state and
   its graph's pool), and under the profiler kernel ms,
   launches and device kernels a tick; at the settled pmajor (both
   schedules) and pallas batches the six crate-axis kernels against their
   plain versions and the
   solo launches, bit for bit, their times and bounds for the batch (the
   rows of the kernels line; their launches those of the timed ticks; the
   plain versions, crate by crate, timed once on the host clock).
   (s2) BIG_CRATES dam breaks of BIG_PARTICLES target particles (100,580
   alive, no emitter) on pmajor, pmajor PMSUB, pallas and chunked, as (s1)
   with the alive
   set kept; then the same crates one after another alone on pmajor
   (physics.rollout), each bit for bit its row of the pmajor batch in every
   state field, crate-steps/s beside the batches'.  (s3) run_datagen of
   WAVE_CRATES wave_machine crates on pmajor and pallas, S_DATAGEN_TICKS
   ticks in turns (pmajor, pallas, pallas, pmajor) beside a one-frame run
   of each: crate-steps/s end to end and past the set-up, peak memory.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Imports neither JAX nor sand_crate_tpu.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

from sand_crate_tpu_torch.ops.measure import bound, cuda_ms

N_TARGET = 1_000_000  # bench.py's default size: 1,001,700 alive, capacity 1,050,112
SETTLE_TICKS = 50
MAIN_TICKS = 200
P50_TICKS = 30
TRAJ_PARTICLES = 10_000
TRAJ_TICKS = 20
GRID_SETTLE_TICKS = 20
GRID_TICKS = 100
GRID_SLOTS = 16  # the JAX default cell_capacity
GATE_TICKS = 10
BENCH_TICKS = 100
INSTRUMENT_TICKS = 5
TURN_TICKS = 10
STREAM_FRAMES = 6
# f32 operations per pair that passes the mask, an upper estimate from the
# kernels' sources (geometry with jitter ~26, pass-A sums ~8, pass-B ~21).
# A kernel's bound (sand_crate_tpu_torch.ops.measure.bound) is the larger of
# its bytes over the H100's memory rate and these over its f32 rate.
PAIR_FLOPS = 50
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
REPLACES_K10 = "sand_crate_tpu/ops/pmajor.py:685"
PREP_SOURCE = "sand_crate_tpu_torch/csrc/pm_prep.cu"
PREP_REPLACES = "sand_crate_tpu/ops/pmajor.py:129,1006"  # feature_rows, _windows fusions
PREP_REPLACES_B = "sand_crate_tpu/ops/pmajor.py:175"  # finalize_cp's fusion
GRID_SOURCE = "sand_crate_tpu_torch/csrc/grid_pair.cu"
PROBE_SOURCE = "sand_crate_tpu_torch/csrc/probes.cu"
PROBE_REPLACES = {
    "bf16_chain": "tools/bf16_probe.py:39",
    "bf16_mixed": "tools/bf16_probe.py:52",
    "hybrid": "tools/hybrid_probe.py:107",
    "pmajor_probe": "tools/pmajor_probe.py:56",
    "passa": "tools/passa_probe.py:32",
    "passa_prefetch": "tools/passa_probe.py:166",
}
PROBE_ITERS = 64  # the tools' default iterations (P4, P3)
PROBE_W = 256  # pmajor_probe's default W: modes a and b at W + 128 and W + 256
PROBE_P3_SPREAD = 0.10  # P3's two inputs must time within 10% of each other
CKPT_FRAMES = 20  # stream_frames frames of 2 ticks before the checkpoint
CKPT_TICKS = 30  # ticks after it
SMALL_TICKS = 200  # (j)(a): single-crate ticks per backend
SMALL_AFTER = 20  # ticks after the timed run (sources stopped: alive kept)
VMAP_CRATES = 4  # (j)(b)
VMAP_TICKS = 20
DATAGEN_CRATES = 1024  # (j)(c): BASELINE.json config #5
DATAGEN_TICKS = 100
DATAGEN_EVERY = 20
WAVE_CRATES = 64  # (j)(d): the JAX package's measured batch (ops/chunked.py:80)
WAVE_TICKS = 20
PROFILED_TICKS = 5  # (j): ticks under torch.profiler for the device's busy share
PROFILED_TOP = 8  # (j): kernels named in the batched ticks' breakdown
# the profiler's host calls that launch device work: kernels, and (graphs.py)
# whole captured ticks
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
CLI_TICKS = 200  # (k): the CLI run of configs/dam_break.yaml
CLI_TICKS_PER_FRAME = 2
WAVE_BACKEND_TICKS = 150  # (k): wave_machine ticks on dense, gather and cellwise
# (k): gather and cellwise pair sums vs dense's, the dense tests' tolerance
# (tests/test_torch_dense_chunked.py::_assert_sums): 1e-5 relative plus 1e-5
# of the field's largest magnitude.
SUMS_TOL = 1e-5
# (l): ticks of each backend after the shared settled state.  Fewer than
# MAIN_TICKS: the cell grid in plain torch takes ~1.7 s a tick at 1M on an
# H100, and p-major's first runaways come ~23 ticks after the settle.
RUNAWAY_TICKS = 40
RUNAWAY_EVERY = 20  # (l): ticks between two readings
# (l): the cell grid in plain torch runs only the first reading (cut from
# RUNAWAY_TICKS to leave the script's time to phase (n): ~1.7 s a tick;
# its tick-90 reading, 0 runaways, is in ROADMAP queue 3)
RUNAWAY_CELLWISE_TICKS = 20
RUNAWAY_MODES = {"pmajor": {}, "pallas": dict(forces_mode="pallas", cell_capacity=GRID_SLOTS),
                 "cellwise": dict(forces_mode="cellwise", cell_capacity=GRID_SLOTS)}
# (l): p-major without collider noise and with one-sided noise: the runaways'
# cause is not the noise form
RUNAWAY_VARIANTS = {"pmajor, noise 0": {}, "pmajor, one-sided": dict(pmajor_symm=False)}
# (l): p-major's p_i on a pile against a float64 brute force: the JAX
# suite's PairSums tolerance (tests/test_pmajor.py:53)
PILE_P_TOL = 3e-3
# (m): the spatial bands
BAND_SHARDS = 4
BAND_TICKS = 20  # ticks of each 1M band run
BAND_TURN_TICKS = 10  # ticks of each timed turn (band, single, band, single)
BAND_EDGES_EVERY = 5  # rebalanced run: ticks between two readings of the edges
BAND_GRID_TICKS = 5  # pallas band ticks after the one compared with one device
# Movers a band sends each way a tick in the 1M runs.  The JAX default,
# min(1024, capacity // 16), assumes a few hundred movers; bench.py's
# fixed-dt rescale moves a falling particle several cell rows a tick, so
# ~10k cross each band edge and the rest would defer, binned at the edge
# row, and spill its halo (printed by BAND_DEFAULT_TICKS ticks at the
# default first).
BAND_MIG_CAP = 32768
BAND_DEFAULT_TICKS = 3
BAND_POS_RTOL, BAND_POS_ATOL = 1e-4, 1e-5  # tests/test_spatial.py:83
BAND_SMALL = {"cellwise": 25, "pallas": 10, "pmajor": 6}  # tests/test_spatial.py's ticks
# (o): the compiled step loop (graphs.py): ticks before the gates, ticks each
# gate holds against the eager loop, ticks of each timed turn (the batch of
# 1024 crates: ~70 ms a tick eagerly)
GRAPH_SETTLE = 20
GRAPH_TICKS = 10
GRAPH_TURN_TICKS = 20
GRAPH_BATCH_TURN_TICKS = 6
# (o): the 1M p-major replay's step p50 when its kicks, clamp and integrate
# ran as separate passes (torch kicks, a clamp kernel), the figure the fused
# velocity update is read against (PERF.md section 6)
SEPARATE_KICKS_P50 = 1.878
# the p-major pair glue's calls (csrc/pm_prep.cu), once a tick on every
# p-major schedule; a band step takes the prep (slab A of its own sorted
# crate) once a band and the plain ranges and slab B of its spliced slab
PREP_KEYS = ("pmajor.prep", "pmajor.slab_b")
# (o1): label -> (Crate options, environment knob, kernel counters that rise
# once a tick)
GRAPH_1M = {
    "pmajor": ({}, None, ("pmajor.a", "pmajor.b", *PREP_KEYS)),
    "pmajor SAND_CRATE_PMSUB=1": ({}, "SAND_CRATE_PMSUB",
                                  ("pmajor.sub_a", "pmajor.sub_b", *PREP_KEYS)),
    "pmajor SAND_CRATE_PMAJOR_GATE=1": ({}, "SAND_CRATE_PMAJOR_GATE",
                                        ("pmajor.a", "pmajor.b", *PREP_KEYS)),
    "pallas": (dict(forces_mode="pallas", cell_capacity=GRID_SLOTS), None,
               ("grid.pair_pass_a", "grid.pair_pass_b_emit")),
}
# (p): the band step as one graph a tick: label -> (Scene options, rebalance,
# kernel counters that rise once a band a tick)
BAND_GRAPH_CELLS = {
    "uniform p-major": (dict(forces_mode="pmajor"), False,
                        ("pmajor.a", "pmajor.b", "pmajor.prep")),
    "rebalanced p-major": (dict(forces_mode="pmajor"), True,
                           ("pmajor.a", "pmajor.b", "pmajor.prep")),
    "uniform pallas": (dict(forces_mode="pallas", cell_capacity=GRID_SLOTS), False,
                       ("grid.pair_pass_a", "grid.pair_pass_b_emit")),
}
# (n): the engine tools (sand_crate_tpu_torch/tools/), at the JAX records'
# settings: the 1M soak (never cut: it is the stability gate), the
# wave_machine soak, perf_probe at the README's three sizes,
# occupancy_stats, rebalance_midscale and spatial_balance at the tools'
# defaults, the chunked fill at K = 64, small_n_probe cut to 2 chunks of 200
# ticks (the tool's default is 20; its chunked row takes ~74 ms a tick)
# (q): the boundary kernels (csrc/boundary.cu: B1, full and positions-only)
# and the velocity update (csrc/kick.cu: B2).  What each moves a slot (the
# ghost pass: prepos 8, alive 1, pos 8, g_cnt 4, gsum 8, gvel_sum 8 bytes;
# positions-only: prepos 8, alive 1, pos 8; the update: each operand its
# stages read, once (an expanded zero plane is one element), and the
# velocity 8, with the integrate the position 8 and pressure 4, and 4 a
# norm row, written: kick_bytes) and the f32 operations of their plain
# chains, counted per slot and segment (ghost pass: the nearest point 18,
# the mask and mirror offsets 8, the contact velocity 6, the hard-wall
# ratio and correction 15, the sums 9; positions-only without the contact
# velocity and the sums) and per slot (the fixed position 4; the update:
# KICK_OPS a stage, the kick and its masked norm, and per padded wall the
# approach test for an alive slot and, for a wall the move approaches,
# counted from this run's data, the four signs 28, num 5, den 3, the
# guarded t 6 and the minimum 2).  The ghost passes' operations are counted
# as if every slot-segment pair took the exact path (an upper count: their
# bound is their bytes either way).
PAIR_SOURCE = "sand_crate_tpu_torch/csrc/pair_batch.cu"
PAIR_REPLACES = {"dense": "sand_crate_tpu/cellwise.py:334",
                 "window": "sand_crate_tpu/ops/chunked.py:50"}
# Each backend's pair kernels (kernel_counts keys), once a pass a tick.
PAIR_KEYS = {"pmajor": ("pmajor.a", "pmajor.b", *PREP_KEYS),
             "pmajor PMSUB": ("pmajor.sub_a", "pmajor.sub_b", *PREP_KEYS),
             "pallas": ("grid.pair_pass_a", "grid.pair_pass_b_emit"),
             "dense": ("pairs.dense_order", "pairs.dense_a", "pairs.dense_b"),
             "chunked": ("pairs.window_a", "pairs.window_b")}
PAIR_TOL = 1e-5  # (r): tests/test_torch_dense_chunked.py::_assert_sums
PAIR_SETTLE = 200  # (r): ticks that settle each batch (wave_machine: ~2800 alive)
PAIR_REPS = 5  # (r): timed runs of each pass and of its plain version
PAIR_SOLO = 3  # (r): crates of each settled batch held alone against their rows
TRAJ_SMALL_PARTICLES = 3500  # (r): the dense and chunked trajectories (capacity 3712)
BOUNDARY_SOURCE = "sand_crate_tpu_torch/csrc/boundary.cu"
KICK_SOURCE = "sand_crate_tpu_torch/csrc/kick.cu"
BOUNDARY_REPLACES = {"ghost_pass": "sand_crate_tpu/physics.py:331",
                     "ghost_pos": "sand_crate_tpu/physics.py:331",
                     "velocity_update": "sand_crate_tpu/physics.py:680",
                     "velocity_update_staged": "sand_crate_tpu/physics.py:680",
                     "continuous_collision": "sand_crate_tpu/physics.py:738"}
GHOST_BYTES, GHOST_OPS, GHOST_PARTICLE_OPS = 37, 56, 4
GHOST_POS_BYTES, GHOST_POS_OPS = 17, 41
# the update's operations a slot per stage bit (ops/kick.py): tension,
# gravity, pressure, spring, viscosity, wall bounce, the clamp's move, fix
# and norm, the integrate and speed^2
KICK_OPS = {1: 8, 2: 8, 4: 12, 8: 16, 16: 12, 32: 29, 64: 16, 128: 7}
CCD_WALL_OPS, CCD_CROSS_OPS = 3, 44
BOUNDARY_CRATES = 3  # (q): the vmapped batches
# the ghost passes a tick per backend, (full, positions-only): the sorted
# backends fix the positions alone before the sort and run the full pass on
# the sorted order; the band step (spatial.py) runs the full pass once
GHOSTS_A_TICK = {"pmajor": (1, 1), "pmajor PMSUB": (1, 1), "pallas": (1, 1), "chunked": (1, 1), "cellwise": (1, 1),
                 "dense": (1, 0), "gather": (1, 0), "band": (1, 0)}
# (q2): ticks of the 1M dam break searched for particles that leave the box
# (the first ESCAPE_TICKS of (n1)'s soak), and the rows printed
ESCAPE_TICKS = 1000
ESCAPE_PRINT = 40
SOAK_TICKS, SOAK_CHUNK = 2000, 250
WAVE_SOAK_TICKS, WAVE_SOURCE_TICKS = 3000, 500  # wave_machine.yaml: active_ticks 500
PROBE_SIZES = (10_000, 100_000, 1_000_000)
OCC_TICKS = (0, 100, 300, 600)
MIDSCALE = dict(particles=65536, eq_ticks=40, settle_ticks=240, n_shards=8)
BALANCE_SHARDS, BALANCE_TICKS = 8, 300
FILL_CRATES = 64
SMALL_N, SMALL_N_CHUNKS = 10_000, 2
# (s) batched crates on every backend
# (s1), (s2): the batches as (label, BatchedCrates' forces_mode, the knob
# they run under): the backends of BatchedCrates, and pmajor again under
# SAND_CRATE_PMSUB=1 (K10)
PMAJOR, PMSUB = ("pmajor", "pmajor", None), ("pmajor PMSUB", "pmajor", "SAND_CRATE_PMSUB")
PALLAS, CHUNKED = ("pallas", "pallas", None), ("chunked", "chunked", None)
BATCH_MODES = (("dense", "dense", None), CHUNKED, PMAJOR, PMSUB, PALLAS,
               ("gather", "gather", None), ("cellwise", "cellwise", None))
BATCH_SETTLE = 1  # (s1): ticks of each backend's batch before its check (eager, capture)
BATCH_CHECK_TICKS = 4  # (s1), (s2): replayed ticks held against the eager vmapped loop
BATCH_TIMED_TICKS = 20  # (s1), (s2): replayed ticks timed (crate-steps/s, p50)
BIG_CRATES = 8  # (s2): dam-break crates of BIG_PARTICLES target particles
BIG_PARTICLES = 100_000  # perf_probe's 100,580-particle dam break
BIG_SETTLE = 10
BIG_MODES = (PMAJOR, PMSUB, PALLAS, CHUNKED)
S_DATAGEN_TICKS, S_DATAGEN_EVERY = 1000, 20  # (s3): run_datagen of WAVE_CRATES crates


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def dam_break_world(n_target: int):
    from sand_crate_tpu_torch.bench import dam_break_world as world

    return world(n_target)


def kernel_row(name, source, replaces, err, ms, plain_ms, n_bytes, n_ops, library_ms=None,
               f32_flops=0.0):
    bound_ms, bound_by = bound(n_bytes, n_ops, f32_flops=f32_flops)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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


def exact(label, got, ref):
    """The kernel's output must equal its plain version's bit for bit
    (the neighbor counts included); returns the max abs error, 0."""
    import torch

    err = float((got - ref).abs().max()) if got.numel() else 0.0
    check(torch.equal(got, ref), f"{label}: kernel differs from its plain version "
                                 f"(max abs err {err})")
    return err


def kernels_vs_plain(crate):
    """Phase 4: both passes' kernels against their plain versions at the
    crate's current (settled) state, in the step's sorted order, with the
    main path's two-sided noise and one-sided: bit for bit.  The main path's
    variants (two-sided; pass A, pass B folded) are timed and reported."""
    import torch

    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops import pmajor

    st, sc, pr = crate.state, crate.scene, crate.params
    sorted_cid, order = torch.sort(cell_ids_grid(st.pos, st.alive, sc), stable=True)
    alive = st.alive[order]
    ranges = pmajor.candidate_ranges(sorted_cid, alive, sc.grid_nx, sc.grid_ny)
    coef = pmajor.coef_stack(pr.diameter, pr.target_pressure, pr.spring_overlap_balance)
    n_alive = int(alive.sum())
    P = sorted_cid.shape[0]
    spans = (ranges[3:] - ranges[:3]).sum(dim=0)[alive].float()
    win = pmajor.tile_windows(ranges)
    lens = torch.nn.functional.pad(ranges[3:] - ranges[:3], (0, -P % pmajor.PM_TILE))
    steps = lens.view(3, -1, pmajor.PM_TILE).amax(dim=2).sum(dim=0)  # a warp's, per tile
    print(f"  candidates per alive particle: mean {float(spans.mean()):.2f} "
          f"max {int(spans.max())}; staged per alive particle (windows of "
          f"{pmajor.PM_TILE} selves) {float((win[3:] - win[:3]).sum()) / n_alive:.3f}; "
          f"candidates a warp walks (its longest range per row offset) "
          f"{float(steps[steps > 0].float().mean()):.2f}")
    rows = []
    for symm in (sc.pmajor_symm, not sc.pmajor_symm):
        noise = "two-sided" if symm else "one-sided"
        main = symm == sc.pmajor_symm
        slab_a = pmajor.pass_a_slab(
            st.pos[order], st.vel[order], alive, sorted_cid,
            pr.diameter * pr.collider_noise_level, st.tick, sc, symm=symm,
        )

        def pass_a(slab_a=slab_a, symm=symm):
            return pmajor.pm_pass(slab_a, ranges, coef, "a", symm=symm)

        def pass_a_plain(slab_a=slab_a, symm=symm):
            return pmajor.pm_pass_plain(slab_a, ranges, coef, "a", symm=symm)

        out_a = pass_a()
        err_a = exact(f"pass A {noise}", out_a, pass_a_plain())
        pairs = float(out_a[3].sum())  # directed pairs within the cutoff
        timed = [("pm_pass_a", err_a, pass_a, pass_a_plain, (8 + 6 + 6) * 4 * P)]
        cp = pmajor.finalize_cp(out_a[0], out_a[3], pr.ignored_pressure)
        for variant, fold in (("fold", True), ("split", False)):
            cp_slab = cp * (1.0 + pr.pressure_amplifier) if fold else cp
            slab_b = pmajor.pass_b_slab(slab_a, out_a, cp_slab, pr.surface_smoothing)

            def pass_b(slab_b=slab_b, fold=fold, symm=symm):
                return pmajor.pm_pass(slab_b, ranges, coef, "b", fold=fold, symm=symm)

            def pass_b_plain(slab_b=slab_b, fold=fold, symm=symm):
                return pmajor.pm_pass_plain(slab_b, ranges, coef, "b", fold=fold, symm=symm)

            out_b = pass_b()
            err_b = exact(f"pass B {variant} {noise}", out_b, pass_b_plain())
            if main:
                brute_force(slab_a, slab_b, out_a, out_b, alive, coef, fold, symm)
            if fold:
                timed.append(("pm_pass_b", err_b, pass_b, pass_b_plain, (8 + 6 + 2) * 4 * P))
        print(f"  {noise}: passes A, B folded and B split == plain bit for bit, "
              f"{pairs:.0f} directed pairs")
        for name, err, run, plain, n_bytes in timed:
            if main:  # the main path's variants are the kernels' rows
                rows.append(kernel_row(name, SOURCE, REPLACES, err, cuda_ms(run, 20),
                                       cuda_ms(plain, 3), n_bytes, pairs * PAIR_FLOPS))
            else:
                print(f"  {name} {noise}: kernel {cuda_ms(run, 20):.4f} ms (median, CUDA events)")
    for r in rows:
        print(f"  {r['name']} {'two-sided' if sc.pmajor_symm else 'one-sided'}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) (median, CUDA events)")
    return rows


def pair_prep_rows(crate):
    """The pair glue's kernels (csrc/pm_prep.cu) against their plain torch
    chains at the crate's (settled) state, on the main path's inputs: slab
    A and the ranges (pair_prep, with and without the ranges), slab B and
    the cell pressure (pass_b_prep), bit for bit; then each timed beside
    its plain chain and its bytes bound (each input byte read once, each
    output written once: pos, vel, alive, cid 21 B a slot in, slab A and the
    ranges 56 B out, the cell table 4 B a cell; slab A's positions and row
    and pass A's four sums 36 B in, slab B and p_i 36 B out).  The ranges
    alone (the cell table pass, every cell written, and six table reads a
    slot) are read as prep with ranges less prep without, beside
    candidate_ranges' two searchsorteds."""
    import torch

    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops import pmajor

    st, sc, pr = crate.state, crate.scene, crate.params
    sorted_cid, order = torch.sort(cell_ids_grid(st.pos, st.alive, sc), stable=True)
    alive = sorted_cid < sc.num_cells
    P, nx, ny = sorted_cid.shape[0], sc.grid_nx, sc.grid_ny
    args = (st.pos[order], st.vel[order], alive, sorted_cid,
            pr.diameter * pr.collider_noise_level, st.tick, sc)
    symm = sc.pmajor_symm

    def prep(ranges=True):
        return pmajor.pair_prep(*args, symm=symm, ranges=ranges)

    def prep_plain(ranges=True):
        return pmajor.pair_prep_plain(*args, symm=symm, ranges=ranges)

    slab_a, ranges = prep()
    want_a, want_r = prep_plain()
    err = max(exact("pair_prep slab A", slab_a, want_a),
              exact("pair_prep ranges", ranges, want_r))
    alone, none = prep(False)
    check(none is None, "pair_prep without the ranges returned ranges")
    exact("pair_prep slab A without the ranges", alone, want_a)
    table_bytes = 4 * (nx * ny + 1)
    coef = pmajor.coef_stack(pr.diameter, pr.target_pressure, pr.spring_overlap_balance)
    out_a = pmajor.pm_pass(slab_a, ranges, coef, "a", symm=symm)
    fold = sc.fold_pairs and not sc.enable_spring
    glue = (slab_a, out_a, pr.ignored_pressure, pr.surface_smoothing,
            pr.pressure_amplifier if fold else None)

    def slab_b():
        return pmajor.pass_b_prep(*glue)

    def slab_b_plain():
        return pmajor.pass_b_prep_plain(*glue)

    got, want = slab_b(), slab_b_plain()
    err_b = max(exact("pass_b_prep slab B", got[0], want[0]),
                exact("pass_b_prep cell pressure", got[1], want[1]))
    rows = [kernel_row("pm_prep", PREP_SOURCE, PREP_REPLACES, err, cuda_ms(prep, 20),
                       cuda_ms(prep_plain, 5), (21 + 56) * P + table_bytes, 0.0),
            kernel_row("pm_slab_b", PREP_SOURCE, PREP_REPLACES_B, err_b, cuda_ms(slab_b, 20),
                       cuda_ms(slab_b_plain, 5), (36 + 36) * P, 0.0)]
    no_ranges = cuda_ms(lambda: prep(False), 20)
    searches = cuda_ms(lambda: pmajor.candidate_ranges(sorted_cid, alive, nx, ny), 5)
    print(f"  pair glue kernels == plain chains bit for bit ({P} slots, {int(alive.sum())} "
          f"alive, grid {nx}x{ny}; fold {fold}, symm {symm}); the cell table writes all "
          f"{nx * ny + 1} cells ({table_bytes / 1e6:.2f} MB)")
    print(f"  ranges: prep with {rows[0]['ms']:.4f} ms less prep without {no_ranges:.4f} ms "
          f"= {rows[0]['ms'] - no_ranges:.4f} ms (cell table + six reads a slot); "
          f"candidate_ranges (two searchsorteds) {searches:.4f} ms")
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain chain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"{r['bound_ms'] / r['ms']:.2f} (median, CUDA events)")
    return rows


def hard_cases(scene):
    """Phase 4, hard inputs: K1/K2 against their plain versions on every case
    of sand_crate_tpu_torch.ops.pmajor_cases (a range longer than a staged
    piece, tiles across grid rows, P not a multiple of the tile, P under one
    tile, a tail of dead selves), pass A and B folded, split and split with
    the spring, two-sided and one-sided noise: bit for bit."""
    from sand_crate_tpu_torch.ops import pmajor_cases

    import torch

    for case, c in pmajor_cases.CASES.items():
        f = pmajor_cases.facts(case, scene, "cuda")
        check(f["holds"], f"hard case {case}: the inputs miss what it exercises ({c.claim}): {f}")
        variants = pmajor_cases.variants(case, scene, "cuda")
        for label, run, plain in variants:
            exact(f"hard case {case}, {label}", run(), plain())
        k10 = pmajor_cases.k10_variants(case, scene, "cuda")
        for label, run, plain, k1k2 in k10:
            got = run()
            exact(f"hard case {case}, K10 {label}", got, plain())
            check(torch.equal(got, k1k2()), f"hard case {case}, K10 {label}: differs from K1/K2 "
                                            f"one-sided")
        print(f"  {case} ({c.claim}): P {f['P']}, {f['alive']} alive, longest range "
              f"{f['longest_range']}, a tile across {f['rows_spanned']} grid rows at most, "
              f"{f['dead_tiles']} dead tiles: {len(variants)} variants == plain bit for bit; "
              f"K10 {len(k10)} variants == plain and == K1/K2 one-sided bit for bit")


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


def k10_vs_plain(crate):
    """Phase (b): K10 (pms_pass) at both chunk sizes, passes A, B folded and
    B split with the spring, against its plain version and against K1/K2
    one-sided (pm_pass, symm off) on the same inputs at the crate's settled
    state: all bit-identical.  Returns the kernel rows at PMS_CHUNK."""
    import torch

    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops import pmajor

    st, sc, pr = crate.state, crate.scene, crate.params
    nx, ny = sc.grid_nx, sc.grid_ny
    sorted_cid, order = torch.sort(cell_ids_grid(st.pos, st.alive, sc), stable=True)
    alive = st.alive[order]
    slab_a = pmajor.pass_a_slab(st.pos[order], st.vel[order], alive, sorted_cid,
                                pr.diameter * pr.collider_noise_level, st.tick, sc, symm=False)
    ranges = pmajor.candidate_ranges(sorted_cid, alive, nx, ny)
    coef = pmajor.coef_stack(pr.diameter, pr.target_pressure, pr.spring_overlap_balance)
    out_a = pmajor.pm_pass(slab_a, ranges, coef, "a")
    cp = pmajor.finalize_cp(out_a[0], out_a[3], pr.ignored_pressure)
    variants = [  # (row name, mode, options, slab)
        ("pms_pass_a", "a", {}, slab_a),
        ("pms_pass_b", "b", dict(fold=True),
         pmajor.pass_b_slab(slab_a, out_a, cp * (1.0 + pr.pressure_amplifier),
                            pr.surface_smoothing)),
        ("pms_pass_b_split", "b", dict(spring=True),
         pmajor.pass_b_slab(slab_a, out_a, cp, pr.surface_smoothing)),
    ]
    P = slab_a.shape[0]
    n_alive = int(alive.sum())
    pairs = float(out_a[3].sum())
    spans = (ranges[3:] - ranges[:3]).sum(dim=0)[alive].float()
    print(f"  K1/K2 candidate tests per alive self: {float(spans.mean()):.2f} "
          f"(exact ranges); pairs within the cutoff per alive self: {pairs / n_alive:.2f}")
    rows = []
    for chunk in pmajor.PMS_CHUNKS:
        win = pmajor.chunk_windows(sorted_cid, alive, nx, ny, chunk)
        selves = (win[6] - torch.arange(win.shape[1], device=win.device) * chunk).clamp(min=0)
        lens = win[3:6] - win[:3]
        cand = lens.sum(dim=0)
        live = selves > 0
        found = pmajor.window_ranges(sorted_cid, win, chunk, nx)
        check(torch.equal(found[:, alive], ranges[:, alive]) and not found[:, ~alive].any(),
              f"chunk {chunk}: the in-window ranges differ from candidate_ranges")
        tiles = pmajor.tile_windows(found)
        staged = float((tiles[3:] - tiles[:3]).sum())
        print(f"  chunk {chunk}: {int(live.sum())} live chunks; candidates per chunk window "
              f"(3 row offsets): mean {float(cand[live].float().mean()):.2f} max "
              f"{int(cand[live].max())}, per row offset mean "
              f"{float(lens[:, live].float().mean()):.2f} (a self's binary search runs there); "
              f"ranges found == candidate_ranges; staged per alive self "
              f"{staged / n_alive:.3f}, walked per alive self {float(spans.mean()):.2f} (the "
              f"first port tested {float((cand * selves).sum()) / n_alive:.2f})")
        for name, mode, kw, slab in variants:
            def run(slab=slab, mode=mode, kw=kw, win=win, chunk=chunk):
                return pmajor.pms_pass(slab, sorted_cid, win, coef, mode, nx=nx, chunk=chunk, **kw)

            def plain(slab=slab, mode=mode, kw=kw, win=win, chunk=chunk):
                return pmajor.pms_pass_plain(slab, sorted_cid, win, coef, mode, nx=nx,
                                             chunk=chunk, **kw)

            def k1k2(slab=slab, mode=mode, kw=kw):
                return pmajor.pm_pass(slab, ranges, coef, mode, **kw)

            got = run()
            ref = plain()
            err = float((got - ref).abs().max())
            check(torch.equal(got, ref), f"{name} chunk {chunk}: kernel differs from its plain "
                                         f"version (max abs err {err})")
            check(torch.equal(got, k1k2()), f"{name} chunk {chunk}: differs from K1/K2 one-sided")
            ms, k1k2_ms = cuda_ms(run, 20), cuda_ms(k1k2, 20)
            n_out = got.shape[0]
            row = kernel_row(name, SOURCE, REPLACES_K10, err, ms,
                             cuda_ms(plain, 2) if chunk == pmajor.PMS_CHUNK else None,
                             (8 + 1 + n_out) * 4 * P + 7 * 4 * win.shape[1], pairs * PAIR_FLOPS)
            print(f"  {name} chunk {chunk}: == plain and == K1/K2 one-sided, bit for bit; "
                  f"K10 {ms:.4f} ms, K1/K2 one-sided {k1k2_ms:.4f} ms"
                  + (f", plain {row['plain_ms']:.2f} ms" if row["plain_ms"] else "")
                  + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}) (median, CUDA events)")
            if chunk == pmajor.PMS_CHUNK:
                rows.append(row)
    return rows


@contextlib.contextmanager
def knob(name):
    """Set the environment knob ``name`` to "1" for the block (None: none)."""
    if name is not None:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if name is not None:
            del os.environ[name]


@contextlib.contextmanager
def phase(label: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {label}: {time.perf_counter() - t0:.2f} s", flush=True)


class Phases:
    """A timer for instrumented_tick that keeps every phase's durations."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def median_ms(self, name):
        return statistics.median(self.times[name]) * 1e3


def pair_sums(crate):
    """The crate's p-major pair sums at its state, under the current knobs."""
    from sand_crate_tpu_torch.ops import pmajor

    st, pr = crate.state, crate.params
    return pmajor.neighbor_forces_pmajor(
        st.pos, st.vel, st.alive, pr.diameter * pr.collider_noise_level, st.tick,
        pr.diameter, pr.surface_smoothing, pr.target_pressure, pr.ignored_pressure,
        pr.spring_overlap_balance, crate.scene, pressure_amplifier=pr.pressure_amplifier)


def gate_path(crate):
    """Phase (d): GATE_TICKS ticks under SAND_CRATE_PMAJOR_GATE=1 launch
    K1/K2 and not K10; at the state after them, the gate's pair sums equal
    K10's bit for bit (both one-sided, the same pairs in the same order)."""
    import torch

    from sand_crate_tpu_torch.ops import pmajor

    with knob("SAND_CRATE_PMAJOR_GATE"):
        drive(crate, GATE_TICKS, "gate path", pmajor.LAUNCHES,
              {"a": GATE_TICKS, "b": GATE_TICKS, "sub_a": 0, "sub_b": 0, "prep": GATE_TICKS,
               "slab_b": GATE_TICKS}, allow_culls=True)
        gate = pair_sums(crate)
    with knob("SAND_CRATE_PMSUB"):
        sub = pair_sums(crate)
    default = pair_sums(crate)
    for name, a, b in zip(gate._fields, gate, sub):
        check(torch.equal(a, b), f"gate and PMSUB pair sums differ in {name}")
    check(not torch.equal(gate.dv_tension, default.dv_tension),
          "the gate's one-sided sums equal the default two-sided ones")
    print("  gate pair sums == PMSUB pair sums bit for bit (one-sided); != default (two-sided)")


def bench_entry():
    """Phase (e): python -m sand_crate_tpu_torch.bench at 1M on the default
    path, as a subprocess; its JSON line parses, its stderr line shows
    overflow 0."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("SAND_CRATE_PMSUB", "SAND_CRATE_PMAJOR_GATE")}
    cmd = [sys.executable, "-m", "sand_crate_tpu_torch.bench", "--particles", "1000000",
           "--ticks", str(BENCH_TICKS)]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(res.returncode == 0, f"bench entry exited {res.returncode}:\n{res.stderr[-3000:]}")
    result = json.loads(res.stdout.strip().splitlines()[-1])
    check(set(result) == {"metric", "value", "unit", "vs_baseline"}, f"bench keys {result}")
    line = [x for x in res.stderr.splitlines() if x.startswith("# ")][-1]
    print(f"bench entry ({' '.join(cmd[1:])}):\n  {line}\n  {json.dumps(result)}")
    check(" overflow=0 " in line and "non_finite=0" in line, "bench entry: overflow or non_finite")


def collisions_1m(crate):
    """Phase (f) at 1M: instrumented ticks from the crate's state (fold off,
    as Crate(instrument=True) builds it, and the spring on) under the
    default schedule, the gate and K10, in turns (A B C C B A, TURN_TICKS
    ticks each); prints each schedule's median Collisions phase and the sum
    of its phase medians.  Returns the K10 runs' launches (pass B is
    split+spring there)."""
    import dataclasses

    import torch

    from sand_crate_tpu_torch.instrument import instrumented_tick
    from sand_crate_tpu_torch.ops import pmajor

    scene = dataclasses.replace(crate.scene, fold_pairs=False, enable_spring=True)
    schedules = {"K1/K2 two-sided (default)": None,
                 "K1/K2 one-sided (SAND_CRATE_PMAJOR_GATE=1)": "SAND_CRATE_PMAJOR_GATE",
                 "K10 (SAND_CRATE_PMSUB=1)": "SAND_CRATE_PMSUB"}
    recs = {label: Phases() for label in schedules}
    launches = {label: dict.fromkeys(pmajor.LAUNCHES, 0) for label in schedules}
    for label in list(schedules) + list(reversed(schedules)):
        state = crate.state
        with knob(schedules[label]):
            reset(pmajor.LAUNCHES)
            for _ in range(TURN_TICKS):
                state, _ = instrumented_tick(state, crate.params, scene, crate.generator,
                                             recs[label])
            torch.cuda.synchronize()
            for key, n in pmajor.LAUNCHES.items():
                launches[label][key] += n
    for label, rec in recs.items():
        tick_ms = sum(rec.median_ms(k) for k in rec.times)
        print(f"  {label}: Collisions {rec.median_ms('Collisions'):.3f} ms of {tick_ms:.3f} ms "
              f"(medians over {2 * TURN_TICKS} ticks in two turns; sum of phase medians); "
              f"launches {launches[label]}")
    k10 = launches["K10 (SAND_CRATE_PMSUB=1)"]
    check(k10 == {"a": 0, "b": 0, "sub_a": 2 * TURN_TICKS, "sub_b": 2 * TURN_TICKS,
                  "prep": 2 * TURN_TICKS, "slab_b": 2 * TURN_TICKS},
          f"instrumented K10 launches {k10}")
    return k10


def instrument_10k(smi: str):
    """Phase (f) at 10k: Crate(instrument=True) (one replayed graph a phase
    after its first tick) against a fused run whose scene has
    fold_pairs=False, INSTRUMENT_TICKS ticks each: the same state, bit for
    bit; then the phase tables (phase_tables)."""
    import dataclasses

    import torch

    from sand_crate_tpu_torch import Crate

    world = dam_break_world(TRAJ_PARTICLES)
    inst = Crate(world, device="cuda", instrument=True)
    fused = Crate(world, device="cuda")
    fused.scene = dataclasses.replace(fused.scene, fold_pairs=False)
    check(not inst.scene.fold_pairs, "Crate(instrument=True) must build its scene with fold off")
    for _ in range(INSTRUMENT_TICKS):
        inst.physics_tick()
        fused.physics_tick()
    for name, a, b in zip(inst.state._fields, inst.state, fused.state):
        check(torch.equal(a, b), f"instrumented tick differs from the fused step in {name}")
    print(f"instrument: {inst.particle_count} particles x {INSTRUMENT_TICKS} ticks (the first "
          "eager and captured, then one replayed graph a phase), state == fused step (fold "
          "off) bit for bit; PhaseTimer:")
    print("  " + inst.debug_timer.report().rstrip().replace("\n", "\n  "))
    phase_tables(f"{inst.particle_count} particles", smi, inst)


def instrument_1m(crate, smi: str) -> dict:
    """Phase (f) at 1M: Crate(instrument=True) (fold off) from the settled
    p-major crate's state and generator state, its first tick eager and
    captured, then phase_tables; beside it the fused step with fold off,
    replayed, under the profiler (its kernel ms a tick).  Returns
    phase_tables' boundary counts."""
    import dataclasses

    from sand_crate_tpu_torch import Crate

    world = dam_break_world(N_TARGET)
    inst = Crate(world, device="cuda", instrument=True)
    inst.state = crate.state
    inst.generator.set_state(crate.generator.get_state())
    inst.physics_tick()
    launches = phase_tables(f"1M p-major ({inst.particle_count} particles, fold off)", smi, inst)
    del inst
    fused = Crate(world, device="cuda")
    fused.scene = dataclasses.replace(fused.scene, fold_pairs=False)
    fused.state = crate.state
    fused.run(1)
    print("  (f) the fused step at 1M, fold off, replayed: " + profiled(
        lambda n: [fused.graph.step(fused.scene, fused.generator) for _ in range(n)],
        PROFILED_TICKS))
    return launches


def phase_tables(label: str, smi: str, inst, ticks: int = INSTRUMENT_TICKS) -> dict:
    """Phase (f): the instrumented crate's phases replayed (its PhaseGraphs,
    already captured: one graph a phase, each closed by a synchronize) and
    run eagerly (instrument.instrumented_tick) from the same state and
    generator state, ``ticks`` ticks each: the same state and generator
    state bit for bit, a replay a phase and no capture; prints both
    PhaseTimer tables (median ms a phase) side by side.  Returns the
    boundary counters' rise over the replays (reset just before, read just
    after)."""
    import torch

    from sand_crate_tpu_torch import graphs
    from sand_crate_tpu_torch.instrument import KICKS, instrumented_tick

    s0, g0 = clone_state(inst.state), inst.generator.get_state()
    replayed, eager = Phases(), Phases()
    reset(graphs.LAUNCHES)
    reset_boundary()
    for _ in range(ticks):
        inst.phases.step(inst.scene, inst.generator, replayed)
    calls, g1 = dict(graphs.LAUNCHES), inst.generator.get_state()
    # the instrumented tick launches the update once a kick phase and once to integrate
    kicks = len([k for k in replayed.times if k in KICKS])
    bounds = check_boundary(f"(f) {label}", boundary_want(ticks, inst.scene.forces_mode,
                                                          staged=kicks))
    inst.generator.set_state(g0)
    state = s0
    for _ in range(ticks):
        state, _ = instrumented_tick(state, inst.params, inst.scene, inst.generator, eager)
    same_bits(f"(f) {label}: replayed phases vs the eager instrumented_tick", inst.state, state)
    check(torch.equal(inst.generator.get_state(), g1), f"(f) {label}: generator state")
    check(calls == {"replay": len(replayed.times) * ticks, "capture": 0, "evict": 0},
          f"(f) {label}: graph calls {calls}")
    print(f"  (f) {label} on {smi}: PhaseTimer medians over {ticks} ticks, replayed phases "
          f"(one graph each) / eager instrumented_tick, ms; state == bit for bit, graph calls "
          f"{calls}, launches {bounds}")
    for name in replayed.times:
        print(f"    {name:<22} {replayed.median_ms(name):9.4f} / {eager.median_ms(name):9.4f}")
    total = [sum(rec.median_ms(k) for k in rec.times) for rec in (replayed, eager)]
    print(f"    {'sum':<22} {total[0]:9.4f} / {total[1]:9.4f}")
    return bounds


def stream_10k():
    """Phase (g): Crate.stream_frames on the 10k world yields the frames of
    a synchronous physics.trajectory, bit for bit."""
    import numpy as np

    from sand_crate_tpu_torch import Crate
    from sand_crate_tpu_torch.physics import trajectory as sync_trajectory

    world = dam_break_world(TRAJ_PARTICLES)
    streamed, ref = Crate(world, device="cuda"), Crate(world, device="cuda")
    frames = list(streamed.stream_frames(STREAM_FRAMES, ticks_per_frame=2, chunk_frames=4))
    final, want = sync_trajectory(ref.state, ref.params, ref.scene, STREAM_FRAMES,
                                  ref.generator, 2)
    check(len(frames) == STREAM_FRAMES, f"{len(frames)} frames streamed")
    for key, value in want.items():
        check(np.array_equal(np.stack([f[key] for f in frames]), value.cpu().numpy()),
              f"stream_frames differs from trajectory in {key}")
    check(all(np.array_equal(a.cpu().numpy(), b.cpu().numpy())
              for a, b in zip(streamed.state, final)), "stream_frames' final state differs")
    print(f"stream_frames: {STREAM_FRAMES} frames of 2 ticks in chunks of 4 == trajectory, "
          f"bit for bit ({', '.join(f'{k} {tuple(v.shape)}' for k, v in want.items())})")


def grid_kernels_vs_plain(crate):
    """Phase 7: the grid kernels against their plain versions at the
    crate's current state, cell-sorted as the tick sorts it: the slab-order
    pass A (K4+K5) and emit pass B (K8+K9, spring off and on), bit for bit
    (and, through the dense plain versions on the placed grid, equal to the
    grid's sums); then the particle-order provider's kernels, place_grid
    (K3) and grid-mode pass B (K6+K7) on the placed G and PS, and emit mode
    equal to grid mode plus gather_pair_sums.  Returns (rows, sorted
    operands) for the provider phase."""
    import torch

    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops import pair_kernel as pk
    from sand_crate_tpu_torch.ops import placement as pl
    from sand_crate_tpu_torch.ops.pallas_forces import (
        gather_pair_sums, grid_width, pair_sums_from_planes,
    )

    st, sc, pr = crate.state, crate.scene, crate.params
    M, nx, ny = sc.cell_capacity, sc.grid_nx, sc.grid_ny
    nxp = grid_width(nx)
    sorted_cid, order = torch.sort(cell_ids_grid(st.pos, st.alive, sc), stable=True)
    pos, vel, alive = st.pos[order], st.vel[order], st.alive[order]
    slab, row_start, gather_slot, overflow = pl.slab_from_sorted(
        pos, alive, vel, sorted_cid, M, nx, ny)
    P, p_pad = pos.shape[0], slab.shape[1]
    n_alive = int(row_start[-1])
    amp = pr.diameter * pr.collider_noise_level
    coefs = (pr.diameter, pr.surface_smoothing, pr.target_pressure,
             pr.spring_overlap_balance, pr.ignored_pressure, amp, st.tick)
    spring = sc.enable_spring
    head = (slab, row_start, M, nx)

    # The windows the slab-order kernels stage (a warp tile of 32 columns)
    # and the candidates each self walks (its three cells per row offset).
    win = pk.tile_windows(slab, row_start, nx)
    rng = pk.cell_ranges(slab, row_start, nx)
    staged = float((win[3:] - win[:3]).clamp(min=0).sum()) / n_alive
    lens = (rng[3:] - rng[:3])[:, :n_alive]
    lens = torch.nn.functional.pad(lens, (0, -n_alive % pk.SLAB_TILE))
    steps = lens.view(3, -1, pk.SLAB_TILE).amax(dim=2).sum(dim=0)
    print(f"  slab-order tiles of {pk.SLAB_TILE} columns: {staged:.3f} candidates staged per "
          f"alive self (3 windows, the largest {int((win[3:] - win[:3]).sum(0).max())}); "
          f"walked per self {float(lens.sum()) / n_alive:.3f} (its 3 x 3 cells, over-cap "
          f"candidates included); a warp walks {float(steps.float().mean()):.2f} (its longest "
          f"range per row offset)")

    def pass_a():
        return pk.pair_pass_a(*head, pr.diameter, amp, st.tick)

    def pass_a_plain():
        return pk.pair_pass_a_slab_plain(*head, pr.diameter, amp, st.tick)

    ps = pass_a()
    err_a = exact("pair_pass_a", ps, pass_a_plain())
    check(torch.equal(ps, pk.pass_a_via_grid(*head, pr.diameter, amp, st.tick)),
          "pair_pass_a differs from the dense plain pass A on the placed grid")
    pairs = float(ps[pk.CNT].sum())

    def emit(spring=spring):
        return pk.pair_pass_b_emit(slab, ps, row_start, M, nx, *coefs, enable_spring=spring)

    def emit_plain(spring=spring):
        return pk.pair_pass_b_emit_plain(slab, ps, row_start, M, nx, *coefs,
                                         enable_spring=spring)

    out_e = emit()
    err_e = exact("pair_pass_b_emit", out_e, emit_plain())
    exact("pair_pass_b_emit, the other spring setting", emit(not spring), emit_plain(not spring))
    nb = out_e.shape[0]
    check(not out_e[:, n_alive:].any(), "emit: dead and padding columns are not zero")
    print(f"  pair_pass_a and pair_pass_b_emit (spring on and off) == plain bit for bit; "
          f"pass A == the dense plain pass A on the placed grid; {pairs:.0f} directed pairs, "
          f"{pairs / n_alive:.2f} per alive self")

    def place():
        return pl.place_grid(*head[:3], nx, ny, nxp)

    def place_plain():
        return pl.place_grid_plain(*head[:3], nx, ny, nxp)

    valid = slab[7] > 0
    cx, rank, row = (slab[r][valid].long() for r in (4, 5, 6))
    feats = slab[:4][:, valid]

    def place_library():  # the one-call scatter, timed as a yardstick only
        g = torch.zeros((4, ny + 2, M, nxp), dtype=torch.float32, device=slab.device)
        g[:, row + 1, rank, cx + 1] = feats
        return g

    grid = place()
    check(torch.equal(grid, place_plain()), "place_grid differs from its plain version")
    check(torch.equal(grid, place_library()), "place_grid differs from the index_put_ scatter")
    plane = grid[0].numel()
    occupied = int((grid[0] > pk.ALIVE_THRESHOLD).sum())
    print(f"  grid (4, {ny + 2}, {M}, {nxp}) of the particle-order provider: {occupied} of "
          f"{plane} slots occupied ({occupied / plane:.4f}); overflow {int(overflow)}; "
          f"place_grid exact")
    ps_grid = pl.place_grid(pl.with_features(slab, ps), row_start, M, nx, ny, nxp)

    def pass_b():
        return pk.pair_pass_b(grid, ps_grid, *coefs, enable_spring=spring)

    def pass_b_plain():
        return pk.pair_pass_b_plain(grid, ps_grid, *coefs, enable_spring=spring)

    out_g = pass_b()
    err_g = exact("pair_pass_b grid", out_g, pass_b_plain())
    exact("pair_pass_b grid, the other spring setting",
          pk.pair_pass_b(grid, ps_grid, *coefs, enable_spring=not spring),
          pk.pair_pass_b_plain(grid, ps_grid, *coefs, enable_spring=not spring))
    gathered = gather_pair_sums(out_g, gather_slot, M, nx, ny, nxp, spring, overflow,
                                torch.float32)
    emitted = pair_sums_from_planes(out_e[:, :P], spring, overflow, torch.float32)
    for name, a, b in zip(gathered._fields, gathered, emitted):
        check(torch.equal(a, b), f"emit mode differs from grid mode + gather_pair_sums in {name}")
    print("  pair_pass_b grid mode (spring on and off) == plain bit for bit; emit mode == grid "
          "mode + gather_pair_sums, bit for bit")

    # Bytes each function must move: the slab-order passes read their slab
    # rows (pass A: posx, posy, cx, rank, row, in_cap; emit: all eight and
    # the four pass-A rows) and row_start once and write their rows; a dense
    # output is written whole; of a dense input, the posx plane is read at
    # the occupied slots and at each interior cell's first empty slot (a
    # cell's slots are a prefix, so that finds its count), and the other
    # planes only at the occupied slots.
    f32 = 4
    occ_bytes = f32 * occupied  # one plane at the occupied slots
    rs_bytes = 4 * (ny + 1)
    counts = (grid[0, 1:-1] > pk.ALIVE_THRESHOLD).sum(dim=1)  # (ny, nxp) per interior cell
    posx_bytes = f32 * (occupied + int((counts < M).sum()))
    old_bound = bound(f32 * plane + 7 * occ_bytes + f32 * nb * ny * M * nxp, pairs * PAIR_FLOPS)
    print(f"  pair_pass_b_grid reads posx at {posx_bytes // f32} slots (the occupied and each "
          f"interior cell's first empty one) of {plane}; its bound counting the plane whole "
          f"was {old_bound[0]:.4f} ms ({old_bound[1]})")
    print(f"  window re-reads served by L2: pass A {staged * 24:.1f} B and emit {staged * 48:.1f} "
          f"B per alive self ({staged:.3f} staged candidates of 6 and 12 f32), against "
          f"{f32 * (6 + 4)} and {f32 * (12 + nb)} B per column that must move")
    rows = [
        kernel_row("place_grid", GRID_SOURCE, "sand_crate_tpu/ops/placement.py:145", 0.0,
                   cuda_ms(place, 20), cuda_ms(place_plain, 3),
                   f32 * 8 * p_pad + f32 * 4 * plane, 0.0, library_ms=cuda_ms(place_library, 20)),
        kernel_row("pair_pass_a", GRID_SOURCE, "sand_crate_tpu/ops/pair_kernel.py:193", err_a,
                   cuda_ms(pass_a, 20), cuda_ms(pass_a_plain, 2),
                   f32 * (6 + 4) * p_pad + rs_bytes, pairs * PAIR_FLOPS),
        kernel_row("pair_pass_b_grid", GRID_SOURCE, "sand_crate_tpu/ops/pair_kernel.py:666",
                   err_g, cuda_ms(pass_b, 20), cuda_ms(pass_b_plain, 2),
                   posx_bytes + 7 * occ_bytes + f32 * nb * ny * M * nxp, pairs * PAIR_FLOPS),
        kernel_row("pair_pass_b_emit", GRID_SOURCE, "sand_crate_tpu/ops/pair_kernel.py:707",
                   err_e, cuda_ms(emit, 20), cuda_ms(emit_plain, 2),
                   f32 * (8 + 4 + nb) * p_pad + rs_bytes, pairs * PAIR_FLOPS),
    ]
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f", index_put_ {r['library_ms']:.4f} ms" if r["library_ms"] else ""))
    return rows, (pos, vel, alive, sorted_cid, amp)


def grid_hard_cases(scene, device="cuda"):
    """Phase 7, hard inputs: the slab-order pass A (row offsets 0 and 5),
    emit pass B (spring off and on) and grid-mode pass B (spring off and on,
    row offsets 0 and 5, on G and PS placed from the case) against their
    plain versions on every case of sand_crate_tpu_torch.ops.grid_cases
    (cells deeper than the capacity, a window longer than a staged piece,
    tiles across grid rows, the grid's edge rows and columns, P < 32, P not
    a multiple of 32, a 40% dead tail), collider noise on: bit for bit."""
    from sand_crate_tpu_torch.ops import grid_cases

    for case, c in grid_cases.CASES.items():
        sc = grid_cases.case_scene(case, scene)
        f = grid_cases.facts(case, sc, device)
        check(f["holds"], f"grid hard case {case}: the inputs miss what it exercises "
                          f"({c.claim}): {f}")
        variants = grid_cases.variants(case, sc, device)
        for label, run, plain, _ in variants:
            exact(f"grid hard case {case}, {label}", run(), plain())
        grid_mode = grid_cases.grid_variants(case, sc, device)
        for label, run, plain in grid_mode:
            exact(f"grid hard case {case}, {label}", run(), plain())
        print(f"  {case} ({c.claim}): P {f['P']}, {f['alive']} alive, M {c.m_slots}, deepest "
              f"cell {f['deepest_cell']}, longest tile window {f['longest_window']}, a tile "
              f"across {f['rows_spanned']} grid rows at most, {f['dead_tiles']} dead tiles: "
              f"{len(variants)} slab-order and {len(grid_mode)} grid-mode variants == plain "
              f"bit for bit")


def grid_provider_path(crate, sorted_ops):
    """Phase 7, second part: the particle-order provider, the path that runs
    place_grid and grid-mode pass B, driven once with the counters reset;
    on cell-sorted operands it equals the sorted provider bit for bit."""
    import torch

    from sand_crate_tpu_torch.ops import pair_kernel as pk
    from sand_crate_tpu_torch.ops.pallas_forces import (
        neighbor_forces_pallas, neighbor_forces_pallas_sorted,
    )

    pos, vel, alive, sorted_cid, amp = sorted_ops
    pr, sc = crate.params, crate.scene
    args = (amp, crate.state.tick, pr.diameter, pr.surface_smoothing, pr.target_pressure,
            pr.ignored_pressure, pr.spring_overlap_balance, sc)
    sorted_sums = neighbor_forces_pallas_sorted(pos, vel, alive, sorted_cid, *args)
    reset(pk.LAUNCHES)
    sums = neighbor_forces_pallas(pos, vel, alive, *args)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    print(f"grid provider path: neighbor_forces_pallas once, launches {launches}")
    check(launches == {"place_grid": 2, "pair_pass_a": 1, "pair_pass_b_grid": 1,
                       "pair_pass_b_emit": 0}, "provider path launches")
    for name, a, b in zip(sums._fields, sums, sorted_sums):
        check(torch.equal(a, b), f"particle-order and sorted providers differ in {name}")
    print("  == the sorted provider bit for bit")
    return launches


def reset(counts: dict) -> None:
    for key in counts:
        counts[key] = 0


def by_uid(state, values):
    """``values`` (one per slot) reordered by particle identity (uid)."""
    out = values.clone()
    out[state.uid.long()] = values
    return out


def drive(crate, ticks: int, label: str, counts: dict, expected: dict, overflow_ref=None,
          allow_culls=False):
    """Run ``ticks`` ticks through Crate.run with ``counts`` reset first, and
    check the invariants of a closed box; returns (launches, steps/s, p50).
    ``overflow_ref(state)`` gives the independent overflow count of one
    tick from the state before it.  The alive count is conserved; with
    ``allow_culls`` it may fall by particles culled outside the box (the
    reference's cull, crate.py:149-159), at most RUNAWAY_SHARE of them, and
    each lost particle's frozen position must lie outside [-r, 1 + r]^2."""
    import torch

    from sand_crate_tpu_torch.physics import step

    n0 = crate.particle_count
    alive0 = by_uid(crate.state, crate.state.alive)
    reset(counts)
    reset_boundary()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    crate.run(ticks - 1)
    before = clone_state(crate.state)  # run advances the crate's state in place
    diag = crate.run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(counts)
    print(f"{label}: Crate.run({ticks}) launches {launches}, "
          f"{boundary_counts()}")
    check(launches == expected, f"{label}: launches {launches} != {expected}")
    launches.update(check_boundary(label, boundary_want(ticks, crate.scene.forces_mode)))
    check(int(diag.non_finite) == 0, f"non_finite {int(diag.non_finite)}")
    want = 0 if overflow_ref is None else overflow_ref(before)
    print(f"  overflow {int(diag.neighbor_overflow)} (independent count {want})")
    check(int(diag.neighbor_overflow) == want, "neighbor_overflow")
    st = crate.state
    alive1 = by_uid(st, st.alive)
    lost = alive0 & ~alive1
    culled = int(lost.sum())
    check(not bool((alive1 & ~alive0).any()), "a particle came alive in a closed box")
    check(int(diag.particle_count) == n0 - culled, f"alive count {int(diag.particle_count)} "
                                                   f"!= {n0} - {culled}")
    uids = torch.sort(st.uid[st.alive]).values
    check(bool((uids[1:] > uids[:-1]).all()), "uid over alive slots is not unique")
    if culled:
        r = crate.params.particle_radius
        frozen = by_uid(st, st.pos)[lost]
        outside = ((frozen < -r) | (frozen > 1.0 + r)).any(dim=1)
        print(f"  culled outside the box: {culled} of {n0} (frozen positions "
              f"{frozen[:4].cpu().tolist()}...)")
        check(allow_culls and culled <= RUNAWAY_SHARE * n0, f"{label}: {culled} particles lost")
        check(bool(outside.all()), f"{label}: a lost particle died inside the box")
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
    return launches, ticks / wall, p50, wall


def tick_memory(crate):
    """Phase 8: the device memory that one slot-grid tick allocates beyond
    what is held before it, against the dense slot grid (4, NYP, M, NXP) f32
    that the tick does not build: it must stay below G and PS together,
    which the tick placed and zeroed when its passes read the grid."""
    import torch

    from sand_crate_tpu_torch.ops.pallas_forces import grid_width
    from sand_crate_tpu_torch.physics import step

    sc = crate.scene
    grid_bytes = 4 * 4 * (sc.grid_ny + 2) * sc.cell_capacity * grid_width(sc.grid_nx)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(crate.state, crate.params, crate.scene, crate.generator)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    print(f"  one tick's peak allocation beyond what it holds: {extra / 1e6:.1f} MB; one dense "
          f"slot grid (4, {sc.grid_ny + 2}, {sc.cell_capacity}, {grid_width(sc.grid_nx)}) f32 "
          f"is {grid_bytes / 1e6:.1f} MB")
    check(extra < 2 * grid_bytes, "the slot-grid tick allocates as much as G and PS")


def over_capacity(crate, M: int):
    """An independent overflow count: the alive particles past ``M`` in
    their cell, by bincount over the cell ids that the next tick sorts by
    (cull, bodies and the hard-wall fix applied to ``state`` as the tick
    applies them)."""
    import torch

    from sand_crate_tpu_torch import physics
    from sand_crate_tpu_torch.cellwise import cell_ids_grid

    def count(state):
        pr, sc = crate.params, crate.scene
        s = physics.advance_bodies(physics.cull_particles(state, pr), pr, sc)
        cid = cell_ids_grid(physics.ghost_phase(s, pr, sc).pos, s.alive, sc)
        per_cell = torch.bincount(cid[s.alive].long(), minlength=sc.num_cells)
        return int(torch.clamp(per_cell - M, min=0).sum())

    return count


def uid_aligned(crate):
    s = crate.state
    order = s.uid.long().cpu().argsort()
    return s.pos.cpu()[order], s.vel.cpu()[order], s.alive.cpu()[order]


def trajectory(label: str, forces_mode: str, swaps, counts: dict, expected: dict,
               n_target: int = TRAJ_PARTICLES):
    """A dam break of ``n_target`` (~10k) particles for TRAJ_TICKS ticks on the card, on the
    kernel path (Crate.run: replays of the captured tick) and with ``swaps``
    ((module, name, plain), ...) in place in an explicit eager loop of
    physics.step (a graph keeps the launches it captured, and the plain
    versions read the host, which a capture refuses); the kernel run must
    launch the kernels as ``expected``, the plain run none, and the two
    agree uid-aligned."""
    import torch

    from sand_crate_tpu_torch import Crate
    from sand_crate_tpu_torch.physics import step

    from sand_crate_tpu_torch.ops import boundary, kick

    world = dam_break_world(n_target)
    with_kernels = Crate(world, device="cuda", forces_mode=forces_mode)
    with_plain = Crate(world, device="cuda", forces_mode=forces_mode)
    swaps = list(swaps) + [(boundary, "ghost_pass", boundary.ghost_pass_plain),
                           (boundary, "ghost_pos", boundary.ghost_pos_plain),
                           (kick, "update", kick.update_plain)]
    reset(counts)
    reset_boundary()
    with_kernels.run(TRAJ_TICKS)
    after_kernels = dict(counts)
    check_boundary(f"{label}: the kernel run", boundary_want(TRAJ_TICKS, forces_mode))
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        state = with_plain.state
        for _ in range(TRAJ_TICKS):
            state, _ = step(state, with_plain.params, with_plain.scene, with_plain.generator)
        with_plain.state = state
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)
    check(after_kernels == expected and counts == after_kernels,
          f"{label}: the kernel run must launch the kernels once a tick and the plain run none")
    check_boundary(f"{label}: the plain run (none)", boundary_want(TRAJ_TICKS, forces_mode))
    pk, vk, ak = uid_aligned(with_kernels)
    pp, vp, ap = uid_aligned(with_plain)
    check(torch.equal(ak, ap), f"{label}: alive masks differ")
    dpos = float((pk[ak] - pp[ap]).abs().max())
    dvel = float((vk[ak] - vp[ap]).abs().max())
    print(f"{label}: {int(ak.sum())} particles x {TRAJ_TICKS} ticks, kernel path vs "
          f"plain path on the card: max |dpos| {dpos:.3e}, max |dvel| {dvel:.3e}, "
          f"launches {after_kernels}")
    torch.testing.assert_close(pk[ak], pp[ap], rtol=2e-3, atol=2e-4)


def kernel_name(symbol: str) -> str:
    """A mangled kernel symbol as name<template args>, e.g. pms_kernel<0, 6, 32>."""
    import re

    m = re.match(r"_ZN(\d+)", symbol)
    if not m:
        return symbol
    rest = symbol[m.end() + int(m.group(1)):]  # past the namespace
    m = re.match(r"(\d+)", rest)
    if not m:
        return symbol
    end = m.end() + int(m.group(1))
    args = re.findall(r"L[ib](\d+)E", rest[end:].split("EEv")[0] + "E")
    return f"{rest[m.end():end]}<{', '.join(args)}>"


def print_ptxas(names) -> None:
    """Registers, shared memory and spills of every kernel built."""
    import re

    from sand_crate_tpu_torch.ops import cuda_build

    for name in names:
        entry = "?"
        for line in cuda_build.BUILD_LOGS.get(name, "").splitlines():
            m = re.search(r"(?:entry function|Function properties for) '?(\w+)'?", line)
            if m:
                entry = kernel_name(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.split(':', 1)[-1].strip()}")


def probe_row(name, replaces, got, ref, plain_ms, n_bytes, f32_ops, bf16_ops=0.0):
    """A kernels-line row of a probe, checked bit-identical to its plain
    version on the same device inputs; its ms and launches come from the
    probe's main (:func:`finish_row`)."""
    import torch

    err = float((got.float() - ref.float()).abs().max()) if got.numel() else 0.0
    check(torch.equal(got, ref), f"{name}: kernel differs from its plain version (max abs err {err})")
    bound_ms, bound_by = bound(n_bytes, f32_ops, bf16_ops)
    return dict(name=name, route="cuda", source=PROBE_SOURCE, replaces=replaces,
                launches=None, max_abs_err=err, ms=None, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def probe_main(labels, run):
    """One probe's main (the tool's entry point) on the card, with
    probes.LAUNCHES reset just before and read just after: every kernel of
    ``labels`` must launch.  Returns (main's times, the launches)."""
    import torch

    from sand_crate_tpu_torch import probes

    reset(probes.LAUNCHES)
    times = run()
    torch.cuda.synchronize()
    launches = {k: probes.LAUNCHES[k] for k in labels}
    print(f"  launches: {launches}")
    check(all(n > 0 for n in launches.values()), f"a probe kernel of {labels} was not launched")
    return times, launches


def finish_row(row, ms, launches):
    row.update(ms=ms, launches=launches)
    print(f"  {row['name']}: == plain bit for bit; kernel {ms:.4f} ms (the probe's main), plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{launches} launches (median, CUDA events)")


def p1_probe(crate):
    """Phase (h), P1: tools/pmajor_probe.py's kernel at the crate's settled
    state, modes a and b at W + 128 and W + 256, against its plain version;
    then the probe's main on the same crate.  Returns the rows at W + 256."""
    from sand_crate_tpu_torch.probes import pmajor_probe as p1

    st, sc, pr = crate.state, crate.scene, crate.params
    slab, sorted_cid = p1.sorted_slab(st, pr, sc)
    slab_p, dma_lo, ws, _ = p1.prepare(slab, sorted_cid, sc.grid_nx, sc.grid_ny)
    coef = p1.coefficients(pr.diameter, slab.device)
    nblocks, nchunks = dma_lo.shape[0], ws.shape[0] // 3
    # The kernel's 1 / sqrt (inv_sqrt_rn) is exact for nd2 in [2^-100, 2^127];
    # nd2 >= 1e-12 by its clamp, and at most the squared span of the slab's
    # positions (the padding's zeros included) widened by the jitter.
    span = slab_p[:2].amax(dim=1) - slab_p[:2].amin(dim=1) + 0.1 * coef[0]
    nd2_max = float((span * span).sum())
    print(f"  P1 nd2 in [1e-12, {nd2_max:.4f}] (inv_sqrt_rn exact in [2^-100, 2^127]); "
          f"dynamic shared memory a CTA: a {p1.shared_bytes('a')} B, b {p1.shared_bytes('b')} B")
    check(nd2_max < 2.0**127, f"P1 nd2 reaches {nd2_max}, past inv_sqrt_rn's exact range")
    rows = {}
    for mode in ("a", "b"):
        for w in (PROBE_W + 128, PROBE_W + 256):
            def plain(mode=mode, w=w):
                return p1.probe_plain(slab_p, dma_lo, ws, coef, w, mode)

            got = p1.probe(slab_p, dma_lo, ws, coef, w, mode)
            count = float(got[:, 3 if mode == "a" else 6].sum())
            check(count > 0, f"P1 mode {mode} W {w}: no pair within the cutoff")
            print(f"  P1 mode {mode} W {w}: {count:.0f} (self, candidate) pairs within the "
                  f"cutoff, {count / (nchunks * 128):.2f} per self")
            rows[mode, w] = probe_row(f"pmajor_probe_{mode}_w{w}", PROBE_REPLACES["pmajor_probe"],
                                      got, plain(), cuda_ms(plain, 1), p1.io_bytes(nblocks, w),
                                      p1.operations(mode, nchunks, w))
    print(f"-- python -m sand_crate_tpu_torch.probes.pmajor_probe (this crate) W {PROBE_W} all")
    times, launches = probe_main(("pmajor_probe_a", "pmajor_probe_b"),
                                 lambda: p1.main(w=PROBE_W, mode="all", crate=crate))
    for (mode, w), row in rows.items():
        finish_row(row, times[mode, w], launches[f"pmajor_probe_{mode}"])
        print(f"  P1 {mode} W {w}: {row['bound_ms'] / row['ms']:.3f} of its bound")
    return [rows[mode, PROBE_W + 256] for mode in ("a", "b")]


def p2_probe(crate):
    """Phase (h), P2: tools/passa_probe.py's variants at the crate's settled
    slot grid (16 slots) and its 8-slot copy, against their plain versions;
    then the probe's main on the same crate, every variant on both grids,
    with the shipped pair_pass_a.  Returns the 16-slot rows."""
    import torch

    from sand_crate_tpu_torch.probes import passa_probe as p2

    grid = p2.crate_grid(crate)
    tr = p2.row_block(grid.shape[3])
    coef, ticks = p2.coefficients(crate.params.diameter, grid.device)
    rows = {}
    for tag, g in (("m16", grid), ("m8", grid[:, :, :p2.M_LO].contiguous())):
        occ = p2.block_flags(g, tr)
        print(f"  [{tag}] grid {tuple(g.shape)}, tr {tr}: {int(occ.sum())} of {occ.shape[0]} "
              "row blocks occupied")
        for mode in p2.VARIANTS:
            def plain(g=g, occ=occ, mode=mode):
                return p2.variant_plain(g, occ, coef, ticks, tr, mode)

            got = p2.variant(g, occ, coef, ticks, tr, mode)
            if mode in ("full", "bf16"):
                occupied = g[0, :, :p2.M_LO] > p2.ALIVE_THRESHOLD
                counted = float((got[3, :, :p2.M_LO][occupied] > 0).float().mean())
                check(counted > 0.9, f"P2 {tag} {mode}: {counted:.3f} of the occupied slots count pairs")
            f32_ops, bf16_ops = p2.operations(mode, occ, g.shape, tr)
            rows[tag, mode] = probe_row(
                f"passa_{mode}_{tag}",
                PROBE_REPLACES["passa_prefetch" if mode == "prefetch" else "passa"], got, plain(),
                cuda_ms(plain, 1), p2.io_bytes(occ, g.shape, tr), f32_ops, bf16_ops)
            del got
    del grid, g
    torch.cuda.empty_cache()
    print("-- python -m sand_crate_tpu_torch.probes.passa_probe (this crate), every variant on "
          "both grids")
    times, launches = probe_main(
        [f"passa_{mode}" for mode in p2.VARIANTS],
        lambda: p2.main(modes={"m16": p2.VARIANTS, "m8": p2.VARIANTS}, crate=crate))
    for (tag, mode), row in rows.items():
        finish_row(row, times[tag, mode], launches[f"passa_{mode}"])
    print(f"  pair_pass_a (shipped, slab order, the same main): {times['m16', 'shipped']:.4f} ms")
    return [rows["m16", mode] for mode in p2.VARIANTS]


def p4_p3_probes():
    """Phase (h), P4 and P3 at the tools' sizes: every kernel against its
    plain version (P3 on the tool's inputs and on equal rw columns), then
    each probe's main; P3's two inputs must time within PROBE_P3_SPREAD."""
    from sand_crate_tpu_torch.probes import bf16_probe as p4
    from sand_crate_tpu_torch.probes import hybrid_probe as p3

    rows = []
    n = p4.BLOCKS * p4.ROWS * p4.COLS
    for kind in p4.KINDS:
        x = p4.make_input(kind, device="cuda")
        got = p4.chain(x, kind, PROBE_ITERS)
        if kind == "mixed":
            check(float((got != 0).float().mean()) > 0.4, "P4 mixed: the mask passes no element")
        f32_ops, bf16_ops = p4.operations(kind, PROBE_ITERS, n)
        rows.append(probe_row(
            f"bf16_{'mixed' if kind == 'mixed' else 'chain_' + kind}",
            PROBE_REPLACES["bf16_mixed" if kind == "mixed" else "bf16_chain"], got,
            p4.chain_plain(x, kind, PROBE_ITERS),
            cuda_ms(lambda: p4.chain_plain(x, kind, PROBE_ITERS), 2), p4.io_bytes(kind, n),
            f32_ops, bf16_ops))
    print(f"-- python -m sand_crate_tpu_torch.probes.bf16_probe {PROBE_ITERS}")
    times, launches = probe_main([r["name"] for r in rows], lambda: p4.main(PROBE_ITERS))
    for kind, row in zip(p4.KINDS, rows):
        finish_row(row, times[kind], launches[row["name"]])
    p3_rows = {}
    for equal_rw in (True, False):
        sfeat, cand = p3.make_inputs(device="cuda", equal_rw=equal_rw)
        frac = p3.mask_fraction(sfeat, cand)
        print(f"  P3 inputs {'equal rw' if equal_rw else 'of the tool'}: mask holds for "
              f"{frac:.4f} of the elements")
        if equal_rw:
            check(frac > 0.3, "P3 equal-rw inputs: the mask holds too rarely")
        for hybrid in (False, True):
            got = p3.chain(sfeat, cand, PROBE_ITERS, hybrid)
            ref = p3.chain_plain(sfeat, cand, PROBE_ITERS, hybrid)
            if equal_rw:  # the tool's inputs are all but zero; these are the row's
                f32_ops, bf16_ops = p3.operations(hybrid, PROBE_ITERS, got.numel())
                p3_rows["hybrid bf16" if hybrid else "f32 chain"] = probe_row(
                    f"hybrid_{'bf16' if hybrid else 'f32'}", PROBE_REPLACES["hybrid"], got, ref,
                    cuda_ms(lambda: p3.chain_plain(sfeat, cand, PROBE_ITERS, hybrid), 2),
                    p3.io_bytes(sfeat.shape[0], cand.shape[1]), f32_ops, bf16_ops)
            else:
                check(bool((got == ref).all()), "P3 on the tool's inputs differs from its plain version")
    print(f"-- python -m sand_crate_tpu_torch.probes.hybrid_probe {PROBE_ITERS}")
    times, launches = probe_main(("hybrid_f32", "hybrid_bf16"), lambda: p3.main(PROBE_ITERS))
    for form, row in p3_rows.items():
        finish_row(row, times[form, "equal rw"], launches[row["name"]])
        a, b = times[form, "random rw"], times[form, "equal rw"]
        spread = abs(a - b) / max(a, b)
        print(f"  P3 {form}: tool's inputs {a:.4f} ms, equal rw {b:.4f} ms, spread {spread:.3f}")
        check(spread <= PROBE_P3_SPREAD, f"P3 {form}: the two inputs time {spread:.3f} apart")
    return rows + list(p3_rows.values())


def probe_hard_cases():
    """Phase (h), the hard inputs of probes/probe_cases.py: both P1 modes,
    every P2 variant, both P3 forms and all three P4 kinds on each of their
    cases, and every P2 variant at each compiled m (the m sweep), bit for bit
    against their plain versions, after checking that each case holds what
    it claims."""
    import torch

    from sand_crate_tpu_torch.probes import bf16_probe as p4
    from sand_crate_tpu_torch.probes import hybrid_probe as p3
    from sand_crate_tpu_torch.probes import passa_probe as p2
    from sand_crate_tpu_torch.probes import pmajor_probe as p1
    from sand_crate_tpu_torch.probes import probe_cases

    for case in probe_cases.PMAJOR_CASES:
        facts = probe_cases.pmajor_facts(case)
        check(facts["holds"], f"P1 case {case}: {facts}")
        slab_p, dma_lo, ws, coef, w = probe_cases.pmajor_inputs(case, "cuda")
        for mode in ("a", "b"):
            check(torch.equal(p1.probe(slab_p, dma_lo, ws, coef, w, mode),
                              p1.probe_plain(slab_p, dma_lo, ws, coef, w, mode)),
                  f"P1 case {case} mode {mode}: kernel differs from its plain version")
        print(f"  P1 {case} ({probe_cases.PMAJOR_CASES[case].claim}): {facts}; modes a and b "
              "== plain bit for bit")
    for case in probe_cases.CHAIN_CASES:
        facts = probe_cases.chain_facts(case)
        check(facts["holds"], f"P4 case {case}: {facts}")
        for kind in p4.KINDS:
            x, iters, a, b = probe_cases.chain_inputs(case, kind, "cuda")
            check(torch.equal(p4.chain(x, kind, iters, a, b), p4.chain_plain(x, kind, iters, a, b)),
                  f"P4 case {case} {kind}: kernel differs from its plain version")
        print(f"  P4 {case} ({probe_cases.CHAIN_CASES[case].claim}): {facts}; f32, bf16 and "
              "mixed == plain bit for bit")

    for case in probe_cases.PASSA_CASES:
        facts = probe_cases.passa_facts(case)
        check(facts["holds"], f"P2 case {case}: {facts}")
        grid, occ, coef, ticks, tr = probe_cases.passa_inputs(case, "cuda")
        for mode in p2.VARIANTS:
            got = p2.variant(grid, occ, coef, ticks, tr, mode)
            check(torch.equal(got, p2.variant_plain(grid, occ, coef, ticks, tr, mode)),
                  f"P2 case {case} {mode}: kernel differs from its plain version")
        print(f"  P2 {case} ({probe_cases.PASSA_CASES[case].claim}): {facts}; all "
              f"{len(p2.VARIANTS)} variants == plain bit for bit")
    for m_slots in probe_cases.SWEEP_SLOTS:
        grid, occ, coef, ticks, tr = probe_cases.passa_inputs(probe_cases.SWEEP_CASE, "cuda",
                                                              m_slots=m_slots)
        for mode in p2.VARIANTS:
            check(torch.equal(p2.variant(grid, occ, coef, ticks, tr, mode),
                              p2.variant_plain(grid, occ, coef, ticks, tr, mode)),
                  f"P2 {probe_cases.SWEEP_CASE} at M {m_slots} {mode}: kernel differs from its "
                  "plain version")
    print(f"  P2 m sweep ({probe_cases.SWEEP_CASE} at M = {probe_cases.SWEEP_SLOTS[0]}.."
          f"{probe_cases.SWEEP_SLOTS[-1]}, every compiled m): all {len(p2.VARIANTS)} variants "
          "== plain bit for bit")
    for case in probe_cases.HYBRID_CASES:
        facts = probe_cases.hybrid_facts(case)
        check(facts["holds"], f"P3 case {case}: {facts}")
        sfeat, cand, iters = probe_cases.hybrid_inputs(case, "cuda")
        for hybrid in (False, True):
            got = p3.chain(sfeat, cand, iters, hybrid)
            check(torch.equal(got, p3.chain_plain(sfeat, cand, iters, hybrid)),
                  f"P3 case {case} hybrid={hybrid}: kernel differs from its plain version")
        print(f"  P3 {case} ({probe_cases.HYBRID_CASES[case].claim}): {facts}; f32 and hybrid "
              "== plain bit for bit")


def recording_and_checkpoints(traj_dir):
    """Phase (i) on the stirring-cup world (emitters: the generator state
    matters): recorded frames, written to ``traj_dir``, read back; a
    restored checkpoint runs on as the uninterrupted crate, held against
    two uninterrupted runs."""
    import copy

    import numpy as np
    import torch

    from sand_crate_tpu_torch import Crate, load_config_dict
    from sand_crate_tpu_torch.bench import STIRRING_CUP
    from sand_crate_tpu_torch.recording import TrajectoryWriter, load_trajectory, trajectory_info

    world = load_config_dict(copy.deepcopy(STIRRING_CUP)).world_config
    crate, twin = Crate(world, device="cuda"), Crate(world, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        writer = TrajectoryWriter(traj_dir, shard_frames=8)
        frames = list(crate.stream_frames(CKPT_FRAMES, ticks_per_frame=2, chunk_frames=8))
        for f in frames:
            writer.append(f)
        writer.close(meta={"world": "stirring_cup"})
        back = list(load_trajectory(traj_dir))
        check(len(back) == CKPT_FRAMES == trajectory_info(traj_dir)["frames"],
              "recorded frame count")
        for f, g in zip(frames, back):
            for key in ("pos", "alive", "pressure", "segments"):
                check(np.array_equal(f[key], g[key]), f"recorded frames differ in {key}")
        print(f"recording: {CKPT_FRAMES} frames of 2 ticks, stream_frames -> TrajectoryWriter "
              f"({len(trajectory_info(traj_dir)['shards'])} shards) -> load_trajectory: equal; "
              f"{crate.particle_count} particles at tick {crate.tick}")
        path = crate.save_checkpoint(tmp / "ckpt.npz")
        t0 = crate.tick
        crate.run(CKPT_TICKS)
        twin.run(2 * CKPT_FRAMES + CKPT_TICKS)
        resumed = Crate(world, device="cuda", seed=1)
        resumed.restore_checkpoint(path)
        check(resumed.tick == t0, "restored tick")
        resumed.run(CKPT_TICKS)

    def differences(a, b):
        return {k: float((x.double() - y.double()).abs().max()) if x.is_floating_point()
                else int((x != y).sum()) for k, x, y in zip(a._fields, a, b)}

    twins = differences(crate.state, twin.state)
    resume = differences(crate.state, resumed.state)
    print(f"checkpoint at tick {t0}, {CKPT_TICKS} ticks on ({crate.particle_count} particles):")
    print(f"  two uninterrupted runs, one seed: max |difference| per field {twins}")
    print(f"  uninterrupted vs resumed:          max |difference| per field {resume}")
    check(crate.particle_count > 0, "stirring_cup emitted no particle")
    for k, d in twins.items():
        if d == 0:
            check(resume[k] == 0, f"resume differs in {k} where two uninterrupted runs agree")
        else:
            check(resume[k] <= d, f"resume differs in {k} by more than two uninterrupted runs")
    check(all(torch.equal(a, b) for a, b in zip(crate.params, resumed.params)),
          "restored coefficients differ")


def kernel_counts():
    """The pair and probe kernels' launch counters, as one dict (the
    boundary kernels, which run on every path, count apart:
    boundary_counts)."""
    from sand_crate_tpu_torch import probes
    from sand_crate_tpu_torch.ops import pair_batch, pair_kernel, pmajor

    return {**{f"pmajor.{k}": v for k, v in pmajor.LAUNCHES.items()},
            **{f"grid.{k}": v for k, v in pair_kernel.LAUNCHES.items()},
            **{f"probes.{k}": v for k, v in probes.LAUNCHES.items()},
            **{f"pairs.{k}": v for k, v in pair_batch.LAUNCHES.items()}}


def pair_want(counts: dict, mode: str, ticks: int) -> dict:
    """``counts``' keys with the pair kernels of backend ``mode`` launched
    ``ticks`` times each (once a pass a tick) and every other kernel 0."""
    want = dict.fromkeys(counts, 0)
    want.update(dict.fromkeys(PAIR_KEYS.get(mode, ()), ticks))
    return want


def reset_boundary() -> None:
    from sand_crate_tpu_torch.ops import boundary, kick

    reset(boundary.LAUNCHES)
    reset(kick.LAUNCHES)


def reset_kernel_counts() -> None:
    """Every kernel launch counter of the port to 0, the boundary's too."""
    from sand_crate_tpu_torch import probes
    from sand_crate_tpu_torch.ops import pair_batch, pair_kernel, pmajor

    reset(pmajor.LAUNCHES)
    reset(pair_kernel.LAUNCHES)
    reset(probes.LAUNCHES)
    reset(pair_batch.LAUNCHES)
    reset_boundary()


def profiled(run, ticks: int, top: int = 0) -> str:
    """``run(ticks)`` under torch.profiler (as profile_tick.py reads it): the
    host-clock ms a tick, the kernels' device ms a tick, the busy share
    (kernel time / wall time) and the kernel launches a tick; with ``top``,
    the device ms a tick of the ``top`` costliest kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(ticks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / ticks * 1e3
    events = prof.key_averages()
    kernel_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / ticks / 1e3
    calls = {e.key: e.count for e in events if e.key in LAUNCH_CALLS}
    launches = sum(calls.values())
    device_kernels = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    out = (f"profiled {ticks} ticks: wall {wall_ms:.3f} ms/tick (profiler on), kernels "
           f"{kernel_ms:.3f} ms/tick, busy share {kernel_ms / wall_ms:.3f}, "
           f"{launches / ticks:.0f} launches/tick "
           f"({', '.join(f'{k} {v / ticks:g}' for k, v in sorted(calls.items()))}), "
           f"{device_kernels / ticks:.0f} device kernels/tick")
    if top:
        kernels = sorted(((e.self_device_time_total / ticks / 1e3, e.key) for e in events
                          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                         reverse=True)
        out += "; costliest kernels (ms/tick): " + "; ".join(
            f"{short_kernel(k)} {ms:.4f}" for ms, k in kernels[:top])
    return out


def short_kernel(key: str) -> str:
    """A profiler kernel name, its return type and namespaces (anonymous,
    at::native) left out, cut to 90 characters."""
    key = key.replace("(anonymous namespace)::", "").replace("at::native::", "")
    return (key[5:] if key.startswith("void ") else key)[:90]


def small_crate(name: str, raw: dict, mode: str, smi: str, profile: bool) -> float:
    """(j)(a): one crate of the dict world ``raw`` on backend ``mode`` for
    SMALL_TICKS ticks (host clock closed by a synchronize) and P50_TICKS
    event-timed ticks, with ``profile`` PROFILED_TICKS more under the
    profiler; its invariants; returns steps/s."""
    import copy

    import torch

    from sand_crate_tpu_torch import Crate, load_config_dict
    from sand_crate_tpu_torch.physics import step

    world = load_config_dict(copy.deepcopy(raw)).world_config
    budget = int(world.coefficients["max_particles"])
    crate = Crate(world, device="cuda", forces_mode=mode)
    crate.run(5)  # first ticks allocate
    reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diag = crate.run(SMALL_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    check(launches == pair_want(launches, mode, SMALL_TICKS),
          f"{name} on {mode}: kernel launches {launches} (its pair kernels once a pass a tick, "
          f"nothing else)")
    launches = {k: v for k, v in launches.items() if v}
    launches.update(check_boundary(f"{name} on {mode}", boundary_want(SMALL_TICKS, mode)))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(P50_TICKS + 1)]
    state = crate.state
    events[0].record()
    for k in range(P50_TICKS):
        state, _ = step(state, crate.params, crate.scene, crate.generator)
        events[k + 1].record()
    torch.cuda.synchronize()
    p50 = statistics.median(events[k].elapsed_time(events[k + 1]) for k in range(P50_TICKS))
    crate.state = state
    st = crate.state
    n = crate.particle_count
    check(int(diag.non_finite) == 0 and int(diag.neighbor_overflow) == 0,
          f"{name} on {mode}: non_finite {int(diag.non_finite)}, "
          f"overflow {int(diag.neighbor_overflow)}")
    check(0 < n <= budget, f"{name} on {mode}: {n} particles, budget {budget}")
    uids = torch.sort(st.uid[st.alive]).values
    check(bool((uids[1:] > uids[:-1]).all()), f"{name} on {mode}: uids not unique")
    check(bool(torch.isfinite(st.pos[st.alive]).all()), f"{name} on {mode}: non-finite positions")
    sources_off = bool((st.tick >= crate.scene.src_active_ticks).all())
    if sources_off:
        alive0 = by_uid(st, st.alive)
        crate.run(SMALL_AFTER)
        alive1 = by_uid(crate.state, crate.state.alive)
        check(not bool((alive1 & ~alive0).any()), f"{name} on {mode}: a particle came alive "
                                                  "with every source stopped")
        r = crate.params.particle_radius
        frozen = by_uid(crate.state, crate.state.pos)[alive0 & ~alive1]
        check(bool(((frozen < -r) | (frozen > 1.0 + r)).any(dim=1).all()),
              f"{name} on {mode}: a particle died inside the box")
        kept = f"; sources stopped: {int(alive1.sum())} of {int(alive0.sum())} kept " \
               f"over {SMALL_AFTER} ticks (the rest culled outside the box)"
    else:
        kept = "; a source still emits"
    print(f"  {name} on {mode} ({smi}): capacity {crate.scene.capacity}, {n} particles at "
          f"tick {int(st.tick)}, {SMALL_TICKS / wall:.3f} steps/s ({wall / SMALL_TICKS * 1e3:.3f} "
          f"ms/step, host clock + synchronize; replayed graphs), eager loop step p50 {p50:.3f} ms "
          f"(CUDA events, "
          f"{P50_TICKS} ticks); launches {launches}{kept}")
    if profile:
        print(f"    {profiled(crate.run, PROFILED_TICKS)}")
    return SMALL_TICKS / wall


def vmapped_vs_solo(mode: str) -> None:
    """(j)(b): VMAP_CRATES dam-break crates without emitters and with
    viscosities of their own, vmapped, against each crate stepped alone
    with its params: uid-aligned at the step tolerance (batched reductions
    may round in another order on the card).  Dense without collider noise
    (a draw per crate), chunked with it (hashed)."""
    import torch

    from sand_crate_tpu_torch import Config, Params
    from sand_crate_tpu_torch.config import PlaybackConfig
    from sand_crate_tpu_torch.physics import step
    from sand_crate_tpu_torch.scene import init_state
    from sand_crate_tpu_torch.sweep import BatchedCrates, grid_params

    world = dam_break_world(600 if mode == "dense" else 1000)
    config = Config(world_config=world, playback_config=PlaybackConfig())
    base = Params.from_coefficients(world.coefficients, "cuda")
    if mode == "dense":
        base = base._replace(collider_noise_level=torch.zeros_like(base.collider_noise_level))
    batched = grid_params(base, {"viscosity": [2.0, 5.0, 8.0, 12.0][:VMAP_CRATES]})
    reset_kernel_counts()
    crates = BatchedCrates(config, batched, device="cuda", seed=7)
    check(crates.scene.forces_mode == mode, f"BatchedCrates picked {crates.scene.forces_mode}")
    crates.run(VMAP_TICKS // 2)
    crates.run(VMAP_TICKS - VMAP_TICKS // 2)
    counts = kernel_counts()
    check(counts == pair_want(counts, mode, VMAP_TICKS),
          f"vmapped {mode}: launches {counts} (its pair kernels once a pass a tick for the batch)")
    check_boundary(f"vmapped {mode}", boundary_want(VMAP_TICKS, mode))
    worst = 0.0
    for i in range(VMAP_CRATES):
        pr = Params(*(x[i] for x in batched))
        st = init_state(world, crates.scene, seed=7 + i)
        gen = torch.Generator(device="cuda")
        for _ in range(VMAP_TICKS):
            st, _ = step(st, pr, crates.scene, gen)
        ia, ib = st.uid.long().argsort(), crates.state.uid[i].long().argsort()
        alive = st.alive[ia]
        check(torch.equal(crates.state.alive[i][ib], alive), f"{mode} crate {i}: alive differs")
        for name in ("pos", "vel"):
            a, b = getattr(crates.state, name)[i][ib][alive], getattr(st, name)[ia][alive]
            worst = max(worst, float((a - b).abs().max()))
            torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)
    print(f"  vmapped vs solo, {mode}: {VMAP_CRATES} crates x {VMAP_TICKS} ticks of "
          f"{crates.particle_counts().tolist()} particles (capacity {crates.scene.capacity}): "
          f"max |difference| of pos and vel {worst:.3e}")


def datagen_1024(smi: str, mode: str) -> float:
    """(j)(c): run_datagen at BASELINE.json config #5's size on ``mode``;
    returns its crate-steps/s."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from sand_crate_tpu_torch import Params, load_config_dict
    from sand_crate_tpu_torch.bench import STIRRING_CUP
    from sand_crate_tpu_torch.recording import load_trajectory
    from sand_crate_tpu_torch.sweep import (DEFAULT_RANDOM_RANGES, BatchedCrates, random_params,
                                            run_datagen)

    config = load_config_dict(copy.deepcopy(STIRRING_CUP))
    reset_kernel_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = run_datagen(config, DATAGEN_CRATES, DATAGEN_TICKS, DATAGEN_EVERY, tmp,
                          seed=3, forces_mode=mode, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        frames = list(load_trajectory(tmp))
    launches = kernel_counts()
    check(launches == pair_want(launches, mode, DATAGEN_TICKS),
          f"run_datagen on {mode}: launches {launches} (its pair kernels once a pass a tick)")
    check_boundary(f"run_datagen on {mode}", boundary_want(DATAGEN_TICKS, mode))
    check(out["frames"] == len(frames) == DATAGEN_TICKS // DATAGEN_EVERY, "datagen frames")
    check(out["overflow"] == 0 and out["non_finite"] == 0,
          f"datagen overflow {out['overflow']}, non_finite {out['non_finite']}")
    counts = [int(f["alive"].sum()) for f in frames]
    for f in frames:
        check(f["pos"].shape[0] == DATAGEN_CRATES, "datagen frames lack the crate axis")
        check(bool(np.isfinite(f["pos"][f["alive"]]).all()), "datagen: non-finite positions")
    last = frames[-1]["alive"].sum(axis=1)
    check(bool((last > 0).all()), "datagen: a crate emitted nothing")
    batch = BatchedCrates(config, random_params(torch.Generator(device="cuda"),
                                                Params.from_coefficients(
                                                    config.world_config.coefficients, "cuda"),
                                                DEFAULT_RANDOM_RANGES, DATAGEN_CRATES),
                          device="cuda", forces_mode=mode)
    batch.run(DATAGEN_EVERY)
    profile = profiled(batch.run, PROFILED_TICKS, top=PROFILED_TOP)
    del batch
    steps = sum(counts) * DATAGEN_EVERY
    print(f"  run_datagen ({smi}): {DATAGEN_CRATES} stirring_cup crates x {DATAGEN_TICKS} ticks, "
          f"sampled every {DATAGEN_EVERY}, {mode} (capacity 640): {wall:.3f} s end to end "
          f"(shards written), {DATAGEN_CRATES * DATAGEN_TICKS / wall:.1f} crate-steps/s, "
          f"{steps / wall:.1f} particle-steps/s (particles counted at each sample: "
          f"{counts}), alive per crate at the end {int(last.min())}-{int(last.max())}; "
          f"peak memory {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    print(f"    a fresh batch after {DATAGEN_EVERY} ticks, {profile}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return DATAGEN_CRATES * DATAGEN_TICKS / wall, launches


def wave_64(smi: str, mode: str) -> float:
    """(j)(d): WAVE_CRATES wave_machine crates on ``mode``; returns
    crate-steps/s."""
    import copy

    import torch

    from sand_crate_tpu_torch import Params, load_config_dict
    from sand_crate_tpu_torch.bench import WAVE_MACHINE
    from sand_crate_tpu_torch.sweep import DEFAULT_RANDOM_RANGES, BatchedCrates, random_params

    config = load_config_dict(copy.deepcopy(WAVE_MACHINE))
    base = Params.from_coefficients(config.world_config.coefficients, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    crates = BatchedCrates(config, random_params(gen, base, DEFAULT_RANDOM_RANGES, WAVE_CRATES),
                           device="cuda", seed=5, forces_mode=mode)
    reset_kernel_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps, worst, bounds = 0, 0, []
    for _ in range(2):
        before = int(crates.particle_counts().sum())
        bounds.append(crates.live_rows(WAVE_TICKS // 2))
        diag = crates.run(WAVE_TICKS // 2)
        steps += (before + int(diag.particle_count.sum())) * (WAVE_TICKS // 2) // 2
        worst = max(worst, int(diag.neighbor_overflow.max()))
        check(int(diag.non_finite.max()) == 0, "wave crates: non-finite particles")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    check(launches == pair_want(launches, mode, WAVE_TICKS),
          f"{WAVE_CRATES} wave_machine crates on {mode}: launches {launches}")
    check_boundary(f"{WAVE_CRATES} wave_machine crates on {mode}", boundary_want(WAVE_TICKS, mode))
    check(worst == 0, f"wave crates: overflow {worst}")
    print(f"  {WAVE_CRATES} wave_machine crates on {mode} ({smi}): {WAVE_TICKS} ticks in two "
          f"runs (sweep bounds {bounds} of capacity {crates.scene.capacity}), {wall:.3f} s, "
          f"{steps / wall:.1f} particle-steps/s (mean of each run's first and last count), "
          f"{int(crates.particle_counts().sum())} particles at the end; overflow {worst}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"    {profiled(crates.run, PROFILED_TICKS, top=PROFILED_TOP)}")
    return WAVE_CRATES * WAVE_TICKS / wall, launches


def batched_crates(smi: str) -> dict:
    """Phase (j); returns the pair kernels' launches of (c) on dense and of
    (d) on chunked (BatchedCrates' defaults at those capacities)."""
    from sand_crate_tpu_torch.bench import STIRRING_CUP, WAVE_MACHINE
    from sand_crate_tpu_torch.scene import auto_forces_mode, default_capacity
    from sand_crate_tpu_torch.sweep import DENSE_MAX_CAPACITY

    # Dense and pmajor, the close pair, run twice in turns; chunked (4-5x
    # behind dense in every reading) once.
    print("(a) one crate per backend, in turns (dense, chunked, pmajor, pmajor, dense):")
    modes = ("dense", "chunked", "pmajor")
    for name, raw in (("stirring_cup", STIRRING_CUP), ("wave_machine", WAVE_MACHINE)):
        cap = default_capacity(raw["world"]["coefficients"]["max_particles"])
        rates = {mode: [] for mode in modes}
        for k, mode in enumerate(modes + ("pmajor", "dense")):
            rates[mode].append(small_crate(name, raw, mode, smi, profile=k < len(modes)))
        print(f"  {name}: auto picks {auto_forces_mode(cap)} at capacity {cap}; steps/s "
              + ", ".join(f"{m} " + " / ".join(f"{x:.3f}" for x in r) for m, r in rates.items()))
    print("(b) vmapped BatchedCrates vs each crate alone:")
    vmapped_vs_solo("dense")
    vmapped_vs_solo("chunked")
    # (c) and (d) run each batch on both vmappable backends, BatchedCrates'
    # default first: the evidence for its dense/chunked threshold.
    main = {}
    for label, run, name, cap in (("(c) batched datagen", datagen_1024, "stirring_cup", 640),
                                  ("(d) mid-size batch", wave_64, "wave_machine", 4096)):
        print(f"{label}:")
        first = "dense" if cap <= DENSE_MAX_CAPACITY else "chunked"
        other = "chunked" if first == "dense" else "dense"
        runs = {first: run(smi, first), other: run(smi, other)}
        main[first] = runs[first][1]
        print(f"  {name} batch: BatchedCrates picks {first} at capacity {cap}; crate-steps/s "
              + ", ".join(f"{m} {r:.1f}" for m, (r, _) in runs.items()))
    return main

# --------------------------------------------------------------------------
# (s) batched crates on every backend: K1/K2, K4+K5 and K8+K9 with a crate axis
# --------------------------------------------------------------------------


def each_crate(fn, *xs):
    """``fn`` on each crate's operands alone (the leading axis), stacked."""
    from sand_crate_tpu_torch.ops.crate_axis import crates_plain

    return crates_plain("each_crate", fn, xs)


def timed_once(fn):
    """(``fn()``, its ms on the host clock between two synchronizes): a
    plain version crate by crate, whose runs read the host, timed in the
    one run that its comparison needs."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def crate_axis_cases() -> None:
    """(s0): K1/K2, K10 (both chunk sizes) and the slab-order grid passes on
    the batched hard inputs of ops/pmajor_cases.py and ops/grid_cases.py
    (every case padded to one size, an empty crate, coefficients, noise and
    ticks per crate): one launch a pass for the batch, bit for bit the plain
    version and each crate's solo launch."""
    import torch

    from sand_crate_tpu_torch.ops import grid_cases, pair_kernel, pmajor, pmajor_cases
    from sand_crate_tpu_torch.scene import build_scene

    scene = build_scene(dam_break_world(N_TARGET), device="cuda")
    for name, cases, counter in (("K1/K2, K10", pmajor_cases, pmajor.LAUNCHES),
                                 ("K4+K5, K8+K9", grid_cases, pair_kernel.LAUNCHES)):
        f = cases.batch_facts(scene, "cuda")
        check(f["holds"], f"batched hard cases of {name}: alive counts {f['alive']} do not "
                          "differ widely or hold no empty crate")
        variants = cases.batch_variants(scene, "cuda")
        for label, run, plain, solo in variants:
            before = sum(counter.values())
            got = run()
            check(sum(counter.values()) == before + 1, f"{name} {label}: not one launch")
            exact(f"batched hard cases, {name} {label}", got, plain())
            check(torch.equal(got, solo()), f"batched hard cases, {name} {label}: the crate "
                                            "axis differs from the solo launches")
        print(f"  {name} on {len(f['alive'])} crates (alive {f['alive']}): {len(variants)} "
              f"variants, one launch each, == plain and == each crate's solo launch bit for bit")


def batch_gates(label: str, before, after, diag, radius, closed: bool) -> int:
    """The batch's invariants after a run from ``before``: non_finite 0 in
    every crate; uids unique among each crate's alive slots; every particle
    alive before still alive (``closed``: and no particle came alive), but
    those culled outside [-r, 1 + r], at most RUNAWAY_SHARE of the alive.
    Returns the culled count."""
    import torch

    check(int(diag.non_finite.max()) == 0, f"{label}: non_finite {diag.non_finite.tolist()}")
    for i in range(after.pos.shape[0]):
        uids = torch.sort(after.uid[i][after.alive[i]]).values
        check(bool((uids[1:] > uids[:-1]).all()), f"{label}: crate {i}'s uids are not unique")

    def by_uid(st, values):
        idx = st.uid.long().reshape(st.uid.shape + (1,) * (values.dim() - 2))
        return torch.zeros_like(values).scatter(1, idx.expand_as(values), values)

    a0 = by_uid(before, before.alive.to(torch.int8)) > 0
    a1 = by_uid(after, after.alive.to(torch.int8)) > 0
    lost = a0 & ~a1
    if closed:
        check(not bool((a1 & ~a0).any()), f"{label}: a particle came alive in a closed box")
    culled = int(lost.sum())
    if culled:
        r = radius[:, None, None]
        frozen = by_uid(after, after.pos)
        outside = ((frozen < -r) | (frozen > 1.0 + r)).any(dim=-1)
        check(bool(outside[lost].all()), f"{label}: a lost particle died inside the box")
        check(culled <= RUNAWAY_SHARE * int(a0.sum()), f"{label}: {culled} particles lost")
    return culled


def batch_run(label: str, smi: str, config, params, mode: str, forces_mode: str, seed: int,
              settle: int, closed: bool, start=None, crate_axis_rows=None) -> dict:
    """One batch on ``forces_mode`` through BatchedCrates (``mode``: its
    label in BATCH_MODES, which names its pair kernels and ghost passes;
    the caller sets its knob), from ``start`` (a
    (state, generator state) to copy in) if given: ``settle`` ticks (the
    first eager, then the capture), BATCH_CHECK_TICKS replayed ticks held
    bit for bit against the eager vmapped loop from the same state and
    generator, the gates (batch_gates), then BATCH_TIMED_TICKS replayed
    ticks timed (crate-steps/s on the host clock closed by a synchronize,
    step p50 from CUDA events; the card memory the batch holds, its state
    and its captured graph's pool: reserved after the timed ticks less
    reserved before the batch, each after empty_cache; the peak allocated
    over those ticks), the pair kernels counted once a pass a tick over
    those ticks, and PROFILED_TICKS under the profiler.  With
    ``crate_axis_rows``, that function's (kernel_counts key, kernel row)
    pairs at the settled batch.
    Returns the figures and the ticks the batch ran."""
    import torch

    from sand_crate_tpu_torch import graphs
    from sand_crate_tpu_torch.sweep import BatchedCrates

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    b = BatchedCrates(config, params, device="cuda", seed=seed, forces_mode=forces_mode)
    check(b.scene.forces_mode == forces_mode, f"{label}: BatchedCrates runs {b.scene.forces_mode}")
    if start is not None:
        b.state = start[0]
        b.generator.set_state(start[1])
    b.run(settle)
    s0, p0, g0 = clone_state(b.state), clone_state(b.params), b.generator.get_state()
    live = b.live_rows(BATCH_CHECK_TICKS)
    reset_kernel_counts()
    reset(graphs.LAUNCHES)
    diag = b.run(BATCH_CHECK_TICKS)
    calls = dict(graphs.LAUNCHES)
    g1 = b.generator.get_state()
    b.generator.set_state(g0)
    st, want, worst = eager_loop(s0, p0, b.scene, b.generator, BATCH_CHECK_TICKS, live,
                                 batched=True)
    check(torch.equal(b.generator.get_state(), g1), f"{label}: the generator advanced otherwise")
    same_bits(label, b.state, st)
    same_bits(label + " (diagnostics)", diag, want._replace(neighbor_overflow=worst))
    del st, want
    culled = batch_gates(label, s0, b.state, diag, p0.particle_radius, closed)
    if forces_mode == "pmajor":
        check(int(diag.neighbor_overflow.max()) == 0, f"{label}: overflow on pmajor")
    rows = crate_axis_rows(b) if crate_axis_rows else []
    live = b.live_rows(BATCH_TIMED_TICKS + 1)
    reset_kernel_counts()
    b.graph.step(b.scene, b.generator, live)  # a new sweep bound captures here
    events = [torch.cuda.Event(enable_timing=True) for _ in range(BATCH_TIMED_TICKS + 1)]
    del s0, p0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the replayed ticks' peak, not the checks'
    t0 = time.perf_counter()
    events[0].record()
    for k in range(BATCH_TIMED_TICKS):
        out_diag = b.graph.step(b.scene, b.generator, live)
        events[k + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p50 = statistics.median(events[k].elapsed_time(events[k + 1])
                            for k in range(BATCH_TIMED_TICKS))
    launches = kernel_counts()
    ticks = BATCH_TIMED_TICKS + 1
    check(launches == pair_want(launches, mode, ticks),
          f"{label}: launches {launches} (its pair kernels once a pass a tick for the batch)")
    bounds = check_boundary(label, boundary_want(ticks, mode))
    check(int(out_diag.non_finite.max()) == 0, f"{label}: non-finite particles in the timed run")
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - base
    check(held > 0, f"{label}: the batch holds no card memory ({held} bytes)")

    def replays(n):
        for _ in range(n):
            b.graph.step(b.scene, b.generator, live)

    profile = profiled(replays, PROFILED_TICKS, top=3)
    B = b.n
    counts = b.particle_counts()
    rate = B * BATCH_TIMED_TICKS / wall
    print(f"  {label} ({smi}): replayed == eager bit for bit over {BATCH_CHECK_TICKS} ticks "
          f"(graph calls {calls}, sweep bound {live}), culled {culled}; {rate:.1f} crate-steps/s "
          f"({counts.sum() * BATCH_TIMED_TICKS / wall:.1f} particle-steps/s), replayed step "
          f"p50 {p50:.4f} ms (CUDA events, {BATCH_TIMED_TICKS} ticks); card memory held "
          f"(state and graph pool, memory_reserved) {held / 2**30:.3f} GiB, peak allocated "
          f"over those ticks {peak / 2**30:.3f} GiB; alive per crate {int(counts.min())}-"
          f"{int(counts.max())}; overflow max {int(worst.max())}; pair kernels a tick "
          f"{ {k: v / ticks for k, v in launches.items() if v} }, {bounds}")
    print(f"    {profile}")
    return dict(b=b, rate=rate, p50=p50, held=held, launches=launches, rows=rows,
                ticks=settle + BATCH_CHECK_TICKS + ticks + PROFILED_TICKS)


def pm_crate_axis_rows(b, k10: bool = False) -> list:
    """The p-major crate-axis rows at the batch's state, in each crate's
    sorted order with the tick's noise and pass-B variant: K1/K2
    (pm_pass_crates) or, with ``k10`` (the batch runs under
    SAND_CRATE_PMSUB=1), K10 (pms_pass_crates, one-sided noise, each crate's
    chunk windows at PMS_CHUNK).  The one launch for all crates bit for bit
    the plain version and each crate's solo launch; kernel, plain and bound
    times for the batch.  Returns (kernel_counts key, row) pairs."""
    import torch

    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops import pmajor

    st, pr, sc = b.state, b.params, b.scene
    nx, ny, chunk = sc.grid_nx, sc.grid_ny, pmajor.PMS_CHUNK
    symm = sc.pmajor_symm and not k10
    check(pmajor.schedule() == ("pmsub" if k10 else "default"),
          f"p-major crate-axis rows under schedule {pmajor.schedule()}")

    def one(pos, vel, alive, tick, diam, noise, tp, bal):
        scid, order = torch.sort(cell_ids_grid(pos, alive, sc), stable=True)
        al = alive[order]
        slab = pmajor.pass_a_slab(pos[order], vel[order], al, scid, diam * noise, tick, sc,
                                  symm=symm)
        where = (pmajor.chunk_windows(scid, al, nx, ny, chunk) if k10
                 else pmajor.candidate_ranges(scid, al, nx, ny))
        return slab, scid, where, pmajor.coef_stack(diam, tp, bal)

    slab_a, cid, where, coef = torch.func.vmap(one)(
        st.pos, st.vel, st.alive, st.tick, pr.diameter, pr.collider_noise_level,
        pr.target_pressure, pr.spring_overlap_balance)
    B, P = slab_a.shape[:2]
    fold, spring = sc.fold_pairs and not sc.enable_spring, sc.enable_spring
    if k10:
        prefix, key = "pms", "sub_"
        crates, plain_fn, solo_fn = pmajor.pms_pass_crates, pmajor.pms_pass_plain, pmajor.pms_pass
        ops, base_kw = (cid, where, coef), dict(nx=nx, chunk=chunk)
        extra_bytes = 4 * P + 7 * 4 * where.shape[2]  # the cell ids and the windows
    else:
        prefix, key = "pm", ""
        crates, plain_fn, solo_fn = pmajor.pm_pass_crates, pmajor.pm_pass_plain, pmajor.pm_pass
        ops, base_kw = (where, coef), dict(symm=symm)
        extra_bytes = 6 * 4 * P  # the ranges
    rows = []
    for mode in ("a", "b"):
        name = f"{prefix}_pass_{mode}_crates"
        if mode == "a":
            slab, kw = slab_a, base_kw
        else:
            cp = pmajor.finalize_cp(out_a[:, 0], out_a[:, 3], pr.ignored_pressure[:, None])
            cp = cp * (1.0 + pr.pressure_amplifier[:, None]) if fold else cp
            slab = torch.func.vmap(pmajor.pass_b_slab)(slab_a, out_a, cp, pr.surface_smoothing)
            kw = dict(base_kw, fold=fold, spring=spring)

        def run(slab=slab, mode=mode, kw=kw):
            return crates(slab, *ops, mode, **kw)

        def plain(slab=slab, mode=mode, kw=kw):
            return each_crate(lambda *a: plain_fn(*a, mode, **kw), slab, *ops)

        before = pmajor.LAUNCHES[key + mode]
        got = run()
        check(pmajor.LAUNCHES[key + mode] == before + 1, f"{name}: not one launch for the batch")
        want, plain_ms = timed_once(plain)
        err = exact(f"{name} at {B} settled crates", got, want)
        check(torch.equal(got, each_crate(lambda *a: solo_fn(*a, mode, **kw), slab, *ops)),
              f"{name}: the crate axis differs from the solo launches")
        if mode == "a":
            out_a = got
            pairs = float(got[:, 3].sum())
        rows.append((f"pmajor.{key}{mode}", kernel_row(
            name, SOURCE, REPLACES_K10 if k10 else REPLACES, err, cuda_ms(run, 20), plain_ms,
            B * ((8 + got.shape[1]) * 4 * P + extra_bytes), pairs * PAIR_FLOPS)))
    print(f"  {'K10' if k10 else 'K1/K2'} at {B} settled crates of {P} slots (symm {symm}, fold "
          f"{fold}, spring {spring}), {pairs:.0f} directed pairs: == plain and == each crate's "
          "solo launch bit for bit; " + "; ".join(
              f"{r['name']} {r['ms']:.4f} ms (plain {r['plain_ms']:.2f}, bound "
              f"{r['bound_ms']:.4f} {r['bound_by']}, share {r['bound_ms'] / r['ms']:.2f})"
              for _, r in rows))
    return rows


def grid_crate_axis_rows(b) -> list:
    """K4+K5 and K8+K9's crate-axis (kernel_counts key, row) pairs at the
    batch's state, as pm_crate_axis_rows."""
    import torch

    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops import pair_kernel as pk
    from sand_crate_tpu_torch.ops import placement as pl

    st, pr, sc = b.state, b.params, b.scene
    M, nx, ny, spring = sc.cell_capacity, sc.grid_nx, sc.grid_ny, sc.enable_spring

    def one(pos, vel, alive):
        scid, order = torch.sort(cell_ids_grid(pos, alive, sc), stable=True)
        return pl.slab_from_sorted(pos[order], alive[order], vel[order], scid, M, nx, ny)[:2]

    slab, row_start = torch.func.vmap(one)(st.pos, st.vel, st.alive)
    amp = pr.diameter * pr.collider_noise_level
    coef_a = torch.stack([pr.diameter, amp], dim=1)
    coef_b = torch.stack([pr.diameter, pr.surface_smoothing, pr.target_pressure,
                          pr.spring_overlap_balance, amp, pr.ignored_pressure], dim=1)
    tick = st.tick.to(torch.int32)
    B, p_pad = slab.shape[0], slab.shape[2]

    def run_a():
        return pk.pair_pass_a_crates(slab, row_start, M, nx, coef_a, tick)

    def plain_a():
        return each_crate(lambda s, r, c, t: pk.pair_pass_a_slab_plain(s, r, M, nx, c[0], c[1], t),
                          slab, row_start, coef_a, tick)

    def solo_a():
        return each_crate(lambda s, r, c, t: pk.pair_pass_a(s, r, M, nx, c[0], c[1], t),
                          slab, row_start, coef_a, tick)

    before = pk.LAUNCHES["pair_pass_a"]
    ps = run_a()
    check(pk.LAUNCHES["pair_pass_a"] == before + 1, "pair_pass_a: not one launch for the batch")
    want, plain_a_ms = timed_once(plain_a)
    err_a = exact(f"pair_pass_a at {B} settled crates", ps, want)
    check(torch.equal(ps, solo_a()), "pair_pass_a: the crate axis differs from the solo launches")
    pairs = float(ps[:, pk.CNT].sum())

    def run_b():
        return pk.pair_pass_b_emit_crates(slab, ps, row_start, M, nx, coef_b, tick,
                                          enable_spring=spring)

    def b_args(s, p, r, c, t):  # c: coef_b's order
        return (s, p, r, M, nx, c[0], c[1], c[2], c[3], c[5], c[4], t)

    def plain_b():
        return each_crate(lambda *a: pk.pair_pass_b_emit_plain(*b_args(*a), enable_spring=spring),
                          slab, ps, row_start, coef_b, tick)

    before = pk.LAUNCHES["pair_pass_b_emit"]
    out = run_b()
    check(pk.LAUNCHES["pair_pass_b_emit"] == before + 1,
          "pair_pass_b_emit: not one launch for the batch")
    want, plain_b_ms = timed_once(plain_b)
    err_b = exact(f"pair_pass_b_emit at {B} settled crates", out, want)
    check(torch.equal(out, each_crate(
        lambda *a: pk.pair_pass_b_emit(*b_args(*a), enable_spring=spring),
        slab, ps, row_start, coef_b, tick)),
        "pair_pass_b_emit: the crate axis differs from the solo launches")
    f32, rs_bytes, nb = 4, 4 * (ny + 1), out.shape[1]
    rows = [
        ("grid.pair_pass_a", kernel_row(
            "pair_pass_a_crates", GRID_SOURCE, "sand_crate_tpu/ops/pair_kernel.py:193", err_a,
            cuda_ms(run_a, 20), plain_a_ms, B * (f32 * (6 + 4) * p_pad + rs_bytes),
            pairs * PAIR_FLOPS)),
        ("grid.pair_pass_b_emit", kernel_row(
            "pair_pass_b_emit_crates", GRID_SOURCE, "sand_crate_tpu/ops/pair_kernel.py:707",
            err_b, cuda_ms(run_b, 20), plain_b_ms, B * (f32 * (8 + 4 + nb) * p_pad + rs_bytes),
            pairs * PAIR_FLOPS)),
    ]
    print(f"  K4+K5, K8+K9 at {B} settled crates (slab {p_pad} columns, {M} slots a cell, "
          f"spring {spring}), {pairs:.0f} directed pairs: == plain and == each crate's solo "
          "launch bit for bit; " + "; ".join(
              f"{r['name']} {r['ms']:.4f} ms (plain {r['plain_ms']:.2f}, bound "
              f"{r['bound_ms']:.4f} {r['bound_by']})" for _, r in rows))
    return rows


def wave_backends(smi: str) -> list:
    """(s1): WAVE_CRATES wave_machine crates (capacity 4096, coefficients of
    their own, the emitter on) through BatchedCrates on every backend, and
    on pmajor under SAND_CRATE_PMSUB=1; returns the crate-axis kernel rows
    at the settled pmajor (K1/K2, and K10 under PMSUB) and pallas batches,
    their launches those of the batch's timed ticks."""
    import copy

    import torch

    from sand_crate_tpu_torch import Params, load_config_dict
    from sand_crate_tpu_torch.bench import WAVE_MACHINE
    from sand_crate_tpu_torch.sweep import DEFAULT_RANDOM_RANGES, BatchedCrates, random_params

    config = load_config_dict(copy.deepcopy(WAVE_MACHINE))
    base = Params.from_coefficients(config.world_config.coefficients, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    params = random_params(gen, base, DEFAULT_RANDOM_RANGES, WAVE_CRATES)
    # One settled batch (phase (r)'s PAIR_SETTLE ticks, on dense), its state
    # and generator copied into every backend's batch.
    settled = BatchedCrates(config, params, device="cuda", seed=5, forces_mode="dense")
    settled.run(PAIR_SETTLE)
    start = (clone_state(settled.state), settled.generator.get_state())
    counts = settled.particle_counts()
    print(f"  settled {PAIR_SETTLE} ticks on dense: alive per crate {int(counts.min())}-"
          f"{int(counts.max())} of {settled.scene.capacity}")
    del settled
    row_fns = {"pmajor": pm_crate_axis_rows,
               "pmajor PMSUB": lambda b: pm_crate_axis_rows(b, k10=True),
               "pallas": grid_crate_axis_rows}
    rates, rows = {}, []
    for mode, forces_mode, knob_name in BATCH_MODES:
        with knob(knob_name):
            out = batch_run(f"{WAVE_CRATES} wave_machine crates on {mode}", smi, config, params,
                            mode, forces_mode, 5, BATCH_SETTLE, closed=False, start=start,
                            crate_axis_rows=row_fns.get(mode))
        for key, r in out["rows"]:
            r["launches"] = out["launches"][key]
            rows.append(r)
        rates[mode] = (out["rate"], out["p50"])
        del out
        gc.collect()
        torch.cuda.empty_cache()
    lead = max(rates, key=lambda m: rates[m][0])
    print(f"  {WAVE_CRATES} x 4096 wave_machine ({smi}): crate-steps/s (replayed p50 ms) "
          + ", ".join(f"{m} {r:.1f} ({q:.4f})" for m, (r, q) in rates.items())
          + f"; leads: {lead}")
    return rows


def big_batches(smi: str) -> None:
    """(s2): BIG_CRATES dam breaks of BIG_PARTICLES target particles (no
    emitter, closed box) on pmajor (K1/K2, then K10 under SAND_CRATE_PMSUB=1),
    pallas and chunked, then the same crates
    one after another alone on pmajor (physics.rollout: replays), timed
    over the same ticks; each crate alone equals its row of the pmajor batch
    in every state field, bit for bit."""
    import torch

    from sand_crate_tpu_torch import Config, Params
    from sand_crate_tpu_torch.config import PlaybackConfig
    from sand_crate_tpu_torch.physics import rollout
    from sand_crate_tpu_torch.scene import init_state
    from sand_crate_tpu_torch.sweep import grid_params

    world = dam_break_world(BIG_PARTICLES)
    config = Config(world_config=world, playback_config=PlaybackConfig())
    base = Params.from_coefficients(world.coefficients, "cuda")
    params = grid_params(base, {"viscosity": [6.0, 8.0, 10.0, 12.0],
                                "pressure_amplifier": [25.0, 30.0]})
    rates, pm_state, scene, ticks = {}, None, None, 0
    for mode, forces_mode, knob_name in BIG_MODES:
        with knob(knob_name):
            out = batch_run(f"{BIG_CRATES} x {BIG_PARTICLES} dam break crates on {mode}", smi,
                            config, params, mode, forces_mode, 9, BIG_SETTLE, closed=True)
        rates[mode] = (out["rate"], out["p50"])
        if mode == "pmajor":
            pm_state, scene, ticks = clone_state(out["b"].state), out["b"].scene, out["ticks"]
        del out
        gc.collect()
        torch.cuda.empty_cache()
    # Each crate alone runs the pmajor batch's ticks, BATCH_TIMED_TICKS of them timed.
    first = ticks - BATCH_TIMED_TICKS
    gen = torch.Generator(device="cuda")
    wall, worst = 0.0, 0
    for i in range(BIG_CRATES):
        pr = Params(*(x[i] for x in params))
        st, _ = rollout(init_state(world, scene, seed=9 + i), pr, scene, first, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, diag = rollout(st, pr, scene, BATCH_TIMED_TICKS, gen)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        for name, a, b in zip(st._fields, st, pm_state):
            check(torch.equal(a, b[i]), f"{BIG_PARTICLES} dam break crate {i} alone differs from "
                                        f"its row of the pmajor batch in {name}")
        worst = max(worst, int(diag.neighbor_overflow))
    solo = BIG_CRATES * BATCH_TIMED_TICKS / wall
    print(f"  {BIG_CRATES} x {BIG_PARTICLES} dam break ({smi}): crate-steps/s (replayed p50 ms) "
          + ", ".join(f"{m} batch {r:.2f} ({q:.4f})" for m, (r, q) in rates.items())
          + f"; pmajor alone, one crate after another (physics.rollout, replays): {solo:.2f}, "
          f"every crate bit for bit its row of the pmajor batch; leads: "
          f"{max(rates, key=lambda m: rates[m][0])}")


def wave_datagen(smi: str) -> None:
    """(s3): run_datagen with WAVE_CRATES wave_machine crates on pmajor and
    pallas.  Per backend one frame alone (S_DATAGEN_EVERY ticks: the set-up,
    the capture and one shard frame), then S_DATAGEN_TICKS ticks in turns
    (pmajor, pallas, pallas, pmajor), each from a fresh start: crate-steps/s
    end to end, the steady rate past the set-up (the long run less the
    one-frame run), and the peak memory of the run."""
    import copy
    import tempfile

    import torch

    from sand_crate_tpu_torch import load_config_dict
    from sand_crate_tpu_torch.bench import WAVE_MACHINE
    from sand_crate_tpu_torch.sweep import run_datagen

    config = load_config_dict(copy.deepcopy(WAVE_MACHINE))

    def timed(mode, ticks):
        reset_kernel_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            out = run_datagen(config, WAVE_CRATES, ticks, S_DATAGEN_EVERY, tmp, seed=4,
                              forces_mode=mode, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernel_counts()
        check(launches == pair_want(launches, mode, ticks),
              f"run_datagen on {mode}: launches {launches}")
        check(out["frames"] == ticks // S_DATAGEN_EVERY, f"run_datagen on {mode}: frames")
        check(out["non_finite"] == 0, f"run_datagen on {mode}: non_finite {out['non_finite']}")
        check(mode != "pmajor" or out["overflow"] == 0, "run_datagen on pmajor: overflow")
        return wall, torch.cuda.max_memory_allocated(), out["overflow"]

    setup = {mode: timed(mode, S_DATAGEN_EVERY)[0] for mode in ("pmajor", "pallas")}
    for mode in ("pmajor", "pallas", "pallas", "pmajor"):
        wall, peak, overflow = timed(mode, S_DATAGEN_TICKS)
        steady = WAVE_CRATES * (S_DATAGEN_TICKS - S_DATAGEN_EVERY) / (wall - setup[mode])
        print(f"  run_datagen ({smi}): {WAVE_CRATES} wave_machine crates x {S_DATAGEN_TICKS} "
              f"ticks, sampled every {S_DATAGEN_EVERY}, {mode}: {wall:.3f} s end to end, "
              f"{WAVE_CRATES * S_DATAGEN_TICKS / wall:.1f} crate-steps/s; one frame alone "
              f"{setup[mode]:.3f} s, past it {steady:.1f} crate-steps/s; peak memory "
              f"{peak / 2**30:.3f} GiB, overflow {overflow}")


# --------------------------------------------------------------------------
# (r) the batched pair kernels: D1 and D2 (csrc/pair_batch.cu)
# --------------------------------------------------------------------------

# The columns of D2's output, by pass (spring columns where the scene has it).
WINDOW_COLUMNS = {"a": ("w_sum", "s_x", "s_y", "nbr_cnt"),
                  "b": ("dv_x", "dv_y", "pressure_x", "pressure_y", "visc_x", "visc_y"),
                  "b_spring": ("dv_x", "dv_y", "pressure_x", "pressure_y", "spring_x",
                               "spring_y", "visc_x", "visc_y")}


def held(label: str, got, ref, names) -> float:
    """ops/pair_batch_cases.assert_sums as a gate (counts bit for bit, NaN
    and inf in the same places, floats within PAIR_TOL relative plus
    PAIR_TOL of the field's largest magnitude): the largest absolute
    difference, or the run fails naming the field."""
    from sand_crate_tpu_torch.ops import pair_batch_cases as cases

    try:
        return cases.assert_sums(tuple(got), tuple(ref), names, PAIR_TOL)
    except AssertionError as e:
        check(False, f"{label}: {e}")


def order_vs_plain(label: str, got, want) -> None:
    """D1's prologue against its plain twin (pair_batch.dense_order_plain):
    the order and the sorted fields bit for bit, the tile records equal (a
    box's zero may take either sign)."""
    import torch

    check(torch.equal(got.order, want.order), f"{label}: the order differs from its plain twin's")
    same_values(f"{label}: the sorted fields", (got.pq, got.sv), (want.pq, want.sv))
    check(torch.equal(got.tiles[..., 6:], want.tiles[..., 6:]),
          f"{label}: the tiles' alive bits or flags differ")
    check(torch.equal(got.tiles[..., :6].view(torch.float32),
                      want.tiles[..., :6].view(torch.float32)), f"{label}: the tiles' boxes differ")


def dense_work(order, diameter, mode: str) -> dict:
    """pair_batch.tile_work of D1's pass ``mode`` on the prologue ``order``."""
    from sand_crate_tpu_torch.ops import pair_batch

    P = order.order.shape[1]
    visit, _ = pair_batch.dense_visits(order, diameter, mode)
    return pair_batch.tile_work(visit, P, pair_batch.self_tile(P), P)


def window_work(feat, diameter, halo: int, cs: int, n_chunks: int) -> dict:
    """pair_batch.tile_work of D2 on the slabs ``feat`` (B, p_pad, F)."""
    from sand_crate_tpu_torch.ops import pair_batch

    visit, _ = pair_batch.window_visits(feat, diameter, halo, cs, n_chunks)
    return pair_batch.tile_work(visit, cs, pair_batch.self_tile(feat.shape[1]), cs + 2 * halo)


def skip_share(work: dict) -> str:
    return (f"{1.0 - work['visited'] / max(work['tile_pairs'], 1.0):.4f} of "
            f"{work['tile_pairs']:.4g} tile pairs skipped, {work['tested']:.4g} pairs tested")


def pair_cases() -> None:
    """(r1): D1 (its prologue too) and D2 against their plain versions on
    every case of ops/pair_batch_cases.py (each checked on the CPU to hold
    what it claims), crate by crate; the three-crate case vmapped."""
    import torch

    from sand_crate_tpu_torch import cellwise
    from sand_crate_tpu_torch.ops import chunked, pair_batch
    from sand_crate_tpu_torch.ops import pair_batch_cases as cases

    one = dict.fromkeys(pair_batch.LAUNCHES, 1)
    for name in cases.CASES:
        facts = cases.facts(name)
        check(all(facts.values()), f"pair case {name} does not hold what it claims: {facts}")
        c = cases.inputs(name, "cuda")
        sc = cases.scene(c)
        o_args = tuple(c[k] for k in ("pos", "vel", "alive", "noise", "diameter"))
        od = pair_batch.dense_order(*o_args)
        order_vs_plain(f"D1's prologue, case {name}", od, pair_batch.dense_order_plain(*o_args))
        errs, nans, lost, work_w = [0.0, 0.0], [0, 0], 0, []
        for b in range(cases.crates(c)):
            args = cases.dense_args(c, b)
            reset(pair_batch.LAUNCHES)
            got = pair_batch.neighbor_forces_dense(*args, sc)
            win = cases.chunked_sums(c, b)
            check(pair_batch.LAUNCHES == one, f"case {name}: launches {pair_batch.LAUNCHES}")
            errs[0] = max(errs[0], held(f"D1, case {name}, crate {b}", got[:6],
                                        cellwise.neighbor_forces_dense(*args, sc)[:6],
                                        cases.FIELDS))
            ref = cases.chunked_sums(c, b, chunked._pass_scan_plain)
            errs[1] = max(errs[1], held(f"D2, case {name}, crate {b}", win[:6], ref[:6],
                                        cases.FIELDS))
            check(int(win.overflow) == int(ref.overflow),
                  f"D2, case {name}: overflow {int(win.overflow)} != {int(ref.overflow)}")
            nans[0] += sum(int(torch.isnan(x).sum()) for x in got[:6])
            nans[1] += sum(int(torch.isnan(x).sum()) for x in win[:6])
            lost += int(win.overflow)
            feat, (halo, _, _, diam, *_, n_chunks, cs) = cases.window_slabs(c, b)[0]
            work_w.append(window_work(feat[None], diam[None], halo, cs, n_chunks))
        w = {k: sum(x[k] for x in work_w) for k in work_w[0]}
        print(f"  case {name}: {cases.crates(c)} x {c['pos'].shape[1]} slots, D2 cs {c['cs']} "
              f"halo {c['halo']} bound {c['live_rows']}: max abs err D1 {errs[0]:.3e}, D2 "
              f"{errs[1]:.3e}; NaN entries (as plain) D1 {nans[0]}, D2 {nans[1]}; D2 overflow "
              f"{lost} (as plain); prologue == plain; D1 pass A "
              f"{skip_share(dense_work(od, c['diameter'], 'a'))}, D2 {skip_share(w)}")
    c = cases.inputs("batch", "cuda")
    reset(pair_batch.LAUNCHES)
    dense, win = cases.vmapped_dense(c), cases.vmapped_chunked(c)
    check(pair_batch.LAUNCHES == one,
          f"the vmapped three-crate case launched {pair_batch.LAUNCHES} (one a kernel)")
    for b in range(cases.crates(c)):
        alone = pair_batch.neighbor_forces_dense(*cases.dense_args(c, b), cases.scene(c))
        same_values(f"D1 vmapped, crate {b} against its run alone",
                    tuple(x[b] for x in dense), tuple(alone[:6]))
        same_values(f"D2 vmapped, crate {b} against its run alone",
                    tuple(x[b] for x in win), tuple(cases.chunked_sums(c, b)))
    print("  the three-crate case vmapped (coefficients of its own a crate): one launch of each "
          "kernel, every crate bit for bit its run alone")


def settled_batch(raw: dict, n: int, seed: int, mode: str):
    """(world, BatchedCrates) of ``n`` crates of the dict world ``raw`` with
    random coefficients (sweep.DEFAULT_RANDOM_RANGES) on ``mode``, after
    PAIR_SETTLE ticks."""
    import copy

    import torch

    from sand_crate_tpu_torch import Params, load_config_dict
    from sand_crate_tpu_torch.sweep import DEFAULT_RANDOM_RANGES, BatchedCrates, random_params

    config = load_config_dict(copy.deepcopy(raw))
    base = Params.from_coefficients(config.world_config.coefficients, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    batch = BatchedCrates(config, random_params(gen, base, DEFAULT_RANDOM_RANGES, n),
                          device="cuda", seed=seed, forces_mode=mode)
    batch.run(PAIR_SETTLE)
    return config.world_config, batch


def solo_crates(B: int) -> list:
    return sorted({round(k * (B - 1) / (PAIR_SOLO - 1)) for k in range(PAIR_SOLO)})


def dense_at(label: str, batch) -> dict:
    """(r2): D1 at a settled batch's state (its positions, velocities and
    alive masks, collider noise drawn per crate): the operator (one launch a
    kernel) and the prologue and each pass alone against their plain twins
    vmapped over the crates; crates alone bit for bit their rows; times,
    bounds, the tiles skipped and the pairs tested."""
    import torch

    from sand_crate_tpu_torch import cellwise
    from sand_crate_tpu_torch.ops import pair_batch
    from sand_crate_tpu_torch.ops import pair_batch_cases as cases

    st, pr = batch.state, batch.params
    spring = bool(batch.scene.enable_spring)
    B, P = st.alive.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    u = torch.rand(st.pos.shape, generator=gen, device="cuda")
    noise = (u - 0.5) * (pr.diameter * pr.collider_noise_level)[:, None, None]
    args = (st.pos, st.vel, st.alive, noise, *(getattr(pr, k) for k in pair_batch.DENSE_COEFS))
    reset(pair_batch.LAUNCHES)
    got = torch.ops.sand_crate.dense_pairs(*args, int(spring))
    check(pair_batch.LAUNCHES == {**dict.fromkeys(pair_batch.LAUNCHES, 0), "dense_order": 1,
                                  "dense_a": 1, "dense_b": 1},
          f"D1 at {label}: launches {pair_batch.LAUNCHES}")
    err = held(f"D1 at {label}", got,
               torch.func.vmap(lambda *a: pair_batch.dense_pairs_plain(*a, spring))(*args),
               cases.FIELDS)
    o_args = (st.pos, st.vel, st.alive, noise, pr.diameter)
    od = pair_batch.dense_order(*o_args)
    order_vs_plain(f"D1's prologue at {label}", od, pair_batch.dense_order_plain(*o_args))
    a_args = (st.pos, st.alive, noise, pr.diameter, pr.ignored_pressure)
    plain_a = torch.func.vmap(cellwise.dense_pass_a)
    ra = plain_a(*a_args)
    k_a = (od, pr.diameter, pr.ignored_pressure)
    err_a = held(f"D1 pass A at {label}", pair_batch.dense_pass_a(*k_a), ra,
                 ("p_i", "s", "nbr_cnt"))
    coef_b = (pr.diameter, pr.surface_smoothing, pr.target_pressure, pr.spring_overlap_balance)
    b_args = (st.pos, st.vel, st.alive, noise, ra[0], ra[1], *coef_b)
    k_b = (od, ra[0], ra[1], *coef_b)
    plain_b = torch.func.vmap(lambda *a: cellwise.dense_pass_b(*a, spring))
    err_b = held(f"D1 pass B at {label}", pair_batch.dense_pass_b(*k_b, spring),
                 plain_b(*b_args), ("dv_tension", "pressure_real", "spring_real", "visc_vsum"))
    solo = solo_crates(B)
    for b in solo:
        alone = torch.ops.sand_crate.dense_pairs(*(x[b:b + 1] for x in args), int(spring))
        same_values(f"D1 at {label}: crate {b} alone against its row of the batch",
                    tuple(y[0] for y in alone), tuple(x[b] for x in got))
    n_alive = st.alive.sum(dim=1).double()
    all_tested = float((n_alive * (n_alive - 1)).sum())
    counted = float(got[5].double().sum())
    key_b = "b_spring" if spring else "b"
    work = {m: dense_work(od, pr.diameter, m) for m in "ab"}
    T = -(-P // pair_batch.TILE)
    out = dict(
        err_order=0.0, err_a=max(err, err_a), err_b=max(err, err_b),
        ms_order=cuda_ms(lambda: pair_batch.dense_order(*o_args), PAIR_REPS),
        ms_a=cuda_ms(lambda: pair_batch.dense_pass_a(*k_a), PAIR_REPS),
        ms_b=cuda_ms(lambda: pair_batch.dense_pass_b(*k_b, spring), PAIR_REPS),
        plain_order=cuda_ms(lambda: pair_batch.dense_order_plain(*o_args), PAIR_REPS),
        plain_a=cuda_ms(lambda: plain_a(*a_args), PAIR_REPS),
        plain_b=cuda_ms(lambda: plain_b(*b_args), PAIR_REPS),
        # bytes: pos, vel, alive, noise in and order, pq, sv, the tiles out
        # (prologue); pos, alive, noise in and p_i, s, cnt out (A); pos, vel,
        # alive, noise, p_i, s in and four (B, P, 2) sums out (B)
        bytes_order=B * P * (8 + 8 + 1 + 8 + 4 + 16 + 8) + B * T * 32 + 4 * B,
        bytes_a=B * P * (8 + 1 + 8 + 4 + 8 + 4) + 2 * 4 * B,
        bytes_b=B * P * (8 + 8 + 1 + 8 + 4 + 8 + 4 * 8) + 4 * 4 * B,
        ops_order=0.0,
        ops_a=counted * pair_batch.COUNTED_PAIR_OPS["a"],
        ops_b=counted * pair_batch.COUNTED_PAIR_OPS[key_b])
    all_pairs = {p: bound(out["bytes_" + p], 0, f32_flops=all_tested * pair_batch.PAIR_TEST_OPS
                          + out["ops_" + p])[0] for p in "ab"}
    bounds = {p: bound(out["bytes_" + p], 0, f32_flops=out["ops_" + p])
              for p in ("order", "a", "b")}
    alive = st.alive.sum(dim=1)
    print(f"  D1 at {label} ({B} x {P} slots, alive {int(alive.min())}-{int(alive.max())} a "
          f"crate, spring {spring}): == plain vmapped (max abs err {err:.3e}; pass A alone "
          f"{err_a:.3e}, pass B alone {err_b:.3e}), prologue == plain, crates {solo} alone bit "
          f"for bit their rows; prologue {out['ms_order']:.4f} ms, pass A {out['ms_a']:.4f} ms, "
          f"pass B {out['ms_b']:.4f} ms (plain vmapped {out['plain_order']:.3f} / "
          f"{out['plain_a']:.3f} / {out['plain_b']:.3f} ms); pass A {skip_share(work['a'])}, "
          f"pass B {skip_share(work['b'])}; {counted:.4g} pairs counted ({pair_batch.COUNTED_PAIR_OPS} "
          f"operations): bounds {bounds['order'][0]:.4f} ({bounds['order'][1]}) / "
          f"{bounds['a'][0]:.4f} ({bounds['a'][1]}) / {bounds['b'][0]:.4f} ({bounds['b'][1]}) ms "
          f"at 3.35 TB/s and 67 TFLOP/s, shares {bounds['order'][0] / out['ms_order']:.3f} / "
          f"{bounds['a'][0] / out['ms_a']:.3f} / {bounds['b'][0] / out['ms_b']:.3f}; the "
          f"all-pairs figure ({all_tested:.4g} alive pairs tested, "
          f"{pair_batch.PAIR_TEST_OPS} operations each) {all_pairs['a']:.4f} / "
          f"{all_pairs['b']:.4f} ms")
    return out


def window_tests(feat, n_chunks: int, cs: int, halo: int) -> tuple:
    """(alive window pairs, those within one row) of a (B, p_pad, F) slab's
    swept chunks: the ordered pairs (self, window slot), both alive and not
    the same slab row, that D2's function must row-test, and those of them
    whose grid rows differ by at most one, which it must d2-test."""
    import torch

    B, p_pad = feat.shape[:2]
    row, alive = feat[..., 4], feat[..., 5] > 0
    window_pairs = row_pairs = 0.0
    for c in range(n_chunks):
        lo, hi = max(c * cs - halo, 0), min(c * cs + cs + halo, p_pad)
        for b0 in range(0, B, 64):
            sr, sa = row[b0:b0 + 64, c * cs:c * cs + cs], alive[b0:b0 + 64, c * cs:c * cs + cs]
            wr, wa = row[b0:b0 + 64, lo:hi], alive[b0:b0 + 64, lo:hi]
            both = sa[:, :, None] & wa[:, None, :]
            k = torch.arange(cs, device=feat.device)
            both[:, k, k + c * cs - lo] = False  # a self is its own window's slot
            near = both & ((wr[:, None, :] - sr[:, :, None]).abs() <= 1.0)
            window_pairs += float(both.sum())
            row_pairs += float(near.sum())
    return window_pairs, row_pairs


def window_at(label: str, batch, world) -> dict:
    """(r2): D2 at a settled batch's state in each crate's cell order, the
    chunked scene of its world, the sweep bound its largest alive count:
    pass A and pass B on the slabs the vmapped chunked sweep builds, each
    against the plain version vmapped over the crates; crates alone bit for
    bit their rows; times and bounds."""
    import torch

    from sand_crate_tpu_torch.ops import chunked, pair_batch
    from sand_crate_tpu_torch.ops import pair_batch_cases as cases
    from sand_crate_tpu_torch.scene import build_scene

    st, pr = batch.state, batch.params
    sc = build_scene(world, device="cuda", forces_mode="chunked")
    check(sc.capacity == batch.scene.capacity, f"D2 at {label}: capacity")
    spring = bool(sc.enable_spring)
    pos, vel, alive, cid = cases.sorted_batch(st.pos, st.vel, st.alive, sc)
    bound_rows = int(alive.sum(dim=1).max())
    coefs = [getattr(pr, k) for k in pair_batch.DENSE_COEFS]
    args = (pos, vel, alive, cid, pr.diameter * pr.collider_noise_level, st.tick, *coefs)
    feats = cases.batch_slabs(args, (0,) * len(args), sc, bound_rows)
    B, p_pad = feats[0].shape[:2]
    cs, halo = sc.chunk_cs, sc.chunk_halo
    n_chunks = chunked.live_chunks(bound_rows, p_pad, cs)
    wcoefs = [pr.diameter, pr.surface_smoothing, pr.target_pressure, pr.spring_overlap_balance]
    pairs = B * n_chunks * cs * (cs + 2 * halo)
    window_pairs, row_pairs = window_tests(feats[0], n_chunks, cs, halo)
    solo = solo_crates(B)
    out = {}
    for mode, feat in zip("ab", feats):
        n_out = pair_batch.window_outputs(mode, spring)
        key = "b_spring" if mode == "b" and spring else mode
        reset(pair_batch.LAUNCHES)
        got = pair_batch.window_kernel(feat, *wcoefs, halo, cs, n_chunks, mode, spring)
        check(pair_batch.LAUNCHES == {**dict.fromkeys(pair_batch.LAUNCHES, 0),
                                      "window_" + mode: 1},
              f"D2 pass {mode} at {label}: launches {pair_batch.LAUNCHES}")
        plain = torch.func.vmap(lambda f, d, s, t, q, m=mode, k=n_out: chunked._pass_scan_plain(
            f, halo, k, m, d, s, t, q, spring, n_chunks, cs))
        out["err_" + mode] = held(f"D2 pass {mode} at {label}", got.unbind(-1),
                                  plain(feat, *wcoefs).unbind(-1), WINDOW_COLUMNS[key])
        for b in solo:
            alone = pair_batch.window_kernel(feat[b:b + 1], *(x[b:b + 1] for x in wcoefs), halo,
                                             cs, n_chunks, mode, spring)
            same_values(f"D2 pass {mode} at {label}: crate {b} alone against its row",
                        alone[0], got[b])
        out["ms_" + mode] = cuda_ms(lambda m=mode, f=feat: pair_batch.window_kernel(
            f, *wcoefs, halo, cs, n_chunks, m, spring), PAIR_REPS)
        out["plain_" + mode] = cuda_ms(lambda f=feat, p=plain: p(f, *wcoefs), PAIR_REPS)
        # bytes: the slab in, the sums out
        out["bytes_" + mode] = B * p_pad * (feat.shape[2] + n_out) * 4 + 4 * 4 * B
        if mode == "a":
            counted = float(got[..., 3].double().sum())
        out["ops_" + mode] = counted * pair_batch.COUNTED_PAIR_OPS[key]
        out["all_pairs_" + mode] = bound(out["bytes_" + mode], 0, f32_flops=(
            window_pairs * pair_batch.ROW_TEST_OPS + row_pairs * pair_batch.PAIR_TEST_OPS
            + out["ops_" + mode]))[0]
    work = window_work(feats[0], pr.diameter, halo, cs, n_chunks)
    bounds = {p: bound(out["bytes_" + p], 0, f32_flops=out["ops_" + p]) for p in "ab"}
    print(f"  D2 at {label} ({B} crates, slab {p_pad} rows, cs {cs}, halo {halo}, sweep bound "
          f"{bound_rows}: {n_chunks} chunks, spring {spring}): passes A and B == plain vmapped "
          f"(max abs err {out['err_a']:.3e} / {out['err_b']:.3e}), crates {solo} alone bit for "
          f"bit their rows; pass A {out['ms_a']:.4f} ms, pass B {out['ms_b']:.4f} ms (plain "
          f"vmapped {out['plain_a']:.3f} / {out['plain_b']:.3f} ms); {pairs:.4g} window pairs a "
          f"pass, {skip_share(work)}, {counted:.4g} counted ({pair_batch.COUNTED_PAIR_OPS} "
          f"operations): bounds {bounds['a'][0]:.4f} ({bounds['a'][1]}) / {bounds['b'][0]:.4f} "
          f"({bounds['b'][1]}) ms at 3.35 TB/s and 67 TFLOP/s, shares "
          f"{bounds['a'][0] / out['ms_a']:.3f} / {bounds['b'][0] / out['ms_b']:.3f}; the "
          f"all-pairs figure ({window_pairs:.4g} alive window pairs row-tested, "
          f"{pair_batch.ROW_TEST_OPS} operations, {row_pairs:.4g} within a row d2-tested, "
          f"{pair_batch.PAIR_TEST_OPS}) {out['all_pairs_a']:.4f} / {out['all_pairs_b']:.4f} ms")
    return out


def pair_batch_rows(smi: str) -> list:
    """Phase (r); returns the kernels line's rows of D1 (at 1024 x 640) and
    D2 (at 64 x 4096), their launches filled in by (j)."""
    import torch

    from sand_crate_tpu_torch.bench import STIRRING_CUP, WAVE_MACHINE

    print(f"(r1) D1 and D2 vs their plain versions on the hard cases "
          f"(ops/pair_batch_cases.py), {smi}:")
    pair_cases()
    print(f"(r2) at settled batches ({PAIR_SETTLE} ticks), {smi}:")
    rows = []
    for raw, n, seed, mode, name in ((STIRRING_CUP, DATAGEN_CRATES, 3, "dense", "stirring_cup"),
                                     (WAVE_MACHINE, WAVE_CRATES, 5, "chunked", "wave_machine")):
        world, batch = settled_batch(raw, n, seed, mode)
        label = f"{n} settled {name} crates"
        d = dense_at(label, batch)
        w = window_at(label, batch, world)
        kept, which = (d, "dense") if mode == "dense" else (w, "window")
        for p in ("order", "a", "b") if which == "dense" else "ab":
            rows.append(kernel_row(f"{which}_{p}", PAIR_SOURCE, PAIR_REPLACES[which],
                                   kept["err_" + p], kept["ms_" + p], kept["plain_" + p],
                                   kept["bytes_" + p], 0, f32_flops=kept["ops_" + p]))
        print(f"  {label}: D1 {d['ms_order'] + d['ms_a'] + d['ms_b']:.4f} ms (prologue and both "
              f"passes) against D2 {w['ms_a'] + w['ms_b']:.4f} ms for both passes "
              f"(BatchedCrates runs {mode})")
        del batch
        torch.cuda.empty_cache()
    return rows


def cli_path(smi: str, recording_dir) -> None:
    """Phase (k): the command line's main path on the card.  ``python -m
    sand_crate_tpu_torch run`` (cli.main) on configs/dam_break.yaml, given
    as JSON (bench.DAM_BREAK written out), headless
    without recording: Playback -> Crate.stream_frames -> p-major, K1/K2
    once a tick; its invariants and ticks/s.  The last frame rendered by
    the C rasterizer, equal pixel for pixel to the numpy one.  The replay of
    phase (i)'s recording (``recording_dir``, holding its trajectory/)
    through the command line.  Then the gather and cellwise backends on the
    wave machine: each runs WAVE_BACKEND_TICKS ticks, and their pair sums
    at the dense crate's state equal dense's at SUMS_TOL, below the
    20-neighbor cap and the cell capacity."""
    import copy

    import torch

    from sand_crate_tpu_torch import Crate, cli, load_config_dict
    from sand_crate_tpu_torch.bench import DAM_BREAK, WAVE_MACHINE
    from sand_crate_tpu_torch.cellwise import neighbor_forces_cellwise, neighbor_forces_dense
    from sand_crate_tpu_torch.physics import neighbor_forces_gather, step
    from sand_crate_tpu_torch.render import _render_numpy_reference, rasterize_lib, render_frame

    with tempfile.TemporaryDirectory() as tmp:
        config = Path(tmp) / "dam_break.json"
        config.write_text(json.dumps(DAM_BREAK))
        reset_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pb = cli.main(["run", str(config), "--headless", "--no-record", "--ticks", str(CLI_TICKS),
                       "--ticks-per-frame", str(CLI_TICKS_PER_FRAME)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernel_counts()
    want = {k: 0 for k in launches}
    want.update(dict.fromkeys(("pmajor.a", "pmajor.b", *PREP_KEYS), CLI_TICKS))
    check(launches == want, f"CLI run launches {launches} != {want}")
    crate = pb.crate
    st, sc = crate.state, crate.scene
    n = crate.particle_count
    check(sc.forces_mode == "pmajor" and st.pos.device.type == "cuda" and crate.tick == CLI_TICKS,
          f"CLI run: {sc.forces_mode} on {st.pos.device} at tick {crate.tick}")
    check(bool(torch.isfinite(st.pos[st.alive]).all() and torch.isfinite(st.vel[st.alive]).all()),
          "CLI run: non-finite state")
    uids = torch.sort(st.uid[st.alive]).values
    check(bool((uids[1:] > uids[:-1]).all()), "CLI run: uids not unique")
    _, diag = step(st, crate.params, sc, crate.generator)  # the next tick's diagnostics
    check(int(diag.neighbor_overflow) == 0 and int(diag.non_finite) == 0,
          f"CLI run: overflow {int(diag.neighbor_overflow)}, non_finite {int(diag.non_finite)}")
    print(f"CLI run on {smi}: configs/dam_break.yaml as JSON, {n} particles (capacity "
          f"{sc.capacity}, {sc.forces_mode}), {CLI_TICKS} ticks in frames of "
          f"{CLI_TICKS_PER_FRAME}: {CLI_TICKS / wall:.3f} ticks/s ({wall:.3f} s for cli.main, "
          f"the Crate's construction included; host clock + synchronize); launches {launches}; "
          f"overflow 0, non_finite 0, uids unique")

    check(rasterize_lib() is not None, "the C rasterizer did not build")
    frame_args = (st.pos.cpu().numpy(), st.pressure.cpu().numpy(), crate.segments)
    w = h = 1000
    radius = float(crate.particle_radius)
    alive = st.alive.cpu().numpy()
    t0 = time.perf_counter()
    img = render_frame(*frame_args, size=(w, h), particle_radius=radius, alive=alive)
    c_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = _render_numpy_reference(*frame_args, w, h, radius, alive)
    np_ms = (time.perf_counter() - t0) * 1e3
    check(img.shape == (h, w, 3) and (img == ref).all(), "C frame != numpy frame")
    print(f"  last frame {w}x{h}: C rasterizer {c_ms:.1f} ms, numpy {np_ms:.1f} ms (host clock), "
          f"equal pixel for pixel; {int((img[..., 2] == 255).sum())} lit pixels")
    frames = cli.main(["replay", str(recording_dir), "--headless"])
    check(len(frames) == CKPT_FRAMES, f"replay gave {len(frames)} frames, recorded {CKPT_FRAMES}")
    print(f"  replay of phase (i)'s trajectory: {len(frames)} frames of {frames[0].shape}")

    world = load_config_dict(copy.deepcopy(WAVE_MACHINE)).world_config
    crates = {m: Crate(world, device="cuda", forces_mode=m) for m in ("dense", "gather", "cellwise")}
    reset_kernel_counts()
    for mode, c in crates.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diag = c.run(WAVE_BACKEND_TICKS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / WAVE_BACKEND_TICKS * 1e3
        check(int(diag.non_finite) == 0 and int(diag.neighbor_overflow) == 0,
              f"wave_machine on {mode}: non_finite {int(diag.non_finite)}, "
              f"overflow {int(diag.neighbor_overflow)}")
        print(f"  wave_machine on {mode}: {c.particle_count} particles at tick {c.tick}, "
              f"{ms:.3f} ms/tick (host clock + synchronize), overflow 0, non_finite 0")
    counts = kernel_counts()
    check(counts == pair_want(counts, "dense", WAVE_BACKEND_TICKS),
          f"dense/gather/cellwise launched {counts} (dense: D1 once a pass a tick; else none)")
    ref_crate = crates["dense"]
    st, pr = ref_crate.state, ref_crate.params
    zero = torch.zeros_like(st.pos)
    coefs = (pr.diameter, pr.surface_smoothing, pr.target_pressure, pr.ignored_pressure,
             pr.spring_overlap_balance)
    dense = neighbor_forces_dense(st.pos, st.vel, st.alive, zero, *coefs, ref_crate.scene)
    quiet = pr._replace(collider_noise_level=torch.zeros_like(pr.collider_noise_level))
    got = {
        "gather": neighbor_forces_gather(st.pos, st.vel, st.alive, crates["gather"].generator,
                                         quiet, crates["gather"].scene),
        "cellwise": neighbor_forces_cellwise(st.pos, st.vel, st.alive, zero, *coefs,
                                             crates["cellwise"].scene),
    }
    cap = crates["gather"].scene.max_neighbors
    check(0 < int(dense.nbr_cnt.max()) < cap, f"wave_machine max neighbor count "
                                              f"{int(dense.nbr_cnt.max())} not below {cap}")
    for mode, sums in got.items():
        check(int(sums.overflow) == 0, f"{mode}: a cell over capacity")
        check(torch.equal(sums.nbr_cnt, dense.nbr_cnt), f"{mode}: neighbor counts differ")
        errs = []
        for name in ("p_i", "dv_tension", "pressure_real", "visc_vsum"):
            x, y = getattr(sums, name), getattr(dense, name)
            err = (x - y).abs()
            scale = float(y.abs().max())
            check(bool((err <= SUMS_TOL * (y.abs() + scale)).all()),
                  f"{mode} {name} differs from dense by {float(err.max())}")
            errs.append(f"{name} {float(err.max()):.3e} (max |dense| {scale:.3e})")
        print(f"  {mode} vs dense pair sums at the dense crate's tick {ref_crate.tick} "
              f"({ref_crate.particle_count} particles, noise 0, max neighbors "
              f"{int(dense.nbr_cnt.max())} < {cap}, overflow 0): counts equal; max abs err "
              + ", ".join(errs))


def runaway_check(smi: str) -> None:
    """Phase (l): the 1M dam break settled SETTLE_TICKS ticks on p-major, its
    state (and generator) copied into crates of the same world on p-major,
    the slot grid and the cell grid in plain torch (RUNAWAY_MODES), and on
    p-major without collider noise and with one-sided noise, each run
    RUNAWAY_TICKS ticks (cellwise RUNAWAY_CELLWISE_TICKS); every
    RUNAWAY_EVERY ticks each one's count of
    particles faster than RUNAWAY_SPEED, max speed, overflow, non-finite
    count and fullest cell (its population and corner); each one's ms a tick
    and peak allocation.  The launch counts of those runs are checked.  Then :func:`pile_forensics` from the same
    settled state, and at the end each p-major runaway's candidate window
    width (its three exact row ranges, ops.pmajor.candidate_ranges) and
    neighbor count (particles within one diameter, brute force)."""
    import torch

    from sand_crate_tpu_torch import Crate
    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops import pmajor

    world = dam_break_world(N_TARGET)
    base = Crate(world, device="cuda")
    base.run(SETTLE_TICKS)
    settled = clone_state(base.state)
    crates = {}
    for name, kw in {**RUNAWAY_MODES, **RUNAWAY_VARIANTS}.items():
        c = Crate(world, device="cuda", **kw)
        c.state = clone_state(settled)
        c.generator.set_state(base.generator.get_state())
        if name == "pmajor, noise 0":
            c.collider_noise_level = 0.0
        crates[name] = c
    del base
    sc = crates["cellwise"].scene
    print(f"runaway check on {smi}: the 1M dam break ({crates['pmajor'].particle_count} "
          f"particles) settled {SETTLE_TICKS} ticks on pmajor, then {RUNAWAY_TICKS} ticks on "
          f"each of {', '.join(crates)} from that state (cellwise: grid "
          f"{sc.grid_ny}x{sc.grid_nx}, {sc.cell_capacity} slots a cell)")
    reset_kernel_counts()
    wall = dict.fromkeys(crates, 0.0)
    ran = dict.fromkeys(crates, 0)
    peak = dict.fromkeys(crates, 0)
    for t in range(RUNAWAY_EVERY, RUNAWAY_TICKS + 1, RUNAWAY_EVERY):
        for name, c in crates.items():
            if name == "cellwise" and t > RUNAWAY_CELLWISE_TICKS:
                continue
            ran[name] += RUNAWAY_EVERY
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            diag = c.run(RUNAWAY_EVERY)
            torch.cuda.synchronize()
            wall[name] += time.perf_counter() - t0
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated() - held)
            st, sc = c.state, c.scene
            speed = st.vel[st.alive].norm(dim=1)
            per = torch.bincount(cell_ids_grid(st.pos, st.alive, sc)[st.alive].long(),
                                 minlength=sc.num_cells)
            k = int(per.argmax())
            print(f"  tick {SETTLE_TICKS + t} {name:>17}: {int((speed > RUNAWAY_SPEED).sum())} "
                  f"faster than {RUNAWAY_SPEED}, max_speed {float(diag.max_speed):.4f}, overflow "
                  f"{int(diag.neighbor_overflow)}, non_finite {int(diag.non_finite)}; fullest cell "
                  f"{int(per[k])} particles at x {(k % sc.grid_nx - 1) * sc.cell_size:.4f}, "
                  f"y {(k // sc.grid_nx - 1) * sc.cell_size:.4f}", flush=True)
            check(int(diag.non_finite) == 0, f"runaway check: {name} non-finite")
    counts = kernel_counts()
    pm_runs = 1 + len(RUNAWAY_VARIANTS)
    want = {k: 0 for k in counts}
    want.update(dict.fromkeys(("pmajor.a", "pmajor.b", *PREP_KEYS), pm_runs * RUNAWAY_TICKS))
    want.update({"grid.pair_pass_a": RUNAWAY_TICKS, "grid.pair_pass_b_emit": RUNAWAY_TICKS})
    print(f"  launches {counts}; wall (host clock + synchronize) and peak allocation beyond "
          "what is held: " + ", ".join(f"{m} {wall[m] / ran[m] * 1e3:.3f} ms/tick "
                                      f"{peak[m] / 2**30:.2f} GiB" for m in crates))
    check(counts == want, f"runaway check launches {counts} != {want}")

    c = crates["pmajor"]
    del crates
    pile_forensics(world, settled)
    st, sc = c.state, c.scene
    cid = cell_ids_grid(st.pos, st.alive, sc)
    sorted_cid, order = torch.sort(cid, stable=True)
    ranges = pmajor.candidate_ranges(sorted_cid, sorted_cid < sc.num_cells, sc.grid_nx,
                                     sc.grid_ny)
    widths = (ranges[3:] - ranges[:3]).sum(dim=0)
    width = torch.empty_like(widths)
    width[order] = widths
    speed = torch.where(st.alive, st.vel.norm(dim=1), 0.0)
    fast = torch.nonzero(speed > RUNAWAY_SPEED).flatten()
    alive_pos = st.pos[st.alive]
    diam = float(c.params.diameter)
    rows = []
    for i in fast.tolist():
        near = int(((alive_pos - st.pos[i]).norm(dim=1) <= diam).sum()) - 1
        rows.append((round(float(speed[i]), 1), int(width[i]), near))
    all_w = widths[sorted_cid < sc.num_cells].float()
    print(f"  pmajor runaways at tick {SETTLE_TICKS + RUNAWAY_TICKS}: {len(rows)} as (speed, "
          f"window width, neighbors within one diameter), window width of all alive: mean "
          f"{float(all_w.mean()):.2f} max {int(all_w.max())}:")
    for k in range(0, len(rows), 8):
        print("   ", "; ".join(f"{s} {w} {n}" for s, w, n in rows[k:k + 8]))


def clone_state(state):
    return type(state)(*(t.clone() for t in state))


def pile_forensics(world, settled) -> None:
    """Phase (l), the runaways' cause: from the settled state, p-major tick by
    tick up to RUNAWAY_TICKS until a particle passes RUNAWAY_SPEED; at the
    state before that tick, for the particles that pass it, their neighbors
    within one diameter (brute force), the cell they sort into, and their
    pair sums (noise off, split pass B) on p-major and on the slot grid of
    16 slots; and p-major's p_i and neighbor counts for every self in a cell
    of more than 16, against a brute force (the pair mask in f32 as the
    kernel takes it: counts exact; p_i from float64 distances within
    PILE_P_TOL: the pile's pair distances are near the f32 spacing of
    positions ~1, so each w carries ~1e-4 of rounding)."""
    import torch

    from sand_crate_tpu_torch import Crate, physics
    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops.pallas_forces import neighbor_forces_pallas_sorted
    from sand_crate_tpu_torch.ops.pmajor import neighbor_forces_pmajor_sorted

    c = Crate(world, device="cuda")
    c.state = clone_state(settled)
    for _ in range(RUNAWAY_TICKS):
        before = clone_state(c.state)  # run advances the crate's state in place
        c.run(1)
        fast_uid = c.state.uid[c.state.alive & (c.state.vel.norm(dim=1) > RUNAWAY_SPEED)]
        if fast_uid.numel():
            break
    check(fast_uid.numel() > 0, f"no p-major runaway within {RUNAWAY_TICKS} ticks")
    pr, sc = c.params, c.scene
    s = physics.advance_bodies(physics.cull_particles(before, pr), pr, sc)
    pos = physics.ghost_phase(s, pr, sc).pos
    sorted_cid, order = torch.sort(cell_ids_grid(pos, s.alive, sc), stable=True)
    pos, vel, uid = pos[order], s.vel[order], s.uid[order]
    alive = sorted_cid < sc.num_cells
    args = (pos, vel, alive, sorted_cid, torch.zeros_like(pr.diameter), before.tick, pr.diameter,
            pr.surface_smoothing, pr.target_pressure, pr.ignored_pressure,
            pr.spring_overlap_balance)
    exact = neighbor_forces_pmajor_sorted(*args, sc)
    grid_scene = Crate(world, device="cuda", forces_mode="pallas", cell_capacity=GRID_SLOTS).scene
    capped = neighbor_forces_pallas_sorted(*args, grid_scene)
    per = torch.bincount(sorted_cid[alive].long(), minlength=sc.num_cells)
    diam = float(pr.diameter)
    alive_pos = pos[alive].double()
    print(f"  first p-major runaways at tick {c.tick}: {fast_uid.numel()}; at tick {c.tick - 1} "
          f"(noise off) as (neighbors, cell population, p-major p_i |dv_tension|, "
          f"{GRID_SLOTS}-slot grid neighbors p_i |dv_tension|):")
    rows = []
    for u in fast_uid.tolist():
        k = int(torch.nonzero(uid == u)[0])
        near = int(((alive_pos - pos[k].double()).norm(dim=1) <= diam).sum()) - 1
        rows.append(f"{near} {int(per[sorted_cid[k]])} {float(exact.p_i[k]):.2f} "
                    f"{float(exact.dv_tension[k].norm()):.0f} {int(capped.nbr_cnt[k])} "
                    f"{float(capped.p_i[k]):.2f} {float(capped.dv_tension[k].norm()):.0f}")
    for k in range(0, len(rows), 4):
        print("   ", "; ".join(rows[k:k + 4]))
    selves = torch.nonzero(alive & (per[sorted_cid.clamp(max=sc.num_cells - 1).long()]
                                    > GRID_SLOTS)).flatten()
    worst = 0.0
    pos_alive = pos[alive]
    for k in selves.tolist():
        rel = pos_alive - pos[k]
        m = rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1] <= pr.diameter * pr.diameter  # f32
        dist = rel[m].double().norm(dim=1)
        cnt = int(m.sum()) - 1  # less the self
        p_ref = max(0.0, float(torch.clamp(1.0 - dist / diam, 0.0, 1.0).sum()) - 1.0
                    - float(pr.ignored_pressure))
        check(cnt == int(exact.nbr_cnt[k]),
              f"pile self {k}: p-major counts {int(exact.nbr_cnt[k])}, brute force {cnt}")
        worst = max(worst, abs(p_ref - float(exact.p_i[k])) / max(p_ref, 1.0))
    print(f"  {len(selves)} selves in cells of more than {GRID_SLOTS}: p-major p_i vs a float64 "
          f"brute force, max relative error {worst:.3e}; their p_i up to "
          f"{float(exact.p_i[selves].max()):.2f}, {GRID_SLOTS}-slot grid up to "
          f"{float(capped.p_i[selves].max()):.2f}")
    check(worst <= PILE_P_TOL, f"pile p_i off by {worst} of a brute force")


def band_world(max_particles: int, block: bool):
    """tests/test_spatial.py's scenes on bench.STIRRING_CUP: the block of 782 particles, no emitters, noise 0 (``block``), or
    the cup's emitter with ``max_particles``."""
    import copy

    from sand_crate_tpu_torch import load_config_dict
    from sand_crate_tpu_torch.bench import STIRRING_CUP
    from sand_crate_tpu_torch.config import InitialParticlesConfig

    w = load_config_dict(copy.deepcopy(STIRRING_CUP)).world_config
    w.coefficients = dict(w.coefficients)
    w.coefficients["max_particles"] = max_particles
    if block:
        w.coefficients["collider_noise_level"] = 0.0
        w.particle_sources = []
        w.initial_particles = [InitialParticlesConfig(x0=0.30, y0=0.15, x1=0.70, y1=0.75,
                                                      spacing=0.018, jitter=0.0)]
    return w


def band_vs_single(label, single, merged):
    """Positions matched by uid, the tests' tolerance; returns the max error."""
    import torch

    check(int(single.alive.sum()) == int(merged.alive.sum()) > 0,
          f"{label}: alive {int(single.alive.sum())} != {int(merged.alive.sum())}")
    uid = merged.uid[merged.alive].long()
    check(bool(by_uid(single, single.alive)[uid].all()), f"{label}: other particles alive")
    a = by_uid(single, single.pos)[uid]
    b = merged.pos[merged.alive]
    err = float((a - b).abs().max())
    ok = bool(torch.allclose(b, a, rtol=BAND_POS_RTOL, atol=BAND_POS_ATOL))
    print(f"  {label}: {int(single.alive.sum())} alive, max |pos - single-device pos| {err:.3e} "
          f"(rtol {BAND_POS_RTOL}, atol {BAND_POS_ATOL})")
    check(ok, f"{label}: band positions differ from the single-device step")
    return err


def band_run(step_fn, split, params, ticks, label, edges=None, overflow_ref=None):
    """``ticks`` band ticks with the checks of a closed box: overflow 0 (or
    ``overflow_ref(state before the tick)``, an independent count),
    migration_dropped and non_finite 0 every tick; uids unique; the alive
    set kept but for particles culled outside the box: a tick that loses
    particles must have had each of them outside [-r, 1 + r]^2 before it
    (the cull reads the last integrate's positions; the dead slot may take
    an arrival in the same tick), at most RUNAWAY_SHARE of them, as
    ``drive`` allows.  Returns (split, stats of the last tick, edges,
    deferred over the run)."""
    import torch

    n0 = count = int(split.alive.sum())
    deferred = culled = 0
    r = params.particle_radius
    for t in range(ticks):
        before = split
        if edges is None:
            split, stats = step_fn(split, params)
        else:
            split, stats = step_fn(split, params, edges)
            edges = stats["band_edges"]
            if (t + 1) % BAND_EDGES_EVERY == 0:
                print(f"  {label} tick {t + 1}: edges {edges.tolist()} shard_alive "
                      f"{stats['shard_alive'].tolist()}")
        vals = {k: int(stats[k]) for k in ("particle_count", "neighbor_overflow",
                                           "migration_dropped", "migration_deferred",
                                           "non_finite")}
        deferred += vals["migration_deferred"]
        want = 0 if overflow_ref is None else overflow_ref(before)
        check(vals["neighbor_overflow"] == want, f"{label} tick {t + 1}: overflow {vals}, "
                                                  f"independent count {want}")
        check(vals["migration_dropped"] == 0, f"{label} tick {t + 1}: dropped {vals}")
        check(vals["non_finite"] == 0, f"{label} tick {t + 1}: non-finite {vals}")
        uid0, uid1 = before.uid[before.alive], split.uid[split.alive]
        check(bool(torch.isin(uid1, uid0).all()), f"{label} tick {t + 1}: a particle came "
                                                   "alive in a closed box")
        if vals["particle_count"] != count:
            gone = before.alive & ~torch.isin(before.uid, uid1)
            frozen = before.pos[gone]
            outside = ((frozen < -r) | (frozen > 1.0 + r)).any(dim=1)
            print(f"  {label} tick {t + 1}: culled outside the box: {int(gone.sum())} (their "
                  f"positions before the tick {frozen[:4].cpu().tolist()})")
            check(int(gone.sum()) == count - vals["particle_count"], f"{label}: alive count")
            check(bool(outside.all()), f"{label}: a lost particle was inside the box")
            culled += int(gone.sum())
            count = vals["particle_count"]
    uids = split.uid[split.alive]
    check(int(uids.unique().numel()) == int(uids.numel()), f"{label}: uids not unique")
    check(culled <= RUNAWAY_SHARE * n0, f"{label}: {culled} particles lost")
    return split, stats, edges, deferred


def timed_ticks(run, ticks):
    """(steps/s, p50 ms) of ``ticks`` calls of ``run()``, each closed by a
    synchronize (host clock)."""
    import torch

    torch.cuda.synchronize()
    times = []
    t_all = time.perf_counter()
    for _ in range(ticks):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return ticks / (time.perf_counter() - t_all), statistics.median(times)


def spatial_bands(smi: str) -> dict:
    """Phase (m): one crate split into BAND_SHARDS y-bands on a LocalGroup
    of the card (one thread a shard).  Returns the band runs' launches of
    K1/K2 and the slab-order grid kernels."""
    import torch

    from sand_crate_tpu_torch import Crate, entry
    from sand_crate_tpu_torch.collectives import LocalGroup
    from sand_crate_tpu_torch.physics import step
    from sand_crate_tpu_torch.scene import build_scene
    from sand_crate_tpu_torch.spatial import (
        _halo_cap, initial_band_edges, make_spatial_step, merge_state, split_state,
    )

    D = BAND_SHARDS
    launches = {}
    world = dam_break_world(N_TARGET)
    base = Crate(world, device="cuda")
    base.run(SETTLE_TICKS)
    settled, scene, params = clone_state(base.state), base.scene, base.params
    gen_state = base.generator.get_state()
    n0 = base.particle_count
    del base
    quiet = params._replace(collider_noise_level=torch.zeros_like(params.collider_noise_level))
    group = LocalGroup(D, device="cuda")
    bh = scene.grid_ny // D
    print(f"spatial bands on {smi}: the 1M dam break ({n0} particles, grid {scene.grid_nx}x"
          f"{scene.grid_ny}) settled {SETTLE_TICKS} ticks on pmajor, split into {D} bands of "
          f"{bh} rows on a LocalGroup of the card; each shard keeps the full capacity "
          f"{scene.capacity}; _halo_cap {_halo_cap(scene)}")
    try:
        # -- (m1) pmajor bands ---------------------------------------------------
        gen = torch.Generator(device="cuda")
        gen.set_state(gen_state)
        single, _ = step(clone_state(settled), quiet, scene, gen)
        band = make_spatial_step(group, scene)
        split0 = split_state(settled, scene, D)
        capture = [{} for _ in range(D)]
        one, stats = band(split0, quiet, capture=capture)
        band_vs_single("(m1) pmajor band tick vs one device, noise 0", single,
                       merge_state(one, scene, D))
        check(int(stats["neighbor_overflow"]) == 0, "(m1) one tick: overflow")
        sent0 = stats["shard_sent"].tolist()
        pmajor_band_kernels(capture, scene)
        del capture
        probe = split0
        hc = _halo_cap(scene)
        for t in range(BAND_DEFAULT_TICKS):
            probe, stats = band(probe, params)
            sent = stats["shard_sent"]
            spill = torch.clamp(sent - hc, min=0).sum(dim=1)
            check(torch.equal(spill, stats["shard_overflow"]),
                  f"(m1) default mig_cap tick {t + 1}: shard_overflow "
                  f"{stats['shard_overflow'].tolist()} is not the runs past the cap {hc}: "
                  f"{sent.tolist()}")
            print(f"  (m1) default mig_cap {band.mig_cap}, tick {t + 1}: migration_deferred "
                  f"{int(stats['migration_deferred'])}, overflow (halo spill) "
                  f"{int(stats['neighbor_overflow'])} = the sent runs past the cap {hc}; sent "
                  f"edge-row runs (top, bottom) per shard {sent.tolist()} (not a gate)")
        del probe
        band = make_spatial_step(group, scene, mig_cap=BAND_MIG_CAP)
        reset_kernel_counts()
        split, stats, _, deferred = band_run(band, split0, params, BAND_TICKS,
                                             f"(m1) uniform, mig_cap {BAND_MIG_CAP}")
        counts = kernel_counts()
        want = {k: 0 for k in counts}
        want.update(dict.fromkeys(("pmajor.a", "pmajor.b", "pmajor.prep"), D * BAND_TICKS))
        print(f"  (m1) uniform bands, {BAND_TICKS} ticks with noise: launches {counts}; "
              f"overflow 0, migration_dropped 0, migration_deferred {deferred}, alive "
              f"{int(stats['particle_count'])} of {n0}, uids unique, non_finite 0; "
              f"shard_alive {stats['shard_alive'].tolist()}")
        check(counts == want, f"(m1) launches {counts} != {want}")
        launches["pm_pass_a"], launches["pm_pass_b"] = counts["pmajor.a"], counts["pmajor.b"]
        launches["pm_prep"] = counts["pmajor.prep"]
        print(f"  (m1) sent edge-row runs (top, bottom) per shard, first tick / last tick: "
              f"{sent0} / {stats['shard_sent'].tolist()} (halo cap {hc})")
        uniform_alive = stats["shard_alive"].float()

        single = clone_state(settled)
        for _ in range(BAND_TICKS):
            single, _ = step(single, params, scene, gen)
        box = {"band": split, "single": single}

        def band_tick():
            box["band"], _ = band(box["band"], params)

        def single_tick():
            box["single"], _ = step(box["single"], params, scene, gen)

        rates = {"band": [], "single": []}
        for name in ("band", "single", "band", "single"):
            rates[name].append(timed_ticks(band_tick if name == "band" else single_tick,
                                           BAND_TURN_TICKS))
        print(f"  (m1) on {smi}, in turns of {BAND_TURN_TICKS} ticks (host clock, each tick "
              f"closed by a synchronize): band step " + ", ".join(
                  f"{r:.3f} steps/s p50 {p:.3f} ms" for r, p in rates["band"])
              + "; single-device step " + ", ".join(
                  f"{r:.3f} steps/s p50 {p:.3f} ms" for r, p in rates["single"]))
        for name, tick in (("band step", band_tick), ("single-device step", single_tick)):
            print(f"  (m1) {name}: " + profiled(lambda n, tick=tick: [tick() for _ in range(n)],
                                                PROFILED_TICKS))
        del box, split, single

        edges0 = initial_band_edges(settled, scene, D)
        rb = make_spatial_step(group, scene, mig_cap=BAND_MIG_CAP, rebalance=True)
        rsplit = split_state(settled, scene, D, edges0)
        print(f"  (m1) rebalanced: initial edges {edges0.tolist()}")
        reset_kernel_counts()
        rsplit, rstats, edges, deferred = band_run(rb, rsplit, params, BAND_TICKS,
                                                   "(m1) rebalanced", edges0)
        counts = kernel_counts()
        check(counts == want, f"(m1) rebalanced launches {counts} != {want}")
        launches["pm_pass_a"] += counts["pmajor.a"]
        launches["pm_prep"] += counts["pmajor.prep"]
        launches["pm_pass_b"] += counts["pmajor.b"]
        per = rstats["shard_alive"].float()
        print(f"  (m1) rebalanced, {BAND_TICKS} ticks: launches {counts}; migration_deferred "
              f"{deferred}; edges {edges.tolist()}; shard_alive max/mean "
              f"{float(per.max() / per.mean()):.4f} (uniform "
              f"{float(uniform_alive.max() / uniform_alive.mean()):.4f}); sent edge-row runs "
              f"{rstats['shard_sent'].tolist()}")
        del rsplit

        # -- (m2) pallas bands -----------------------------------------------------
        gscene = build_scene(world, forces_mode="pallas", cell_capacity=GRID_SLOTS,
                             device="cuda")
        gen.set_state(gen_state)
        single, _ = step(clone_state(settled), quiet, gscene, gen)
        gband = make_spatial_step(group, gscene, mig_cap=BAND_MIG_CAP)
        reset_kernel_counts()
        capture = [{} for _ in range(D)]
        one, gstats = gband(split0, quiet, capture=capture)
        counts = kernel_counts()
        check(counts["grid.pair_pass_a"] == D and counts["grid.pair_pass_b_emit"] == D
              and sum(counts.values()) == 2 * D, f"(m2) one tick launches {counts}")
        launches["pair_pass_a"] = counts["grid.pair_pass_a"]
        launches["pair_pass_b_emit"] = counts["grid.pair_pass_b_emit"]
        band_vs_single("(m2) pallas band tick vs one device, noise 0", single,
                       merge_state(one, gscene, D))
        over = over_capacity(types.SimpleNamespace(params=params, scene=gscene), GRID_SLOTS)
        check(int(gstats["neighbor_overflow"]) == over(split0), "(m2) one tick: overflow")
        print(f"  (m2) overflow (particles past {GRID_SLOTS} in a cell) "
              f"{int(gstats['neighbor_overflow'])}, equal to an independent count")
        del single
        grid_band_kernels(capture[1], gscene, quiet, settled.tick)
        del capture
        reset_kernel_counts()
        split, gstats, _, deferred = band_run(gband, one, params, BAND_GRID_TICKS,
                                              "(m2) pallas", overflow_ref=over)
        counts = kernel_counts()
        want = {k: 0 for k in counts}
        want.update({"grid.pair_pass_a": D * BAND_GRID_TICKS,
                     "grid.pair_pass_b_emit": D * BAND_GRID_TICKS})
        check(counts == want, f"(m2) launches {counts} != {want}")
        launches["pair_pass_a"] += counts["grid.pair_pass_a"]
        launches["pair_pass_b_emit"] += counts["grid.pair_pass_b_emit"]
        print(f"  (m2) pallas bands, {BAND_GRID_TICKS} more ticks with noise: launches {counts}; "
              f"migration_deferred {deferred}, overflow each tick equal to the independent count "
              f"({int(gstats['neighbor_overflow'])} at the last), shard_alive "
              f"{gstats['shard_alive'].tolist()}")
        del split, one, split0, settled
    finally:
        group.close()

    # -- (m3) the small legs: tests/test_spatial.py's scenes on the card -----------
    small_legs()
    print("  (m3) entry() and dryrun_multichip(4) on the card:")
    fn, (state, params) = entry.entry()
    pos, dv = fn(state, params)
    check(bool(torch.isfinite(pos).all()) and dv.shape == (7,), "entry() step")
    print(f"  entry OK: {tuple(pos.shape)} {tuple(dv.shape)}")
    out = entry.dryrun_multichip(4)
    check(all(out[k] > 0 for k in ("batched", "spatial", "spatial-pallas", "spatial-pmajor",
                                   "spatial-rebalance")), f"dryrun_multichip(4): {out}")

    # -- (m4) the NCCL leg -------------------------------------------------------------
    print(f"  (m4) DistGroup's NCCL leg needs two cards (NCCL puts no two ranks on one "
          f"device); this machine has {torch.cuda.device_count()}, so it is not run here")
    return launches


def pmajor_band_kernels(capture: list, scene, label="(m1)", bands=(0, 1)) -> dict:
    """K1/K2 on the spliced slabs of ``bands`` (shard 0's above halo is all
    sentinels, cid -1; shard 1 is interior) against their plain versions,
    bit for bit, and against the step's own launches.  Prints how many
    sentinel entries sit inside a self's candidate range, where only the
    pair mask keeps them out; returns {band: (sentinel, covered) masks}."""
    import torch

    from sand_crate_tpu_torch.ops import pmajor as pm

    nx = scene.grid_nx
    masks = {}
    for d in bands:
        cap = capture[d]
        cid, ranges, coef, symm = cap["cid"], cap["ranges"], cap["coef"], cap["symm"]
        hc, lo = cap["hc"], int(cap["lo"])
        a = pm.pm_pass(cap["slab_a"], ranges, coef, "a", symm=symm)
        exact(f"{label} band {d} pm_pass_a", a,
              pm.pm_pass_plain(cap["slab_a"], ranges, coef, "a", symm=symm))
        check(torch.equal(a, cap["out_a"]), f"{label} band {d} pass A differs from the step's")
        kw = dict(fold=cap["fold"], spring=cap["spring"], symm=symm)
        b = pm.pm_pass(cap["slab_b"], ranges, coef, "b", **kw)
        exact(f"{label} band {d} pm_pass_b", b,
              pm.pm_pass_plain(cap["slab_b"], ranges, coef, "b", **kw))
        check(torch.equal(b, cap["out_b"]), f"{label} band {d} pass B differs from the step's")
        # An unused above-halo entry: the sentinel cid and zero features (a
        # real particle of column nx - 1 in row lo - 1 has that cid too).
        sentinel = torch.zeros_like(cid, dtype=torch.bool)
        sentinel[:hc] = (cid[:hc] == lo * nx - 1) & (cap["slab_a"][:hc, :6] == 0).all(dim=1)
        check(int(sentinel.sum()) > 0, f"{label} band {d}: no sentinel entry in the above halo")
        if d == 0:
            check(bool(sentinel[:hc].all()) and lo == 0, f"{label} band 0: above halo not all "
                                                          "cid -1")
        # columns covered by some self's range: +1 at each start, -1 at each end
        edge = torch.zeros(cid.numel() + 1, dtype=torch.int32, device=cid.device)
        for q in range(3):
            edge.index_add_(0, ranges[q].long(), torch.ones_like(ranges[q]))
            edge.index_add_(0, ranges[3 + q].long(), -torch.ones_like(ranges[q]))
        covered = torch.cumsum(edge, 0)[:-1] > 0
        halo = hc - int(sentinel.sum())
        masks[d] = (sentinel, covered)
        print(f"  {label} band {d} (rows {lo}-{lo + scene.grid_ny // len(capture) - 1}): spliced "
              f"slab of {cid.numel()} columns, {halo} above-halo particles, "
              f"{int(sentinel.sum())} sentinel entries (cid {lo * nx - 1}, zero features), "
              f"{int((sentinel & covered).sum())} of them inside a self's range; pm_pass_a "
              f"and pm_pass_b == plain bit for bit == the step's launches (launches counted "
              f"outside the band runs)")
    return masks


def sentinel_case(params) -> None:
    """(m3): the layout of tests/test_torch_spatial.py's sentinel test on
    the card: particles pressed against the right wall (x = 1 bins in
    column nx - 2) in rows lo - 1 .. lo + 1 of band 1 of 2, so band 1's
    above-halo sentinels (cid lo * nx - 1, zero features) lie inside its
    selves' d = -1 ranges.  K1/K2 == plain bit for bit there, and each
    self's pass-A neighbor count equals a brute force over the slab's real
    entries."""
    import torch

    from sand_crate_tpu_torch.collectives import LocalGroup
    from sand_crate_tpu_torch.scene import build_scene, init_state
    from sand_crate_tpu_torch.spatial import make_spatial_step, split_state

    w = band_world(256, block=True)
    scene = build_scene(w, capacity=1024, forces_mode="pmajor", device="cuda")
    nx, ny, cs = scene.grid_nx, scene.grid_ny, scene.cell_size
    lo, n, P = ny // 2, 48, scene.capacity
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    pos = torch.zeros((P, 2), device="cuda")
    x = 0.97 + 0.03 * torch.rand(n, device="cuda", generator=gen)
    pos[:n, 0] = torch.where(torch.arange(n, device="cuda") % 2 == 0, 1.0, x)
    pos[:n, 1] = (lo - 2 + 3.0 * torch.rand(n, device="cuda", generator=gen)) * cs
    alive = torch.arange(P, device="cuda") < n
    state = init_state(w, scene, seed=0)._replace(pos=pos, alive=alive)
    capture = [{}, {}]
    g2 = LocalGroup(2, device="cuda")
    try:
        make_spatial_step(g2, scene)(split_state(state, scene, 2), params, capture=capture)
    finally:
        g2.close()
    sentinel, covered = pmajor_band_kernels(capture, scene, "(m3) sentinel case", (1,))[1]
    check(int((sentinel & covered).sum()) > 0, "(m3) sentinel case: no sentinel in a range")
    cap = capture[1]
    cid, slab, ranges = cap["cid"], cap["slab_a"], cap["ranges"]
    real = (cid < nx * ny) & (slab[:, :6] != 0).any(dim=1)
    selves = torch.nonzero(ranges[3:].sum(dim=0) > ranges[:3].sum(dim=0)).flatten()
    xy = slab[:, :2].double()
    d2 = ((xy[selves, None] - xy[None, real]) ** 2).sum(dim=-1)
    brute = (d2 <= float(params.diameter) ** 2).sum(dim=1) - 1  # less the self
    got = cap["out_a"][3, selves]
    check(int(brute.max()) > 0 and torch.equal(got, brute.to(got.dtype)),
          f"(m3) sentinel case: neighbor counts {got.tolist()} != brute force {brute.tolist()}")
    print(f"  (m3) sentinel case: {int((sentinel & covered).sum())} sentinels inside the ranges "
          f"of {selves.numel()} selves; their neighbor counts == a brute force (max "
          f"{int(brute.max())})")


def grid_band_kernels(cap: dict, scene, params, tick) -> None:
    """(m2): K4+K5 and K8+K9 on one band's spliced slab (its halo rows
    included) against their plain versions, bit for bit; and K4+K5 on the
    same slab in band-local rows with the noise row offset lo - 1, equal to
    both its plain version and the global-row launch."""
    import torch

    from sand_crate_tpu_torch.ops import pair_kernel as pk

    M, nx = scene.cell_capacity, scene.grid_nx
    slab, rs, ps, out = cap["slab"], cap["row_start"], cap["ps"], cap["out"]
    lo, hi = int(cap["lo"]), int(cap["hi"])
    amp = cap["noise_amp"]
    pr = params
    n = int(rs[-1])
    coefs = (pr.diameter, pr.surface_smoothing, pr.target_pressure, pr.spring_overlap_balance,
             pr.ignored_pressure, amp, tick)
    a_kernel = pk.pair_pass_a(slab, rs, M, nx, pr.diameter, amp, tick)
    exact("(m2) band pair_pass_a", a_kernel,
          pk.pair_pass_a_slab_plain(slab, rs, M, nx, pr.diameter, amp, tick))
    e_kernel = pk.pair_pass_b_emit(slab, ps, rs, M, nx, *coefs)
    exact("(m2) band pair_pass_b_emit", e_kernel,
          pk.pair_pass_b_emit_plain(slab, ps, rs, M, nx, *coefs))
    check(torch.equal(e_kernel, out), "(m2) band emit differs from the step's launch")
    local = slab.clone()
    local[pk.ROW, :n] -= lo - 1
    rs_local = rs[lo - 1:hi + 2].contiguous()
    a_local = pk.pair_pass_a(local, rs_local, M, nx, pr.diameter, amp, tick, row_offset=lo - 1)
    exact("(m2) band pair_pass_a, local rows", a_local,
          pk.pair_pass_a_slab_plain(local, rs_local, M, nx, pr.diameter, amp, tick,
                                    row_offset=lo - 1))
    check(torch.equal(a_local, a_kernel), "(m2) local-row pass A differs from the global-row one")
    halo = int((slab[pk.ROW, :n] == lo - 1).sum()) + int((slab[pk.ROW, :n] == hi).sum())
    print(f"  (m2) band 1 (rows {lo}-{hi - 1}): spliced slab of {n} alive columns ({halo} halo "
          f"columns in rows {lo - 1} and {hi}); pair_pass_a and pair_pass_b_emit == plain bit "
          f"for bit; pair_pass_a in local rows {lo - 1}..{hi} with row offset {lo - 1} == plain "
          f"== the global-row launch (launches counted outside the band runs)")


def small_legs() -> None:
    """(m3): tests/test_spatial.py's scenes on the card, bands on a
    LocalGroup of 4 against the single-device step, at its tick counts."""
    import dataclasses

    import torch

    from sand_crate_tpu_torch.collectives import LocalGroup
    from sand_crate_tpu_torch.physics import step
    from sand_crate_tpu_torch.scene import build_scene, init_state
    from sand_crate_tpu_torch.spatial import (
        _halo_cap, initial_band_edges, make_spatial_step, merge_state, split_state,
    )
    from sand_crate_tpu_torch.state import Params

    w = band_world(256, block=True)
    params = Params.from_coefficients(w.coefficients, "cuda")
    group = LocalGroup(BAND_SHARDS, device="cuda")
    try:
        legs = [(m, t, False) for m, t in BAND_SMALL.items()]
        legs += [("pmajor", BAND_SMALL["pmajor"], True), ("cellwise", BAND_SMALL["cellwise"], True)]
        for mode, ticks, rebalance in legs:
            scene = build_scene(w, capacity=1024, forces_mode=mode, device="cuda")
            s0 = init_state(w, scene, seed=0)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            single = s0
            for _ in range(ticks):
                single, _ = step(single, params, scene, gen)
            edges = initial_band_edges(s0, scene, BAND_SHARDS) if rebalance else None
            split = split_state(s0, scene, BAND_SHARDS, edges)
            band = make_spatial_step(group, scene, rebalance=rebalance)
            for _ in range(ticks):
                if rebalance:
                    split, stats = band(split, params, edges)
                    edges = stats["band_edges"]
                else:
                    split, stats = band(split, params)
            check(int(stats["migration_dropped"]) == 0 and int(stats["neighbor_overflow"]) == 0,
                  f"(m3) {mode}: {stats}")
            band_vs_single(f"(m3) {mode}{' rebalanced' if rebalance else ''}, {ticks} ticks",
                           single, merge_state(split, scene, BAND_SHARDS))

        w = band_world(40, block=False)
        scene = build_scene(w, capacity=256, forces_mode="cellwise", device="cuda")
        p40 = Params.from_coefficients(w.coefficients, "cuda")
        split = split_state(init_state(w, scene, seed=0), scene, BAND_SHARDS)
        band = make_spatial_step(group, scene)
        for _ in range(120):
            split, stats = band(split, p40)
        total = int(stats["particle_count"])
        check(0 < total <= 40 + scene.max_spawn * scene.num_sources, f"(m3) spawn budget {total}")
        w = band_world(200, block=False)
        scene = build_scene(w, capacity=256, forces_mode="cellwise", device="cuda")
        spike = dataclasses.replace(scene, max_spawn=2,
                                    src_flow=torch.full_like(scene.src_flow, 5000.0))
        _, stats = make_spatial_step(group, spike)(
            split_state(init_state(w, spike, seed=0), spike, BAND_SHARDS),
            Params.from_coefficients(w.coefficients, "cuda"))
        trunc = int(stats["spawn_truncated"])
        check(trunc > 0, "(m3) spawn truncation not counted")
    finally:
        group.close()

    w = band_world(256, block=True)
    scene = build_scene(w, capacity=1024, forces_mode="pmajor", device="cuda")
    hc = _halo_cap(scene)
    s0 = init_state(w, scene, seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    P, n = scene.capacity, 2 * hc
    pos = torch.zeros((P, 2), device="cuda")
    pos[:n, 0] = 0.1 + 0.8 * torch.rand(n, device="cuda", generator=gen)
    pos[:n, 1] = (scene.grid_ny // 2 - 1.5) * scene.cell_size
    alive = torch.arange(P, device="cuda") < n
    g2 = LocalGroup(2, device="cuda")
    try:
        _, stats = make_spatial_step(g2, scene)(
            split_state(s0._replace(pos=pos, alive=alive), scene, 2), params)
    finally:
        g2.close()
    spill = int(stats["neighbor_overflow"])
    check(spill >= hc, f"(m3) halo spill {spill} < {hc}")
    print(f"  (m3) spawn budget: {total} alive after 120 ticks (cap 40 + one tick); spawn "
          f"truncation counted {trunc}; halo spill: {n} particles in one edge row, overflow "
          f"{spill} >= halo cap {hc}, sent runs {stats['shard_sent'].tolist()}")
    sentinel_case(params)


def soak_extras(crate) -> str:
    """(n1): the alive count, the alive particles over RUNAWAY_SPEED and
    the fullest cell at the crate's state."""
    import torch

    from sand_crate_tpu_torch.cellwise import cell_ids_grid

    st, sc = crate.state, crate.scene
    speed = st.vel[st.alive].norm(dim=1)
    cid = cell_ids_grid(st.pos, st.alive, sc).long()
    counts = torch.bincount(cid, minlength=sc.grid_nx * sc.grid_ny + 1)[:-1]
    cell = int(counts.argmax())
    return (f"  alive {int(st.alive.sum())}, over speed {RUNAWAY_SPEED:g}: "
            f"{int((speed > RUNAWAY_SPEED).sum())}, fullest cell (x {cell % sc.grid_nx}, "
            f"y {cell // sc.grid_nx}) holding {int(counts[cell])}")


def engine_tools(smi: str) -> dict:
    """Phase (n): the engine tools of sand_crate_tpu_torch/tools/ called
    in-process on the card; a non-zero return or a broken gate fails the
    run.  Returns every kernel's launches over the phase."""
    from sand_crate_tpu_torch import Crate
    from sand_crate_tpu_torch.config import CONFIGS_DIR, load_config
    from sand_crate_tpu_torch.ops import pmajor
    from sand_crate_tpu_torch.tools import (
        chunked_sweep, occupancy_stats, perf_probe, rebalance_midscale,
        small_n_probe, soak, spatial_balance,
    )

    reset_kernel_counts()
    print(f"engine tools on {smi}:")
    with phase("(n1) soak, 1M dam break"):
        crate = Crate(dam_break_world(N_TARGET), device="cuda")
        n0, sc = crate.particle_count, crate.scene
        print(f"(n1) soak: N={n0:,} cap={sc.capacity:,} mode={sc.forces_mode} grid="
              f"{sc.grid_nx}x{sc.grid_ny} total={SOAK_TICKS} chunk={SOAK_CHUNK}", flush=True)
        check(n0 == 1_001_700 and sc.forces_mode == "pmajor", "(n1) the 1M world on p-major")
        records = []
        for r in soak.soak_chunks(crate, SOAK_TICKS, SOAK_CHUNK):
            records.append(r)
            print(soak_extras(crate), flush=True)
        launched = dict(pmajor.LAUNCHES)  # reset at the phase's start
        wall = sum(r["seconds"] for r in records)
        rc = soak.verdict(records, wall)
        print(f"(n1) sustained {SOAK_TICKS / wall:.3f} steps/s over {SOAK_TICKS} ticks on {smi}; "
              f"K1/K2 launches {launched}; the soak returns {rc}")
        check(rc == 0, "(n1) the 1M soak broke an invariant")
        check(launched == {"a": SOAK_TICKS, "b": SOAK_TICKS, "sub_a": 0, "sub_b": 0,
                           "prep": SOAK_TICKS, "slab_b": SOAK_TICKS},
              f"(n1) launches {launched}")
        del crate

    with phase("(n2) soak, wave_machine"):
        crate = Crate(load_config(CONFIGS_DIR / "wave_machine.yaml").world_config, device="cuda")
        print(f"(n2) wave_machine soak: capacity {crate.scene.capacity}, mode "
              f"{crate.scene.forces_mode}, {WAVE_SOAK_TICKS} ticks in chunks of {SOAK_CHUNK}")
        records = list(soak.soak_chunks(crate, WAVE_SOAK_TICKS, SOAK_CHUNK))
        rc = soak.verdict(records, sum(r["seconds"] for r in records))
        after = [(r["tick"], r["alive"]) for r in records if r["tick"] > WAVE_SOURCE_TICKS]
        print(f"(n2) alive after the source stops: {after}; max speed per chunk "
              f"{[round(r['max_speed'], 3) for r in records]}")
        check(rc == 0, "(n2) the wave_machine soak broke an invariant")
        check(len({a for _, a in after}) == 1, "(n2) the alive count moved after the source stopped")
        del crate

    with phase("(n3) perf_probe"):
        for n in PROBE_SIZES:
            rate = perf_probe.probe(n)
            check(rate > 0, f"(n3) perf_probe at {n}")

    with phase("(n4) occupancy_stats"):
        stats = occupancy_stats.main(N_TARGET, OCC_TICKS)
        check(all(s["occupied_cells"] > 0 for s in stats), "(n4) occupancy")

    with phase("(n5) rebalance_midscale"):
        t0 = time.perf_counter()
        rc = rebalance_midscale.main(**MIDSCALE)
        print(f"(n5) rebalance_midscale returns {rc} in {time.perf_counter() - t0:.2f} s")
        check(rc == 0, "(n5) a gate of rebalance_midscale broke")

    with phase("(n6) spatial_balance"):
        for rebalance in (False, True):
            samples = spatial_balance.main(BALANCE_SHARDS, BALANCE_TICKS, rebalance=rebalance)
            t, shard = samples[-1]
            print(f"(n6) {'rebalanced' if rebalance else 'uniform'}: tick {t} max/mean "
                  f"{max(shard) / (sum(shard) / len(shard)):.4f}")
            check(all(sum(s) == sum(samples[0][1]) for _, s in samples),
                  "(n6) the bands lost a particle")

    with phase("(n7) chunked_sweep --fill"):
        hist = chunked_sweep.fill(FILL_CRATES)
        check(hist == [0] * len(hist), f"(n7) chunked fill overflow {hist}")

    with phase("(n8) small_n_probe"):
        print(f"(n8) small_n_probe at {SMALL_N}: {SMALL_N_CHUNKS} chunks (the tool's default "
              f"is 20)")
        rows = small_n_probe.main(SMALL_N, SMALL_N_CHUNKS)
        check(all(v > 0 for v in rows.values()), "(n8) small_n_probe")
    return kernel_counts()


# --------------------------------------------------------------------------
# (q) the boundary chain: the ghost pass and the CCD clamp (csrc/boundary.cu)
# --------------------------------------------------------------------------


def boundary_counts() -> dict:
    """The boundary kernels' and the velocity update's launch counters
    (ops/boundary.py, ops/kick.py)."""
    from sand_crate_tpu_torch.ops import boundary, kick

    return {**{f"boundary.{k}": v for k, v in boundary.LAUNCHES.items()},
            **{f"kick.{k}": v for k, v in kick.LAUNCHES.items()}}


def boundary_want(ticks: int, mode: str, calls: int = 1, staged: int = 0) -> dict:
    """The boundary counters' rise over ``ticks`` ticks of ``calls`` crates
    or bands on backend ``mode``: the full and the positions-only ghost pass
    GHOSTS_A_TICK[mode] times a tick; the velocity update once a tick, all
    stages in one launch, or (the instrumented tick, ``staged`` its kick
    phases) one launch a stage: the kicks but the clamp and the integrate
    counted as single stages, the clamp as ``ccd``."""
    full, pos_only = GHOSTS_A_TICK[mode]
    n = ticks * calls
    return {"boundary.ghost": full * n, "boundary.ghost_pos": pos_only * n,
            "kick.velocity_update": 0 if staged else n,
            "kick.velocity_update_stage": staged * n, "kick.ccd": n if staged else 0}


def check_boundary(label: str, want: dict) -> dict:
    got = boundary_counts()
    check(got == want, f"{label}: boundary launches {got} != {want}")
    return got


def same_values(label: str, got, want) -> float:
    """Kernel outputs against their plain versions' (a tensor or a tuple):
    the same shape and dtype, NaN in the same places, every other value
    equal (max abs error 0) and the same bits (signed zeros and NaN
    payloads too).  Returns the max abs error."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst, bits = 0.0, 0
    for k, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            check(a is None and b is None, f"{label}[{k}]: one output is missing")
            continue
        check(a.shape == b.shape and a.dtype == b.dtype, f"{label}[{k}]: shape or dtype differs")
        if not a.is_floating_point():
            check(torch.equal(a, b), f"{label}[{k}]: kernel differs from its plain version")
            continue
        nan = torch.isnan(a)
        check(torch.equal(nan, torch.isnan(b)), f"{label}[{k}]: NaN in other places")
        a0, b0 = torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)
        err = float((a0 - b0).abs().nan_to_num(nan=math.inf).max()) if a.numel() else 0.0
        check(torch.equal(a0, b0), f"{label}[{k}]: kernel differs from its plain version "
                                   f"(max abs err {err})")
        bits += int((a.view(torch.int32) != b.view(torch.int32)).sum())
        worst = max(worst, err)
    check(bits == 0, f"{label}: {bits} elements differ in their bits")
    return worst


def kick_bytes(stages: int, operands) -> int:
    """The bytes a launch of the update over ``stages`` must move: each
    operand it reads, once (an expanded plane: its one element), and its
    outputs written once."""
    from sand_crate_tpu_torch.ops import kick

    named = dict(zip(kick.PER_CRATE + ("seg_valid",), operands))
    P = named["vel"].shape[-2]
    n = 0
    for name in kick._needs(stages):
        t = named[name]
        n += t.element_size() * (1 if 0 in t.stride() and t.dim() > 1 else t.numel())
    return n + P * (8 + 4 * kick.norm_rows(stages) + (12 if stages & kick.INTEGRATE else 0))


def kick_ops(stages: int, operands) -> int:
    """The f32 operations of the update over ``stages`` on these operands:
    KICK_OPS a slot per stage, and the clamp's walls as this run's moves
    need them (the velocity into the clamp from the plain stages before it)."""
    from sand_crate_tpu_torch import geometry as geo
    from sand_crate_tpu_torch.ops import kick

    named = dict(zip(kick.PER_CRATE + ("seg_valid",), operands))
    alive = named["alive"]
    n = sum(KICK_OPS[bit] for bit in KICK_OPS if stages & bit) * alive.shape[-1]
    if stages & kick.CCD:
        vin = kick.update_plain(stages & kick.KICK_MASK & ~kick.CCD, *operands).vel
        walls = geo.pad_segments(named["segments"], named["particle_radius"])
        wx = walls[:, 1, 0] - walls[:, 0, 0]
        wy = walls[:, 1, 1] - walls[:, 0, 1]
        mv = vin * named["dt"]
        valid = named["seg_valid"].repeat(2)
        ahead = (wy[:, None] * mv[:, 0] - wx[:, None] * mv[:, 1]) < 0.0
        n += CCD_WALL_OPS * walls.shape[0] * int(alive.sum())
        n += CCD_CROSS_OPS * int((ahead & valid[:, None] & alive[None]).sum())
    return n


def staged_update(stages: int, operands, update):
    """The update a stage a launch, as the instrumented tick runs it: each
    kick in ``stages`` with its norm row, the rows stacked, then the
    integrate."""
    import torch

    from sand_crate_tpu_torch.ops import kick

    vel, rows = operands[0], []
    for stage in kick.KICKS:
        if stages & stage:
            out = update(stage | kick.NORMS, vel, *operands[1:])
            vel, rows = out.vel, rows + [out.norms]
    out = update(kick.INTEGRATE, vel, *operands[1:])
    return out._replace(norms=torch.cat(rows))


def update_vs_plain(label: str, stages: int, operands) -> float:
    """The update's kernel, fused and a stage at a time, against its plain
    version, and staged against fused, bit for bit.  Returns the max abs
    error."""
    from sand_crate_tpu_torch.ops import kick

    fused = kick.update(stages, *operands)
    err = same_values(f"velocity_update fused, {label}", tuple(fused),
                      tuple(kick.update_plain(stages, *operands)))
    staged = staged_update(stages, operands, kick.update)
    err = max(err, same_values(f"velocity_update staged, {label}", tuple(staged),
                               tuple(staged_update(stages, operands, kick.update_plain))))
    same_values(f"velocity_update staged vs fused, {label}", tuple(staged), tuple(fused))
    same_values(f"force_dv staged vs fused, {label}", kick.force_dv(staged.norms, staged.cnt),
                kick.force_dv(fused.norms, fused.cnt))
    return err


def boundary_rows(crate, smi: str) -> list:
    """Phase (q): the ghost pass (full and positions-only) and the velocity
    update (fused, a stage a launch, the clamp alone) against their plain
    versions at the crate's (settled 1M) state, in slot and in the tick's
    sorted order, on every case of ops/boundary_cases.py and
    ops/kick_cases.py, and in vmapped batches of BOUNDARY_CRATES crates
    against each crate alone; their times and bounds.  Returns the rows."""
    import torch

    from sand_crate_tpu_torch import physics
    from sand_crate_tpu_torch.ops import boundary, boundary_cases, kick, kick_cases

    pr, sc = crate.params, crate.scene
    s = physics.advance_bodies(physics.cull_particles(crate.state, pr), pr, sc)
    shared = (sc.seg_valid, sc.seg_body, sc.body_center)

    def ghost_args(prepos, alive):
        return (prepos, alive, s.segments, s.body_lin_vel, s.body_ang_vel, pr.particle_radius,
                *shared)

    def pos_args(prepos, alive):
        return (prepos, alive, s.segments, pr.particle_radius, sc.seg_valid)

    slot = ghost_args(s.pos, s.alive)
    cid, order = torch.sort(physics.cell_ids_grid(boundary.ghost_pos_plain(*pos_args(
        s.pos, s.alive)), s.alive, sc), stable=True)
    sorted_ = ghost_args(s.pos[order], cid < sc.num_cells)
    P, S = s.pos.shape[0], sc.num_segments
    probe = torch.tensor([math.nan, -0.0, 0.0, 1.0, -math.inf], device="cuda")
    print(f"  torch.sign on the card of (nan, -0, 0, 1, -inf): {torch.sign(probe).tolist()}")
    errs = dict.fromkeys(BOUNDARY_REPLACES, 0.0)
    for label, args in (("slot order", slot), ("sorted order", sorted_)):
        got = boundary.ghost_pass(*args)
        errs["ghost_pass"] = max(errs["ghost_pass"], same_values(
            f"ghost_pass, 1M {label}", got, boundary.ghost_pass_plain(*args)))
        pos_only = boundary.ghost_pos(*pos_args(*args[:2]))
        errs["ghost_pos"] = max(errs["ghost_pos"], same_values(
            f"ghost_pos, 1M {label}", pos_only, boundary.ghost_pos_plain(*pos_args(*args[:2]))))
        same_values(f"ghost_pos vs ghost_pass's pos, 1M {label}", pos_only, got[0])
        print(f"  1M {label}: ghost_pass and ghost_pos == plain (max abs err 0, bits equal), "
              f"ghost_pos == ghost_pass's pos; {int(args[1].sum())} alive of {P}, ghost "
              f"contacts {int(got[1].sum())}")

    # the tick's velocity update at this state: the sorted operands and pair
    # sums of the crate's backend (p-major: its sums as transposed views)
    ghost = physics.GhostInfo(boundary.ghost_pos(*pos_args(s.pos, s.alive)), None, None, None)
    ops = physics.neighbor_stage(
        s.vel, s.alive, s.uid, ghost, s.tick, pr, sc, prepos=s.pos, segments=s.segments,
        body_lin_vel=s.body_lin_vel, body_ang_vel=s.body_ang_vel,
        generator=torch.Generator(device="cuda"))
    operands = kick.operands(ops.vel, ops.pos, ops.alive, ops.sums, ops.ghost, s.segments, pr,
                             sc.seg_valid)
    st = kick.fused(sc.enable_spring)
    print(f"  the update's operands at 1M (sorted order): strides dv_tension "
          f"{tuple(ops.sums.dv_tension.stride())}, pressure_real "
          f"{tuple(ops.sums.pressure_real.stride())}, visc_vsum "
          f"{tuple(ops.sums.visc_vsum.stride())}")
    for name in ("velocity_update", "velocity_update_staged"):
        errs[name] = update_vs_plain("1M sorted order", st, operands)
    vin = kick.update_plain(st & kick.KICK_MASK & ~kick.CCD, *operands).vel
    ccd = (ops.pos, vin, ops.alive, s.segments, pr.particle_radius, pr.dt, sc.seg_valid)
    new_vel = kick.continuous_collision(*ccd)
    errs["continuous_collision"] = same_values("continuous_collision, 1M sorted order", new_vel,
                                               kick.continuous_collision_plain(*ccd))
    clamped = int(((new_vel != vin).any(dim=1) & ops.alive).sum())
    print(f"  1M sorted order: velocity_update fused and staged == plain, staged == fused "
          f"(force_dv too), the clamp alone == plain; particles clamped {clamped}")

    ccd_ops = kick._ccd_operands(*ccd)
    stage_list = [k | kick.NORMS for k in kick.KICKS if st & k] + [kick.INTEGRATE]
    stage_ops = [(k, (vin if k & kick.CCD else ops.vel,) + operands[1:]) for k in stage_list]
    timed = {
        "ghost_pass": (lambda: boundary.ghost_pass(*sorted_),
                       lambda: boundary.ghost_pass_plain(*sorted_),
                       GHOST_BYTES * P, P * (S * GHOST_OPS + GHOST_PARTICLE_OPS), BOUNDARY_SOURCE),
        "ghost_pos": (lambda: boundary.ghost_pos(*pos_args(*slot[:2])),
                      lambda: boundary.ghost_pos_plain(*pos_args(*slot[:2])),
                      GHOST_POS_BYTES * P, P * (S * GHOST_POS_OPS + GHOST_PARTICLE_OPS),
                      BOUNDARY_SOURCE),
        "velocity_update": (lambda: kick.update(st, *operands),
                            lambda: kick.update_plain(st, *operands),
                            kick_bytes(st, operands), kick_ops(st, operands), KICK_SOURCE),
        "continuous_collision": (lambda: kick.continuous_collision(*ccd),
                                 lambda: kick.continuous_collision_plain(*ccd),
                                 kick_bytes(kick.CCD, ccd_ops), kick_ops(kick.CCD, ccd_ops),
                                 KICK_SOURCE),
    }
    rows = []
    for name, (run, plain, n_bytes, n_ops, source) in timed.items():
        rows.append(kernel_row(name, source, BOUNDARY_REPLACES[name], errs[name],
                               cuda_ms(run, 20), cuda_ms(plain, 5), n_bytes, n_ops))
    # a stage a launch: the sum of each stage's time, plain time and bound
    per = [(cuda_ms(lambda k=k, o=o: kick.update(k, *o), 20),
            cuda_ms(lambda k=k, o=o: kick.update_plain(k, *o), 5),
            *bound(kick_bytes(k, o), kick_ops(k, o))) for k, o in stage_ops]
    staged = kernel_row("velocity_update_staged", KICK_SOURCE,
                        BOUNDARY_REPLACES["velocity_update_staged"],
                        errs["velocity_update_staged"], sum(p[0] for p in per),
                        sum(p[1] for p in per), 0, 0)
    staged["bound_ms"] = sum(p[2] for p in per)
    staged["bound_by"] = "bytes" if all(p[3] == "bytes" for p in per) else "operations"
    rows.insert(3, staged)
    print(f"  the update a stage a launch at 1M: kernel ms {[round(p[0], 4) for p in per]}, "
          f"bounds {[round(p[2], 4) for p in per]}")
    for r in rows:
        print(f"  {r['name']} at 1M ({smi}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"share {r['bound_ms'] / r['ms']:.2f} (median, CUDA events)")

    print("  the hard inputs of ops/boundary_cases.py:")
    for case, (_, _, claim) in boundary_cases.CASES.items():
        facts = boundary_cases.facts(case, "cuda")
        check(facts["holds"], f"boundary case {case}: does not hold what it claims ({facts})")
        c = boundary_cases.inputs(case, "cuda")
        g, v = boundary_cases.ghost_args(c), boundary_cases.ccd_args(c)
        p = (c["prepos"], c["alive"], c["segments"], c["r"], c["seg_valid"])
        if case == "batch":
            per = [boundary_cases.crate(c, b) for b in range(c["r"].shape[0])]
            ghost_out = torch.ops.sand_crate.ghost_pass(*g)
            pos_out = torch.ops.sand_crate.ghost_pos(*p)
            for b, one in enumerate(per):
                same_values(f"ghost_pass, case batch crate {b}", tuple(o[b] for o in ghost_out),
                            boundary.ghost_pass_plain(*boundary_cases.ghost_args(one)))
                same_values(f"ghost_pos, case batch crate {b}", pos_out[b],
                            boundary.ghost_pos_plain(one["prepos"], one["alive"],
                                                     one["segments"], one["r"],
                                                     one["seg_valid"]))
            vmapped_vs_alone("case batch", g, v)
        else:
            same_values(f"ghost_pass, case {case}", boundary.ghost_pass(*g),
                        boundary.ghost_pass_plain(*g))
            same_values(f"ghost_pos, case {case}", boundary.ghost_pos(*p),
                        boundary.ghost_pos_plain(*p))
            same_values(f"continuous_collision, case {case}", kick.continuous_collision(*v),
                        kick.continuous_collision_plain(*v))
        shown = {k: x for k, x in facts.items() if x and k != "holds"}
        print(f"    {case} ({claim}): == plain; {shown}")

    print("  the hard inputs of ops/kick_cases.py (fused, a stage a launch):")
    for case, (_, _, claim) in kick_cases.CASES.items():
        facts = kick_cases.facts(case, "cuda")
        check(facts["holds"], f"kick case {case}: does not hold what it claims ({facts})")
        c = kick_cases.inputs(case, "cuda")
        if case == "batch":
            cst = kick_cases.stages(c)
            before = boundary_counts()["kick.velocity_update"]
            out = torch.ops.sand_crate.velocity_update(*kick_cases.args(c), cst)
            check(boundary_counts()["kick.velocity_update"] == before + 1,
                  "the batch case's operator: one launch")
            for b in range(c["dt"].shape[0]):
                one = kick_cases.crate(c, b)
                same_values(f"velocity_update, case batch crate {b}",
                            tuple(kick._kick_out(cst, tuple(o[b] for o in out))),
                            tuple(kick.update_plain(cst, *kick_cases.args(one))))
                update_vs_plain(f"case batch crate {b}", cst, kick_cases.args(one))
            vmapped_updates("case batch", cst, kick_cases.args(c))
        else:
            update_vs_plain(f"case {case}", kick_cases.stages(c), kick_cases.args(c))
        shown = {k: x for k, x in facts.items() if x and k != "holds"}
        print(f"    {case} ({claim}): == plain; {shown}")

    # vmapped batches at 1M: the sorted-order crate with radii, steps and
    # viscosities of its own in each of BOUNDARY_CRATES crates
    scale = torch.linspace(0.9, 1.1, BOUNDARY_CRATES, device="cuda")
    stack = lambda x: torch.stack([x] * BOUNDARY_CRATES)  # noqa: E731
    g = tuple(stack(x) for x in sorted_[:5]) + (pr.particle_radius * scale,) + shared
    fixed = boundary.ghost_pass_plain(*sorted_)[0]
    v = tuple(stack(x) for x in (fixed, s.vel[order], sorted_[1], s.segments)) + (
        pr.particle_radius * scale, pr.dt * scale.flip(0), sc.seg_valid)
    vmapped_vs_alone("1M sorted order", g, v)
    per_crate = [None if x is None else stack(x) for x in operands[:-1]]
    named = kick.PER_CRATE
    for name, k in (("dt", scale.flip(0)), ("particle_radius", scale), ("viscosity", scale)):
        i = named.index(name)
        per_crate[i] = operands[i] * k
    vmapped_updates("1M sorted order", st, tuple(per_crate) + (sc.seg_valid,))
    return rows


def vmapped_updates(label: str, stages: int, operands) -> None:
    """(q): the velocity update under torch.func.vmap over a crate axis (one
    launch for all crates) against each crate alone, kernel and plain, bit
    for bit; ``operands`` batched (crate axis first; seg_valid shared)."""
    import torch

    from sand_crate_tpu_torch.ops import kick

    n = operands[0].shape[0]
    before = boundary_counts()["kick.velocity_update"]
    dims = tuple(None if x is None else 0 for x in operands[:-1]) + (None,)
    out = torch.func.vmap(lambda *o: tuple(kick.update(stages, *o)), in_dims=dims,
                          randomness="different")(*operands)
    rise = boundary_counts()["kick.velocity_update"] - before
    check(rise == 1, f"{label}: the vmapped update launched {rise} times (one for all crates)")
    for b in range(n):
        one = tuple(None if x is None else x[b] for x in operands[:-1]) + operands[-1:]
        for what, ref in (("alone", kick.update(stages, *one)),
                          ("plain", kick.update_plain(stages, *one))):
            same_values(f"vmapped velocity_update, {label}, crate {b} vs {what}",
                        tuple(o[b] for o in out), tuple(ref))
    print(f"    vmapped update, {label}: {n} crates, one launch, == each crate alone (kernel "
          f"and plain)")


def vmapped_vs_alone(label: str, g, v) -> None:
    """(q): the ghost pass (full and positions-only) and the clamp under
    torch.func.vmap over a crate axis (one launch each for all crates)
    against each crate alone, kernel and plain, bit for bit; ``g`` and
    ``v`` are the batched arguments (crate axis first, the scene's tensors
    unbatched)."""
    import torch

    from sand_crate_tpu_torch.ops import boundary, kick

    n = g[0].shape[0]
    p = (g[0], g[1], g[2], g[5], g[6])
    before = boundary_counts()
    ghost = torch.func.vmap(boundary.ghost_pass, in_dims=(0,) * 6 + (None,) * 3,
                            randomness="different")(*g)
    pos_only = torch.func.vmap(boundary.ghost_pos, in_dims=(0,) * 4 + (None,))(*p)
    ccd = torch.func.vmap(kick.continuous_collision, in_dims=(0,) * 6 + (None,),
                          randomness="different")(*v)
    rise = {k: boundary_counts()[k] - before[k] for k in before}
    check(rise == {"boundary.ghost": 1, "boundary.ghost_pos": 1, "kick.velocity_update": 0,
                   "kick.velocity_update_stage": 0, "kick.ccd": 1},
          f"{label}: the vmapped wrappers launched {rise} (one each for all crates)")
    for b in range(n):
        one_g = tuple(x[b] for x in g[:6]) + g[6:]
        one_p = tuple(x[b] for x in p[:4]) + p[4:]
        one_v = tuple(x[b] for x in v[:6]) + v[6:]
        for what, ref in (("alone", boundary.ghost_pass(*one_g)),
                          ("plain", boundary.ghost_pass_plain(*one_g))):
            same_values(f"vmapped ghost_pass, {label}, crate {b} vs {what}",
                        tuple(o[b] for o in ghost), ref)
        for what, ref in (("alone", boundary.ghost_pos(*one_p)),
                          ("plain", boundary.ghost_pos_plain(*one_p))):
            same_values(f"vmapped ghost_pos, {label}, crate {b} vs {what}", pos_only[b], ref)
        for what, ref in (("alone", kick.continuous_collision(*one_v)),
                          ("plain", kick.continuous_collision_plain(*one_v))):
            same_values(f"vmapped continuous_collision, {label}, crate {b} vs {what}", ccd[b],
                        ref)
    print(f"    vmapped, {label}: {n} crates, one launch of each kernel, == each crate alone "
          f"(kernel and plain)")


def apply_functions() -> None:
    """(q3): the seven per-kick functions of physics (apply_tension ...
    apply_continuous_collision, the JAX package's public per-kick entry
    points) on every solo case of ops/kick_cases.py: each call one launch of
    B2 of its launch kind (velocity_update_stage; the clamp ccd) and no
    other boundary launch, its velocity and mean |dv| bit for bit the plain
    update of its single stage."""
    from sand_crate_tpu_torch.ops import kick, kick_cases

    cases = [c for c in kick_cases.CASES if c != "batch"]
    for name, (stage, _) in kick_cases.APPLY.items():
        kind = kick.launch_kind(stage)
        for case in cases:
            c = kick_cases.inputs(case, "cuda")
            fn, args = kick_cases.apply_call(name, c)
            before = boundary_counts()
            got = fn(*args)
            rise = {k: v - before[k] for k, v in boundary_counts().items() if v != before[k]}
            check(rise == {"kick." + kind: 1}, f"(q3) apply_{name} on {case}: launches {rise}")
            same_values(f"(q3) apply_{name} on {case}", got, kick_cases.apply_plain(name, c))
    print(f"  (q3) physics.apply_* ({', '.join(kick_cases.APPLY)}) on {len(cases)} cases of "
          "ops/kick_cases.py: one B2 launch each of its kind, == the plain single stage bit "
          "for bit (velocity and mean |dv|)")


def escape_check(smi: str) -> None:
    """(q2) Queue 3's open check: the 1M dam break of (n1)'s soak (fresh, on
    auto: p-major) for ESCAPE_TICKS ticks, one replay at a time.  After each
    tick the alive particles outside [-r, 1 + r] (the next tick culls them)
    are found; that tick is run again eagerly from the state before it (the
    same bits) with the ghost pass's and the velocity update's inputs kept
    (the velocity into the clamp from the plain stages before it), and each
    escaping particle's row is printed as JSON: its pre-fix and fixed
    position, its velocity into and out of the clamp, the segments, r and
    dt; tests/test_torch_boundary.py holds them on the CPU."""
    import torch

    from sand_crate_tpu_torch import Crate, physics
    from sand_crate_tpu_torch.ops import boundary, kick

    crate = Crate(dam_break_world(N_TARGET), device="cuda", forces_mode="auto")
    r = crate.params.particle_radius
    kept, found, t0 = {}, [], time.perf_counter()

    def keep(name, fn):
        def run(*args):
            out = fn(*args)
            kept[name] = (args, out)
            return out
        return run

    for tick in range(ESCAPE_TICKS):
        before, g0 = clone_state(crate.state), crate.generator.get_state()
        crate.run(1)
        st = crate.state
        out = ((st.pos < -r) | (st.pos > 1.0 + r)).any(dim=1) & st.alive
        if not bool(out.any()):
            continue
        after_gen = crate.generator.get_state()
        gen = torch.Generator(device="cuda")
        gen.set_state(g0)
        real = (boundary.ghost_pass, kick.update)
        boundary.ghost_pass = keep("ghost", real[0])
        kick.update = keep("update", real[1])
        try:
            eager, _ = physics.step(before, crate.params, crate.scene, gen)
        finally:
            boundary.ghost_pass, kick.update = real
        same_bits(f"(q2) tick {tick}: eager re-run vs the replay", eager, st)
        check(torch.equal(gen.get_state(), after_gen), f"(q2) tick {tick}: generator")
        (prepos, _, segments, *_), (fixed, g_cnt, _, _) = kept["ghost"]
        (stages, *operands), done = kept["update"]
        named = dict(zip(kick.PER_CRATE, operands))
        pos, alive, rad, dt = (named[k] for k in ("pos", "alive", "particle_radius", "dt"))
        # the velocity into the clamp: the kicks before it (the plain
        # version gives the kernel's bits, phase (q))
        vel = kick.update_plain(stages & kick.KICK_MASK & ~kick.CCD, *operands).vel
        new_vel = done.vel
        end = pos + dt * new_vel
        escaped = (((end < -r) | (end > 1.0 + r)).any(dim=1) & alive).nonzero().flatten()
        for i in escaped.tolist():
            row = dict(tick=tick, prepos=prepos[i].tolist(), pos=pos[i].tolist(),
                       vel=vel[i].tolist(), new_vel=new_vel[i].tolist(), end=end[i].tolist(),
                       g_cnt=float(g_cnt[i]), r=float(rad), dt=float(dt),
                       segments=segments.tolist())
            found.append(row)
            if len(found) <= ESCAPE_PRINT:
                print(f"  escape row: {json.dumps(row)}")
    wall = time.perf_counter() - t0
    print(f"  (q2) {crate.particle_count} alive after {ESCAPE_TICKS} ticks ({smi}, {wall:.1f} s): "
          f"{len(found)} particles left [-r, 1 + r] (rows printed: "
          f"{min(len(found), ESCAPE_PRINT)}); through the CCD's start already outside: "
          f"{sum(1 for f in found if not all(-f['r'] <= x <= 1 + f['r'] for x in f['pos']))}")


# --------------------------------------------------------------------------
# (o) the compiled step loop: replayed CUDA graphs (sand_crate_tpu_torch/graphs.py)
# --------------------------------------------------------------------------


def same_bits(label: str, got, want) -> None:
    """Every field of two CrateStates / Diagnostics equal bit for bit."""
    import torch

    for name, a, b in zip(got._fields, got, want):
        check(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b),
              f"{label}: replayed != eager in {name}")


def eager_loop(state, params, scene, generator, ticks: int, live_rows=None, batched=False):
    """The explicit eager loop of physics.step (or of the vmapped step) that
    the graphs are held against; returns (state, last diag, largest
    overflow over the ticks)."""
    import torch

    from sand_crate_tpu_torch.physics import step
    from sand_crate_tpu_torch.sweep import batched_step

    fn = batched_step if batched else step
    worst = None
    for _ in range(ticks):
        state, diag = fn(state, params, scene, generator, live_rows)
        over = diag.neighbor_overflow
        worst = over if worst is None else torch.maximum(worst, over)
    return state, diag, worst


def replay_vs_eager(label: str, crate, ticks: int, edit=None, want_launches=None) -> None:
    """``crate.run(ticks)`` (its tick already captured: every tick a replay),
    with ``edit`` = (coefficient, value) set through Crate.__setattr__ after
    half of them, against the eager loop of physics.step from the same state,
    coefficients and generator state with the same edit: state, last
    Diagnostics and generator state bit for bit.  The edit must not capture
    anew, and each kernel counter must rise as ``want_launches`` says."""
    import torch

    from sand_crate_tpu_torch import graphs

    s0, p0 = clone_state(crate.state), clone_state(crate.params)
    g0 = crate.generator.get_state()
    reset_kernel_counts()
    reset(graphs.LAUNCHES)
    half = ticks // 2
    crate.run(half)
    if edit is not None:
        setattr(crate, *edit)
    diag = crate.run(ticks - half)
    launches, graph_calls = kernel_counts(), dict(graphs.LAUNCHES)
    bounds = check_boundary(label, boundary_want(ticks, crate.scene.forces_mode))
    g_replayed = crate.generator.get_state()
    crate.generator.set_state(g0)
    st, _, _ = eager_loop(s0, p0, crate.scene, crate.generator, half)
    if edit is not None:
        name, value = edit
        p0 = p0._replace(**{name: torch.full_like(getattr(p0, name), value)})
    st, want_diag, _ = eager_loop(st, p0, crate.scene, crate.generator, ticks - half)
    check(torch.equal(crate.generator.get_state(), g_replayed),
          f"{label}: the generator advanced otherwise than eagerly")
    same_bits(label, crate.state, st)
    same_bits(label + " (diagnostics)", diag, want_diag)
    check(graph_calls == {"replay": ticks, "capture": 0, "evict": 0},
          f"{label}: graph calls {graph_calls} (a replay a tick, no capture after the edit)")
    want = dict.fromkeys(launches, 0)
    want.update(want_launches or {})
    check(launches == want, f"{label}: launches {launches} != {want}")
    what = f", {edit[0]} set to {edit[1]} after {half}" if edit else ""
    print(f"  {label}: {ticks} replayed ticks{what} == the eager loop bit for bit "
          f"({crate.particle_count} particles at tick {crate.tick}); graph calls {graph_calls}; "
          f"launches {({k: v for k, v in launches.items() if v}) or 'none'}, {bounds}")


def turns(label: str, smi: str, graph_tick, eager_tick, ticks: int) -> dict:
    """Graph / eager / eager / graph turns of ``ticks`` ticks each: steps/s
    (host clock, closed by a synchronize) and step p50 (CUDA events between
    ticks); then PROFILED_TICKS of each under the profiler (busy share,
    launches a tick with cudaGraphLaunch counted)."""
    import torch

    out = {"graph": [], "eager": []}
    for kind in ("graph", "eager", "eager", "graph"):
        run = graph_tick if kind == "graph" else eager_tick
        events = [torch.cuda.Event(enable_timing=True) for _ in range(ticks + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        for k in range(ticks):
            run()
            events[k + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        p50 = statistics.median(events[k].elapsed_time(events[k + 1]) for k in range(ticks))
        out[kind].append((ticks / wall, p50))

    def loop(fn):
        def run(n):
            for _ in range(n):
                fn()
        return run

    prof = {kind: profiled(loop(fn), PROFILED_TICKS)
            for kind, fn in (("graph", graph_tick), ("eager", eager_tick))}
    print(f"  {label} ({smi}), turns of {ticks} ticks, graph / eager / eager / graph:")
    for kind in ("graph", "eager"):
        (r1, q1), (r2, q2) = out[kind]
        print(f"    {kind}: {r1:.3f} / {r2:.3f} steps/s, step p50 {q1:.4f} / {q2:.4f} ms; "
              f"{prof[kind]}")
    out["profile"] = prof
    return out


def crate_turns(label: str, smi: str, crate, ticks: int = GRAPH_TURN_TICKS) -> dict:
    """turns() of a Crate: its replayed tick against the eager step from a
    copy of its state (the crate's state is not advanced by the eager turns)."""
    from sand_crate_tpu_torch.physics import step

    held = [clone_state(crate.state)]

    def graph_tick():
        crate.graph.step(crate.scene, crate.generator)

    def eager_tick():
        held[0], _ = step(held[0], crate.params, crate.scene, crate.generator)

    return turns(label, smi, graph_tick, eager_tick, ticks)


def graphs_1m(smi: str) -> None:
    """(o1) the 1M dam break on p-major (default, SAND_CRATE_PMSUB=1,
    SAND_CRATE_PMAJOR_GATE=1) and the slot grid: GRAPH_SETTLE ticks through
    Crate.run, then GRAPH_TICKS replayed ticks == the eager loop, then the
    timing turns; at the default one frame of 2 ticks as one replay of a
    2-tick graph against two replays of the 1-tick graph."""
    from sand_crate_tpu_torch import Crate

    for label, (kw, knob_name, launches) in GRAPH_1M.items():
        with knob(knob_name):
            crate = Crate(dam_break_world(N_TARGET), device="cuda", **kw)
            crate.run(GRAPH_SETTLE)
            replay_vs_eager(f"1M {label}", crate, GRAPH_TICKS, want_launches={
                k: GRAPH_TICKS for k in launches})
            out = crate_turns(f"1M {label}", smi, crate)
            if knob_name is None and not kw:
                (_, q1), (_, q2) = out["graph"]
                print(f"  (o) the 1M p-major main path replayed ({smi}): step p50 {q1:.4f} / "
                      f"{q2:.4f} ms (the same tick with its kicks, clamp and integrate as "
                      f"separate passes: {SEPARATE_KICKS_P50} ms on an NVIDIA H100 80GB HBM3 at "
                      f"700 W); {out['profile']['graph']}; eager: {out['profile']['eager']}")
                frame_graph_vs_tick_graphs(smi, crate)
            del crate


def frame_graph_vs_tick_graphs(smi: str, crate) -> None:
    """A trajectory frame of 2 ticks: one replay of a 2-tick graph against
    two replays of the 1-tick graph (the same bits), in turns."""
    g, sc, gen = crate.graph, crate.scene, crate.generator

    def two_tick_graph():
        g.step(sc, gen, ticks=2)

    def two_tick_replays():
        g.step(sc, gen)
        g.step(sc, gen)

    two_tick_graph()
    turns("a frame of 2 ticks at 1M: one replay of a 2-tick graph (as 'graph') vs two "
          "replays of the 1-tick graph (as 'eager')", smi, two_tick_graph, two_tick_replays,
          GRAPH_TURN_TICKS // 2)


def graphs_small(smi: str) -> None:
    """(o2) stirring_cup (an emitter, a motored cup) and wave_machine as one
    crate on dense, chunked and p-major ((j)(a)'s single crates), each run
    SMALL_TICKS ticks, then GRAPH_TICKS replayed ticks with a viscosity
    edit in the middle == the eager loop; then the timing turns; and the
    perf_probe sizes below 1M (10,132 and 100,580: p-major)."""
    import copy

    from sand_crate_tpu_torch import Crate, load_config_dict
    from sand_crate_tpu_torch.bench import STIRRING_CUP, WAVE_MACHINE

    for name, raw in (("stirring_cup", STIRRING_CUP), ("wave_machine", WAVE_MACHINE)):
        world = load_config_dict(copy.deepcopy(raw)).world_config
        for mode in ("dense", "chunked", "pmajor"):
            crate = Crate(world, device="cuda", forces_mode=mode)
            crate.run(SMALL_TICKS)
            edit = ("viscosity", 1.5 * float(crate.viscosity))
            want = dict.fromkeys(PAIR_KEYS[mode], GRAPH_TICKS)
            replay_vs_eager(f"{name} on {mode}", crate, GRAPH_TICKS, edit, want)
            crate_turns(f"{name} on {mode}", smi, crate)
    for n in PROBE_SIZES[:-1]:
        crate = Crate(dam_break_world(n), device="cuda")
        crate.run(GRAPH_SETTLE)
        crate_turns(f"perf_probe dam break, {crate.particle_count} particles, "
                    f"{crate.scene.forces_mode}", smi, crate)


def graphs_batched(smi: str) -> None:
    """(o3) BatchedCrates.run (replays of the captured vmapped tick, the
    running max of the overflow in a static buffer) == the eager loop of
    the vmapped step, on dense and chunked (VMAP_CRATES stirring_cup crates
    with coefficients of their own, emitters on); then run_datagen's 1024
    stirring_cup crates (dense) in timing turns."""
    import copy

    import torch

    from sand_crate_tpu_torch import Params, graphs, load_config_dict
    from sand_crate_tpu_torch.bench import STIRRING_CUP
    from sand_crate_tpu_torch.sweep import (DEFAULT_RANDOM_RANGES, BatchedCrates, batched_step,
                                            random_params)

    config = load_config_dict(copy.deepcopy(STIRRING_CUP))
    base = Params.from_coefficients(config.world_config.coefficients, "cuda")
    for mode in ("dense", "chunked"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(11)
        b = BatchedCrates(config, random_params(gen, base, DEFAULT_RANDOM_RANGES, VMAP_CRATES),
                          device="cuda", seed=11, forces_mode=mode)
        b.run(GRAPH_SETTLE)
        s0, p0, g0 = clone_state(b.state), clone_state(b.params), b.generator.get_state()
        live = b.live_rows(GRAPH_TICKS)
        reset_kernel_counts()
        reset(graphs.LAUNCHES)
        diag = b.run(GRAPH_TICKS)
        calls, launches = dict(graphs.LAUNCHES), kernel_counts()
        bounds = check_boundary(f"BatchedCrates on {mode}", boundary_want(GRAPH_TICKS, mode))
        b.generator.set_state(g0)
        st, want, worst = eager_loop(s0, p0, b.scene, b.generator, GRAPH_TICKS, live,
                                     batched=True)
        same_bits(f"BatchedCrates on {mode}", b.state, st)
        same_bits(f"BatchedCrates on {mode} (diagnostics)", diag,
                  want._replace(neighbor_overflow=worst))
        check(launches == pair_want(launches, mode, GRAPH_TICKS),
              f"BatchedCrates on {mode}: launches {launches} (its pair kernels once a pass a "
              f"replayed tick)")
        check(calls["replay"] >= GRAPH_TICKS - 1, f"BatchedCrates on {mode}: graph calls {calls}")
        print(f"  BatchedCrates on {mode}: {VMAP_CRATES} crates x {GRAPH_TICKS} ticks (sweep bound "
              f"{live}), replayed == the eager vmapped loop bit for bit, overflow max "
              f"{worst.tolist()}; graph calls {calls}; launches {bounds}")
    gen = torch.Generator(device="cuda")
    b = BatchedCrates(config, random_params(gen, base, DEFAULT_RANDOM_RANGES, DATAGEN_CRATES),
                      device="cuda", seed=3)
    b.run(DATAGEN_EVERY)
    held = [clone_state(b.state)]

    def graph_tick():
        b.graph.step(b.scene, b.generator)

    def eager_tick():
        held[0], _ = batched_step(held[0], b.params, b.scene, b.generator)

    turns(f"run_datagen's {DATAGEN_CRATES} stirring_cup crates on {b.scene.forces_mode}, "
          f"{int(b.particle_counts().sum())} particles", smi, graph_tick, eager_tick,
          GRAPH_BATCH_TURN_TICKS)


def graphs_resume_and_frames() -> None:
    """(o4) a checkpoint restored into a crate whose graph is already
    captured runs on (replayed) as the uninterrupted crate does and as the
    eager loop from the checkpoint does, bit for bit; (o5) stream_frames ==
    physics.trajectory == the eager loop's frames, on stirring_cup."""
    import copy

    import numpy as np
    import torch

    from sand_crate_tpu_torch import Crate, load_config_dict
    from sand_crate_tpu_torch.bench import STIRRING_CUP
    from sand_crate_tpu_torch.physics import step
    from sand_crate_tpu_torch.physics import trajectory as physics_trajectory
    from sand_crate_tpu_torch.recording import load_checkpoint

    world = load_config_dict(copy.deepcopy(STIRRING_CUP)).world_config
    with tempfile.TemporaryDirectory() as tmp:
        a = Crate(world, device="cuda", seed=2)
        a.run(CKPT_TICKS)
        path = a.save_checkpoint(Path(tmp) / "ckpt.npz")
        a.run(CKPT_TICKS)
        b = Crate(world, device="cuda", seed=9)
        b.run(3)  # its graph captured and replayed before the restore
        b.restore_checkpoint(path)
        b.run(CKPT_TICKS)
        same_bits("resumed under replay vs uninterrupted", b.state, a.state)
        st, _, gen_state = load_checkpoint(path, "cuda")
        gen = torch.Generator(device="cuda")
        gen.set_state(gen_state)
        st, _, _ = eager_loop(st, a.params, a.scene, gen, CKPT_TICKS)
        same_bits("resumed under replay vs the eager loop", b.state, st)
    print(f"  checkpoint at tick {CKPT_TICKS} restored into a crate with a captured graph: "
          f"{CKPT_TICKS} replayed ticks == the uninterrupted crate == the eager loop, bit for bit "
          f"({a.particle_count} particles)")

    streamed, traj, ref = (Crate(world, device="cuda", seed=4) for _ in range(3))
    frames = list(streamed.stream_frames(STREAM_FRAMES, ticks_per_frame=2, chunk_frames=4))
    final, want = physics_trajectory(traj.state, traj.params, traj.scene, STREAM_FRAMES,
                                     traj.generator, 2)
    state, eager = ref.state, {k: [] for k in want}
    for _ in range(STREAM_FRAMES):
        for _ in range(2):
            state, diag = step(state, ref.params, ref.scene, ref.generator)
        for k in want:
            eager[k].append((diag.force_dv if k == "force_dv" else getattr(state, k)).cpu())
    for key, value in want.items():
        e = torch.stack(eager[key]).numpy()
        check(np.array_equal(value.cpu().numpy(), e), f"trajectory != eager loop in {key}")
        check(np.array_equal(np.stack([f[key] for f in frames]), e),
              f"stream_frames != eager loop in {key}")
    same_bits("stream_frames' final state", streamed.state, state)
    same_bits("trajectory's final state", final, state)
    print(f"  stream_frames ({STREAM_FRAMES} frames of 2 ticks, chunks of 4) == "
          f"physics.trajectory == the eager loop's frames, bit for bit")


def graphs_phase(smi: str) -> None:
    """Phase (o)."""
    print(f"(o1) the 1M dam break, replayed against eager ({smi}):")
    graphs_1m(smi)
    print("(o2) single crates and perf_probe's smaller sizes:")
    graphs_small(smi)
    print("(o3) batched crates:")
    graphs_batched(smi)
    print("(o4, o5) checkpoint resume and stream_frames under replay:")
    graphs_resume_and_frames()


# --------------------------------------------------------------------------
# (p) the band step replayed: one CUDA graph a tick for every shard
# --------------------------------------------------------------------------


def eager_band_loop(band, split, params, edges, ticks: int):
    """The explicit eager band loop that the band graphs are held against:
    spatial.spatial_step over the group's shards (group.run), the shard
    states joined by a cat, on the step's own shard generators, mig_cap and
    bh_alloc; returns (state, last stats, edges)."""
    import torch

    from sand_crate_tpu_torch import spatial

    D, P = band.n_shards, band.scene.capacity
    stats = None
    for _ in range(ticks):
        outs = band.group.run(
            lambda comm, st: spatial.spatial_step(st, params, band.scene, comm, band.mig_cap,
                                                  band.generators[comm.rank], edges,
                                                  band.bh_alloc),
            [spatial.shard_slice(split, r, P) for r in range(D)])
        split = outs[0][0]._replace(**{k: torch.cat([getattr(o[0], k) for o in outs])
                                       for k in spatial.PARTICLE_LEAVES})
        stats = outs[0][1]
        if edges is not None:
            edges = stats["band_edges"]
    return split, stats, edges


def band_graph_cell(label, smi, group, world, settled, params, kw, rebalance, counters):
    """One cell of (p): the first call of a band step (eager, then the
    capture: its peak memory), GRAPH_TICKS replayed ticks == the eager band
    loop from the same state and shard generators bit for bit (state, every
    stat, every generator), then graph / eager / eager / graph turns of
    GRAPH_TURN_TICKS."""
    import torch

    from sand_crate_tpu_torch import graphs
    from sand_crate_tpu_torch.scene import build_scene
    from sand_crate_tpu_torch.spatial import initial_band_edges, make_spatial_step, split_state

    D = BAND_SHARDS
    scene = build_scene(world, device="cuda", **kw)
    band = make_spatial_step(group, scene, mig_cap=BAND_MIG_CAP, rebalance=rebalance)
    edges = initial_band_edges(settled, scene, D) if rebalance else None
    split = split_state(settled, scene, D, edges)
    args = (params,) if edges is None else (params, edges)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the pools of earlier cells' steps, freed
    torch.cuda.reset_peak_memory_stats()
    alloc0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    reset(graphs.LAUNCHES)
    split, stats = band(split, *args)
    torch.cuda.synchronize()
    check((graphs.LAUNCHES["replay"], graphs.LAUNCHES["capture"]) == (0, 1),
          f"(p) {label}: first call {graphs.LAUNCHES}")
    peak = (torch.cuda.max_memory_allocated() - alloc0) / 2**30
    torch.cuda.empty_cache()  # a graph's private pool stays reserved
    kept = (torch.cuda.memory_reserved() - reserved0) / 2**30
    edges = stats.get("band_edges")

    s0, e0 = split, edges
    g0 = [g.get_state() for g in band.generators.values()]
    reset_kernel_counts()
    reset(graphs.LAUNCHES)
    for _ in range(GRAPH_TICKS):
        split, stats = band(split, params) if edges is None else band(split, params, edges)
        edges = stats.get("band_edges")
    calls, launches = dict(graphs.LAUNCHES), kernel_counts()
    launches.update(check_boundary(f"(p) {label}", boundary_want(GRAPH_TICKS, "band", D)))
    g_replayed = [g.get_state() for g in band.generators.values()]
    for g, st in zip(band.generators.values(), g0):
        g.set_state(st)
    want, want_stats, _ = eager_band_loop(band, s0, params, e0, GRAPH_TICKS)
    same_bits(f"(p) {label}", split, want)
    for k, v in want_stats.items():
        check(torch.equal(stats[k], v), f"(p) {label}: replayed != eager in stats[{k!r}]")
    for g, st in zip(band.generators.values(), g_replayed):
        check(torch.equal(g.get_state(), st), f"(p) {label}: a shard generator advanced "
                                              "otherwise than eagerly")
    check(calls == {"replay": GRAPH_TICKS, "capture": 0, "evict": 0},
          f"(p) {label}: graph calls {calls}")
    want_launches = dict.fromkeys(launches, 0)
    want_launches.update({k: D * GRAPH_TICKS for k in counters})
    want_launches.update(boundary_want(GRAPH_TICKS, "band", D))
    check(launches == want_launches, f"(p) {label}: launches {launches} != {want_launches}")
    print(f"  (p) {label}: {int(stats['particle_count'])} particles; the first call (eager, "
          f"then the capture) peaks {peak:.3f} GiB above the {alloc0 / 2**30:.3f} GiB "
          f"allocated before it and keeps {kept:.3f} GiB reserved after it (the graph's pool, "
          f"the static buffers and the returned copies); {GRAPH_TICKS} replayed "
          f"ticks == the eager band loop bit for bit (state, stats, {D} shard generators); "
          f"graph calls {calls}; launches {({k: v for k, v in launches.items() if v})}")

    box = {"graph": (split, edges), "eager": (clone_state(split), edges)}

    def graph_tick():
        st, e = box["graph"]
        st, out = band(st, params) if e is None else band(st, params, e)
        box["graph"] = (st, out.get("band_edges"))

    def eager_tick():
        st, e = box["eager"]
        st, _, e = eager_band_loop(band, st, params, e, 1)
        box["eager"] = (st, e)

    turns(f"(p) 1M dam break in {D} bands, {label}", smi, graph_tick, eager_tick,
          GRAPH_TURN_TICKS)


def band_graphs(smi: str) -> None:
    """Phase (p): the 1M dam break of (m), settled SETTLE_TICKS ticks on
    p-major, in BAND_SHARDS bands on a LocalGroup of the card, each cell of
    BAND_GRAPH_CELLS (band_graph_cell)."""
    from sand_crate_tpu_torch import Crate
    from sand_crate_tpu_torch.collectives import LocalGroup

    world = dam_break_world(N_TARGET)
    base = Crate(world, device="cuda")
    base.run(SETTLE_TICKS)
    settled, params = clone_state(base.state), base.params
    print(f"(p) the band step as one replayed graph a tick on {smi}: the 1M dam break "
          f"({base.particle_count} particles) settled {SETTLE_TICKS} ticks, {BAND_SHARDS} "
          f"bands on a LocalGroup of the card, mig_cap {BAND_MIG_CAP}")
    del base
    group = LocalGroup(BAND_SHARDS, device="cuda")
    try:
        for label, (kw, rebalance, counters) in BAND_GRAPH_CELLS.items():
            band_graph_cell(label, smi, group, world, settled, params, kw, rebalance, counters)
    finally:
        group.close()



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
    for name in ("SAND_CRATE_PMSUB", "SAND_CRATE_PMAJOR_GATE"):
        check(name not in os.environ, f"{name} is set: the phases set the knobs themselves")

    from sand_crate_tpu_torch import Crate
    from sand_crate_tpu_torch.ops import cuda_build, pair_kernel, pmajor

    # -- 2. build (a) ------------------------------------------------------------
    with phase("build"):
        cuda_build.build("pmajor", "grid_pair", "probes", "boundary", "kick", "pair_batch",
                         "pm_prep")
        print("build: pmajor.cu (K1/K2, K10), grid_pair.cu (K3-K9), probes.cu (P1-P4), "
              "boundary.cu (B1, full and positions-only), kick.cu (B2, the velocity "
              "update), pair_batch.cu (D1, D2) and pm_prep.cu (the p-major pair glue), one "
              "nvcc each, in parallel")
        print_ptxas(("pmajor", "grid_pair", "probes", "boundary", "kick", "pair_batch",
                     "pm_prep"))

    # -- 3. world --------------------------------------------------------------
    with phase("world"):
        crate = Crate(dam_break_world(N_TARGET), device="cuda")
        n0 = crate.particle_count
        sc = crate.scene
        print(f"world: dam break, {n0} alive, capacity {sc.capacity}, grid "
              f"{sc.grid_nx}x{sc.grid_ny}")
        check(n0 == 1_001_700 and sc.capacity == 1_050_112, "1M world size")

    # -- 4. pmajor kernels against their plain versions -------------------------
    with phase("settle + K1/K2 vs plain"):
        crate.run(SETTLE_TICKS)
        print(f"settle: {SETTLE_TICKS} ticks")
        print("pmajor kernels vs plain versions (same device inputs):")
        rows = kernels_vs_plain(crate)
        print("pair glue kernels (csrc/pm_prep.cu) vs their plain chains:")
        prep_rows = pair_prep_rows(crate)
        print("K1/K2 vs plain versions on the hard inputs (ops/pmajor_cases.py):")
        hard_cases(crate.scene)

    # -- (b) K10 against its plain version and K1/K2 one-sided ------------------
    with phase("K10 vs plain"):
        print(f"K10 vs plain version and K1/K2 one-sided (same device inputs), main-path "
              f"chunk {pmajor.PMS_CHUNK}:")
        k10_rows = k10_vs_plain(crate)

    # -- (q) the boundary kernels against their plain versions ---------------------
    with phase("boundary kernels"):
        print("boundary kernels (csrc/boundary.cu, csrc/kick.cu) vs their plain versions at the "
              "settled 1M "
              "state, on the hard inputs (ops/boundary_cases.py) and vmapped:")
        b_rows = boundary_rows(crate, smi)

    # -- (q3) the per-kick functions of physics, one B2 launch each ---------------------
    with phase("per-kick functions"):
        apply_functions()

    # -- (h) P1 at the settled state: vs its plain version, then its main ---------
    with phase("P1 probe"):
        print("P1 (tools/pmajor_probe.py) vs its plain version at the settled 1M state:")
        probe_rows = p1_probe(crate)

    # -- 5. pmajor main path ------------------------------------------------------
    with phase("pmajor main path"):
        launches, rate, p50, wall = drive(
            crate, MAIN_TICKS, "pmajor main path", pmajor.LAUNCHES,
            {"a": MAIN_TICKS, "b": MAIN_TICKS, "sub_a": 0, "sub_b": 0, "prep": MAIN_TICKS,
             "slab_b": MAIN_TICKS})
        print(f"pmajor main path on {smi}: {n0} particles, {rate:.3f} steps/s "
              f"({wall / MAIN_TICKS * 1000:.3f} ms/step mean over {MAIN_TICKS} ticks, "
              f"host clock + synchronize; replayed graphs), eager loop step p50 {p50:.3f} ms (CUDA "
              f"events, {P50_TICKS} ticks)")
        for r in rows:
            r["launches"] = launches[r["name"][-1]]
        for r, key in zip(prep_rows, ("prep", "slab_b")):
            r["launches"] = launches[key]
        # the update a stage a launch and the clamp alone: the instrumented
        # tick's, phase (f)
        main_keys = {"ghost_pass": "boundary.ghost", "ghost_pos": "boundary.ghost_pos",
                     "velocity_update": "kick.velocity_update"}
        for r in b_rows:
            if r["name"] in main_keys:
                r["launches"] = launches[main_keys[r["name"]]]

    # -- (c) the PMSUB main path (K10) ---------------------------------------------
    with phase("PMSUB main path"), knob("SAND_CRATE_PMSUB"):
        # A fresh world over the same ticks as phase 5 (the rescaled dam
        # break grows runaways that leave the box later on).
        sub_crate = Crate(dam_break_world(N_TARGET), device="cuda")
        sub_crate.run(SETTLE_TICKS)
        launches, rate, p50, wall = drive(
            sub_crate, MAIN_TICKS, "PMSUB main path", pmajor.LAUNCHES,
            {"a": 0, "b": 0, "sub_a": MAIN_TICKS, "sub_b": MAIN_TICKS, "prep": MAIN_TICKS,
             "slab_b": MAIN_TICKS}, allow_culls=True)
        print(f"PMSUB main path on {smi}: {n0} particles, {rate:.3f} steps/s "
              f"({wall / MAIN_TICKS * 1000:.3f} ms/step mean over {MAIN_TICKS} ticks, "
              f"host clock + synchronize; replayed graphs), eager loop step p50 {p50:.3f} ms (CUDA "
              f"events, {P50_TICKS} ticks)")
        for r in k10_rows[:2]:
            r["launches"] = launches["sub_" + r["name"][-1]]
        del sub_crate

    # -- (d) the gate path -----------------------------------------------------------
    with phase("gate path"):
        gate_path(crate)

    # -- (f) the Collisions phase at 1M, per schedule --------------------------------
    with phase("instrumented ticks at 1M"):
        print(f"instrumented ticks at 1M on {smi} (fold off, spring on):")
        k10_rows[2]["launches"] = collisions_1m(crate)["sub_b"]
        staged = instrument_1m(crate, smi)
        # the instrumented tick's update: one launch a kick phase, the clamp's
        # counted as ccd, and one to integrate
        for r in b_rows:
            if r["name"] == "velocity_update_staged":
                r["launches"] = staged["kick.velocity_update_stage"] + staged["kick.ccd"]
            elif r["name"] == "continuous_collision":
                r["launches"] = staged["kick.ccd"]
        check(all(r["launches"] > 0 for r in b_rows),
              f"boundary rows launched no time on their paths: {b_rows}")
    del crate

    # -- (q2) queue 3's open check: the particles that leave the box, and how ----------
    with phase("escape check"):
        print(f"escape check: the 1M dam break of (n1), {ESCAPE_TICKS} ticks, each particle "
              "that leaves [-r, 1 + r] with its ghost-pass and CCD inputs:")
        escape_check(smi)

    # -- 6. pmajor trajectory: kernel path vs plain path, both on the card ------
    prep_swaps = [(pmajor, "pair_prep", pmajor.pair_prep_plain),
                  (pmajor, "pass_b_prep", pmajor.pass_b_prep_plain)]
    with phase("pmajor trajectory"):
        trajectory("pmajor trajectory", "pmajor", [(pmajor, "pm_pass", pmajor.pm_pass_plain),
                                                   *prep_swaps],
                   pmajor.LAUNCHES, {"a": TRAJ_TICKS, "b": TRAJ_TICKS, "sub_a": 0, "sub_b": 0,
                                     "prep": TRAJ_TICKS, "slab_b": TRAJ_TICKS})
    with phase("PMSUB trajectory"), knob("SAND_CRATE_PMSUB"):
        trajectory("PMSUB trajectory", "pmajor",
                   [(pmajor, "pms_pass", pmajor.pms_pass_plain), *prep_swaps], pmajor.LAUNCHES,
                   {"a": 0, "b": 0, "sub_a": TRAJ_TICKS, "sub_b": TRAJ_TICKS,
                    "prep": TRAJ_TICKS, "slab_b": TRAJ_TICKS})

    # -- 7. grid kernels against their plain versions ---------------------------
    with phase("grid settle + kernels vs plain"):
        grid_crate = Crate(dam_break_world(N_TARGET), device="cuda", forces_mode="pallas",
                           cell_capacity=GRID_SLOTS)
        check(grid_crate.particle_count == n0, "1M world size (grid)")
        grid_crate.run(GRID_SETTLE_TICKS)
        print(f"grid settle: {GRID_SETTLE_TICKS} ticks")
        print("grid kernels vs plain versions (same device inputs):")
        grid_rows, sorted_ops = grid_kernels_vs_plain(grid_crate)
        print("slab-order grid kernels vs plain versions on the hard inputs (ops/grid_cases.py):")
        grid_hard_cases(grid_crate.scene)
        provider = grid_provider_path(grid_crate, sorted_ops)
        del sorted_ops

    # -- (h) P2 at the settled grid: vs its plain version, then its main ----------
    with phase("P2 probe"):
        print("P2 (tools/passa_probe.py) variants vs their plain versions at the settled 1M grid:")
        probe_rows += p2_probe(grid_crate)

    # -- 8. grid main path -------------------------------------------------------
    with phase("grid main path"):
        launches, rate, p50, wall = drive(
            grid_crate, GRID_TICKS, "grid main path", pair_kernel.LAUNCHES,
            {"place_grid": 0, "pair_pass_a": GRID_TICKS, "pair_pass_b_grid": 0,
             "pair_pass_b_emit": GRID_TICKS},
            overflow_ref=over_capacity(grid_crate, GRID_SLOTS),
        )
        print(f"grid main path on {smi}: {n0} particles, {rate:.3f} steps/s "
              f"({wall / GRID_TICKS * 1000:.3f} ms/step mean over {GRID_TICKS} ticks, "
              f"host clock + synchronize; replayed graphs), eager loop step p50 {p50:.3f} ms (CUDA "
              f"events, {P50_TICKS} ticks)")
        for r in grid_rows:  # placement and grid-mode pass B run on the provider path
            on_tick = r["name"] in ("pair_pass_a", "pair_pass_b_emit")
            r["launches"] = (launches if on_tick else provider)[r["name"]]
        tick_memory(grid_crate)
        del grid_crate

    # -- 9. grid trajectory --------------------------------------------------------
    with phase("grid trajectory"):
        trajectory("grid trajectory", "pallas", [
            (pair_kernel, "pair_pass_a", pair_kernel.pair_pass_a_slab_plain),
            (pair_kernel, "pair_pass_b_emit", pair_kernel.pair_pass_b_emit_plain),
        ], pair_kernel.LAUNCHES, {"place_grid": 0, "pair_pass_a": TRAJ_TICKS,
                                  "pair_pass_b_grid": 0, "pair_pass_b_emit": TRAJ_TICKS})

    # -- (e) the bench entry, (f) the instrumented Crate, (g) stream_frames ------
    with phase("bench entry"):
        bench_entry()
    with phase("instrument 10k"):
        instrument_10k(smi)
    with phase("stream_frames 10k"):
        stream_10k()

    # -- (h) P4 and P3: vs their plain versions, then their mains ----------------
    with phase("P4 and P3 probes"):
        print(f"P4 (tools/bf16_probe.py) and P3 (tools/hybrid_probe.py) vs their plain "
              f"versions, iters {PROBE_ITERS}:")
        probe_rows = p4_p3_probes() + probe_rows
    with phase("probe hard cases"):
        print("P1-P4 vs their plain versions on the hard inputs (probes/probe_cases.py):")
        probe_hard_cases()

    # -- (r) the batched pair kernels against their plain versions ----------------
    with phase("batched pair kernels"):
        pair_rows = pair_batch_rows(smi)
    with phase("dense and chunked trajectories"):
        from sand_crate_tpu_torch import cellwise
        from sand_crate_tpu_torch.ops import chunked, pair_batch

        none = dict.fromkeys(pair_batch.LAUNCHES, 0)
        trajectory("dense trajectory", "dense",
                   [(pair_batch, "neighbor_forces_dense", cellwise.neighbor_forces_dense)],
                   pair_batch.LAUNCHES, {**none, "dense_order": TRAJ_TICKS,
                                         "dense_a": TRAJ_TICKS, "dense_b": TRAJ_TICKS},
                   TRAJ_SMALL_PARTICLES)
        trajectory("chunked trajectory", "chunked",
                   [(pair_batch, "window_pass", chunked._pass_scan_plain)], pair_batch.LAUNCHES,
                   {**none, "window_a": TRAJ_TICKS, "window_b": TRAJ_TICKS},
                   TRAJ_SMALL_PARTICLES)

    with tempfile.TemporaryDirectory() as tmp:
        traj_dir = Path(tmp) / "trajectory"
        # -- (i) recording and checkpoints ---------------------------------------
        with phase("recording + checkpoints"):
            recording_and_checkpoints(traj_dir)

        # -- (j) batched crates, the dense and chunked backends --------------------
        with phase("batched crates"):
            print(f"batched crates and the small- and mid-crate backends on {smi}:")
            batch_launches = batched_crates(smi)
            for r in pair_rows:  # D1 on (c)'s dense run, D2 on (d)'s chunked run
                r["launches"] = batch_launches["dense" if r["name"].startswith("dense")
                                               else "chunked"]["pairs." + r["name"]]
            check(all(r["launches"] > 0 for r in pair_rows),
                  f"a pair kernel launched no time on its batched path: {pair_rows}")

        # -- (s) batched crates on every backend: the crate-axis kernels ----------
        with phase("crate-axis hard cases"):
            print("(s0) K1/K2, K10, K4+K5 and K8+K9 with a crate axis on the batched hard "
                  "inputs:")
            crate_axis_cases()
        with phase("batched backends, wave_machine"):
            print(f"(s1) {WAVE_CRATES} wave_machine crates on every backend of BatchedCrates:")
            axis_rows = wave_backends(smi)
            check(all(r["launches"] > 0 for r in axis_rows),
                  f"a crate-axis kernel launched no time on its batched path: {axis_rows}")
        with phase("batched backends, 100k dam break"):
            print(f"(s2) {BIG_CRATES} dam breaks of {BIG_PARTICLES} target particles:")
            big_batches(smi)
        with phase("batched datagen, pmajor and pallas"):
            print(f"(s3) run_datagen of {WAVE_CRATES} wave_machine crates:")
            wave_datagen(smi)

        # -- (k) the command line's main path, rendering, replay, gather, cellwise --
        with phase("CLI main path"):
            cli_path(smi, traj_dir.parent)

    # -- (l) the runaway check: p-major, pallas and cellwise from one state ---------
    with phase("runaway check"):
        runaway_check(smi)

    # -- (m) spatial bands: pmajor and pallas at 1M, the small legs, the entries ----
    with phase("spatial bands"):
        band_launches = spatial_bands(smi)
        for r in rows + grid_rows + prep_rows:
            if r["name"] in band_launches:
                r["band_launches"] = band_launches[r["name"]]

    # -- (n) the engine tools: soaks, probes, occupancy, the band tools ----------------
    with phase("engine tools"):
        tool_launches = engine_tools(smi)
        for r in rows:
            r["tools_launches"] = tool_launches["pmajor." + r["name"][-1]]
        for r, key in zip(prep_rows, PREP_KEYS):
            r["tools_launches"] = tool_launches[key]
        for r in grid_rows:
            r["tools_launches"] = tool_launches["grid." + r["name"]]
        for r in pair_rows:  # (n2)'s dense wave_machine soak, (n7) and (n8) on chunked
            r["tools_launches"] = tool_launches["pairs." + r["name"]]

    # -- (o) the compiled step loop: replayed graphs against the eager loop ------------
    with phase("graphs"):
        graphs_phase(smi)

    # -- (p) the band step replayed: one graph a tick for every shard ------------------
    with phase("band graphs"):
        band_graphs(smi)

    print(json.dumps({"kernels": rows + prep_rows + k10_rows + grid_rows + probe_rows + b_rows
                      + pair_rows + axis_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
