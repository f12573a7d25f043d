"""Command-line interface (the counterpart of ``sand_crate_tpu/cli.py``).

The reference exposes ``main(config_file_path, play_recording=None)`` via
fire (main.py:19,40) and hardcodes a 48-variant sequential coefficient sweep
(main.py:10-16,26-36).  Here the same surface is argparse-based, with the
JAX package's subcommands and flags, and the sweep can run as one vmapped
batch (sweep.py):

    python -m sand_crate_tpu_torch run configs/dam_break.yaml --headless --no-record
    python -m sand_crate_tpu_torch replay data/recordings/<stamp>
    python -m sand_crate_tpu_torch sweep configs/stirring_cup.yaml --vmapped --ticks 400
    python -m sand_crate_tpu_torch datagen configs/stirring_cup.yaml --crates 1024
    python -m sand_crate_tpu_torch bench --particles 100000

Every command that steps a crate runs on the card unless ``--device cpu``
asks for the CPU; without a card it raises.  A scene file is YAML (read
without PyYAML where it is missing) or JSON (config.load_config).  :func:`main` returns what the command
returns (``run``: its Playback; ``replay``: the frames).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .config import load_config

# The reference's hardcoded sweep grid (main.py:10-16), kept as the default.
DEFAULT_SWEEP_OPTIONS = {
    "pressure_amplifier": [20, 40],
    "ignored_pressure": [0.3, 0.1],
    "viscosity": [4, 8],
    "surface_smoothing": [40, 100],
    "target_pressure": [-5, -2, 2],
}


def config_options(options: dict, config):
    """Cartesian-product config variants (main.py:26-36), isolated copies."""
    import copy
    import itertools

    keys = list(options.keys())
    for values in itertools.product(*(options[k] for k in keys)):
        variant = copy.deepcopy(config)
        for k, v in zip(keys, values):
            variant.world_config.coefficients[k] = v
        yield variant


def cmd_run(args):
    from .playback import Playback

    config = load_config(args.config)
    if args.ticks:
        config.playback_config.ticks_to_record = args.ticks
    if args.output:
        # an explicit output dir implies recording, whatever the scene says
        config.playback_config.save_recording = True
    if args.no_record:
        config.playback_config.save_recording = False
    playback = Playback(
        config,
        recording_dir_path=Path(args.output) if args.output else None,
        headless=args.headless,
        crate_kwargs=dict(device=args.device, instrument=args.instrument),
        show_indices=args.show_indices,
    )
    if args.resume:
        playback.crate.restore_checkpoint(args.resume)
        print(f"resumed from {args.resume} at tick {playback.crate.tick}")
    playback.run_live_simulation(ticks_per_frame=args.ticks_per_frame)
    return playback


def cmd_replay(args):
    from .playback import replay

    return replay(Path(args.recording), headless=args.headless)


def cmd_sweep(args):
    if args.vmapped:
        from .sweep import run_vmapped_sweep

        return run_vmapped_sweep(
            load_config(args.config),
            DEFAULT_SWEEP_OPTIONS,
            ticks=args.ticks or 400,
            device=args.device,
        )
    from .playback import Playback

    config = load_config(args.config)
    for i, variant in enumerate(config_options(DEFAULT_SWEEP_OPTIONS, config)):
        print(f"--- sweep variant {i} ---")
        if args.ticks:
            variant.playback_config.ticks_to_record = args.ticks
        Playback(variant, headless=args.headless,
                 crate_kwargs=dict(device=args.device)).run_live_simulation()


def cmd_datagen(args):
    from .sweep import run_datagen

    return run_datagen(
        load_config(args.config),
        n_crates=args.crates,
        ticks=args.ticks,
        sample_every=args.sample_every,
        out_dir=args.out,
        seed=args.seed,
        device=args.device,
    )


def cmd_bench(args):
    from .bench import main as bench_main

    return bench_main(particles=args.particles, ticks=args.ticks or 100, device=args.device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sand_crate_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    # Where the crates run: the card unless the caller asks for the CPU.
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="torch device of the crates (default cuda; cpu for the CPU)")

    run = sub.add_parser("run", parents=[device], help="run a scene live")
    run.add_argument("config")
    run.add_argument("--headless", action="store_true")
    run.add_argument("--ticks", type=int)
    run.add_argument("--output")
    run.add_argument("--no-record", action="store_true")
    run.add_argument(
        "--resume", help="checkpoint.npz from a previous recording to resume from"
    )
    run.add_argument(
        "--ticks-per-frame",
        type=int,
        default=1,
        help="headless: physics ticks per recorded frame (device-resident chunks)",
    )
    run.add_argument(
        "--instrument",
        action="store_true",
        help="per-phase timing overlay: run the tick as phase-split programs",
    )
    run.add_argument(
        "--show-indices",
        action="store_true",
        help="draw per-particle/segment index labels (reference playback.py:187-206)",
    )
    run.set_defaults(fn=cmd_run)

    rep = sub.add_parser("replay", help="replay a recording")
    rep.add_argument("recording")
    rep.add_argument("--headless", action="store_true")
    rep.set_defaults(fn=cmd_replay)

    sw = sub.add_parser("sweep", parents=[device], help="coefficient grid sweep")
    sw.add_argument("config")
    sw.add_argument("--headless", action="store_true")
    sw.add_argument("--ticks", type=int)
    sw.add_argument("--vmapped", action="store_true", help="all variants in parallel on device")
    sw.set_defaults(fn=cmd_sweep)

    dg = sub.add_parser("datagen", parents=[device],
                        help="batched randomized-crate data generation")
    dg.add_argument("config")
    dg.add_argument("--crates", type=int, default=1024)
    dg.add_argument("--ticks", type=int, default=600)
    dg.add_argument("--sample-every", type=int, default=20)
    dg.add_argument("--out", default="data/datagen")
    dg.add_argument("--seed", type=int, default=0)
    dg.set_defaults(fn=cmd_datagen)

    be = sub.add_parser("bench", parents=[device], help="throughput benchmark")
    be.add_argument("--particles", type=int, default=100_000)
    be.add_argument("--ticks", type=int)
    be.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
