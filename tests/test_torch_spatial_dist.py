"""The band step on ``DistGroup`` (torch.distributed, gloo, one process a
shard) against ``LocalGroup`` (one thread a shard), on the CPU.

Two and four processes (``torch.multiprocessing`` spawn, TCP rendezvous
on localhost), each running its own shard of the same split state for
TICKS ticks: cellwise with the stirring cup's emitter (spawn budget psum,
per-shard draws), pmajor and rebalanced pmajor on the block of
tests/test_spatial.py's setup with the collider noise on.  Every
collective moves data or int32 counts and each shard draws from the same
``shard_generator`` in both groups, so the shards' states and the stats
must be equal bit for bit.  The spawn is joined with a deadline, so a hang
fails the test.
"""

import socket
import tempfile
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import yaml

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TICKS = 3
MODES = ("cellwise", "pmajor", "pmajor-rebalance")
DEADLINE = 240.0


def _case(mode):
    """(scene, initial state, params) of one mode, on the CPU."""
    from sand_crate_tpu_torch import load_config_dict
    from sand_crate_tpu_torch.config import InitialParticlesConfig
    from sand_crate_tpu_torch.scene import build_scene, init_state
    from sand_crate_tpu_torch.state import Params

    w = load_config_dict(yaml.safe_load((REPO / "configs/stirring_cup.yaml").read_text()))
    w = w.world_config
    w.coefficients = dict(w.coefficients)
    if mode == "cellwise":
        w.coefficients["max_particles"] = 120
        scene = build_scene(w, capacity=256, forces_mode="cellwise", cell_capacity=4,
                            device="cpu")
    else:
        w.coefficients["max_particles"] = 256
        w.particle_sources = []
        w.initial_particles = [InitialParticlesConfig(x0=0.30, y0=0.15, x1=0.70, y1=0.75,
                                                      spacing=0.018, jitter=0.0)]
        scene = build_scene(w, capacity=1024, forces_mode="pmajor", device="cpu")
    return scene, init_state(w, scene, seed=0), Params.from_coefficients(w.coefficients, "cpu")


def _run(group, mode, shard=None):
    """TICKS band ticks of ``mode``; ``shard`` picks one shard's slice of the
    split state (DistGroup), None keeps all of it (LocalGroup).  Returns
    (state, stats of every tick)."""
    from sand_crate_tpu_torch.spatial import (
        initial_band_edges,
        make_spatial_step,
        shard_slice,
        split_state,
    )

    scene, state0, params = _case(mode)
    rebalance = mode.endswith("rebalance")
    edges = initial_band_edges(state0, scene, group.size) if rebalance else None
    state = split_state(state0, scene, group.size, edges)
    if shard is not None:
        state = shard_slice(state, shard, scene.capacity)
    step = make_spatial_step(group, scene, rebalance=rebalance, seed=5)
    history = []
    for _ in range(TICKS):
        state, stats = step(state, params, edges) if rebalance else step(state, params)
        edges = stats.get("band_edges")
        history.append({k: v.clone() for k, v in stats.items()})
    return state, history


def _worker(rank, world, port, out_dir):
    from sand_crate_tpu_torch.collectives import DistGroup

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        group = DistGroup(device="cpu")
        for mode in MODES:
            state, history = _run(group, mode, shard=rank)
            torch.save({"state": state._asdict(), "stats": history},
                       Path(out_dir) / f"{mode}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, out_dir):
    ctx = mp.spawn(_worker, args=(world, _free_port(), out_dir), nprocs=world, join=False)
    end = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"{world} gloo processes did not finish in {DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


@pytest.fixture(scope="module", params=[2, 4], ids=["2 processes", "4 processes"])
def dist_runs(request):
    """Each mode's shards from the gloo processes and its LocalGroup run."""
    from sand_crate_tpu_torch.collectives import LocalGroup

    world = request.param
    with tempfile.TemporaryDirectory() as tmp:
        _spawn(world, tmp)
        got = {mode: [torch.load(Path(tmp) / f"{mode}_{r}.pt") for r in range(world)]
               for mode in MODES}
    group = LocalGroup(world, device="cpu")
    try:
        ref = {mode: _run(group, mode) for mode in MODES}
    finally:
        group.close()
    return world, got, ref


@pytest.mark.parametrize("mode", MODES)
def test_dist_group_equals_local_group(dist_runs, mode):
    world, got, ref = dist_runs
    state, history = ref[mode]
    cap = state.pos.shape[0] // world
    for rank, shard in enumerate(got[mode]):
        part = slice(rank * cap, (rank + 1) * cap)
        for k in ("pos", "vel", "alive", "pressure", "uid"):
            assert torch.equal(shard["state"][k], getattr(state, k)[part]), (rank, k)
        for k in ("segments", "body_lin_vel", "body_ang_vel", "time", "tick"):
            assert torch.equal(shard["state"][k], getattr(state, k)), (rank, k)
        for t, (g, r) in enumerate(zip(shard["stats"], history)):
            assert g.keys() == r.keys()
            for k in r:
                assert torch.equal(g[k], r[k]), (rank, t, k)
    assert int(history[-1]["particle_count"]) > 0  # cellwise: the emitter ran


def test_dist_group_refuses_the_wrong_device(tmp_path):
    """Under gloo a CUDA device is refused, and so is a tensor that is not
    on the CPU; an uninitialised process has no DistGroup."""
    from sand_crate_tpu_torch.collectives import DistGroup

    with pytest.raises(RuntimeError, match="init_process_group"):
        DistGroup(device="cpu")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        with pytest.raises((ValueError, RuntimeError)):
            DistGroup(device="cuda")
        group = DistGroup(device="cpu")
        assert group.psum(torch.tensor(3)).item() == 3
        assert group.all_gather(torch.tensor([1, 2])).tolist() == [[1, 2]]
        assert [t.tolist() for t in group.exchange([torch.tensor([1])], [torch.tensor([2])])[0]] \
            == [[1]]
        with pytest.raises(ValueError, match="expected cpu"):
            group.psum(torch.tensor(1, device="meta"))
    finally:
        dist.destroy_process_group()
