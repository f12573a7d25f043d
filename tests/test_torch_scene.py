"""The port's config, scene and initial state against the JAX package's.

Every shipped config builds the same Scene and initial CrateState in both
packages (``forces_mode="pmajor"`` on both sides), the ``*_from_numpy``
converters carry the JAX pytrees into the port and back unchanged, and the
port imports neither JAX nor the JAX package nor PyYAML.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sand_crate_tpu import load_config as jax_load_config
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.scene import init_state as jax_init_state
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch import load_config, load_config_dict
from sand_crate_tpu_torch.scene import build_scene, init_state
from sand_crate_tpu_torch.state import (
    Params,
    params_from_numpy,
    scene_from_numpy,
    state_from_numpy,
    to_numpy,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sand_crate_tpu_torch"
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))
# JAX Scene fields that tune TPU tactics the port does not have.
TPU_ONLY = {"row_block", "pmajor_w", "pmajor_cs", "pmajor_split"}


def _jax_fields(tree):
    if dataclasses.is_dataclass(tree):
        items = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    else:
        items = tree._asdict()
    items.pop("key", None)  # the JAX PRNG key: the port holds a torch.Generator
    return {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in items.items()}


def test_five_configs_ship():
    assert len(CONFIGS) == 5, CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_scene_and_initial_state_match_jax(name):
    jworld = jax_load_config(REPO / "configs" / name).world_config
    tworld = load_config(REPO / "configs" / name).world_config
    jscene = jax_build_scene(jworld, forces_mode="pmajor")
    tscene = build_scene(tworld, forces_mode="pmajor", device="cpu")
    jf, tf = _jax_fields(jscene), to_numpy(tscene)
    assert set(jf) - set(tf) == TPU_ONLY
    assert set(tf) <= set(jf)
    for k, v in tf.items():
        if k == "motor_exprs":
            assert [(b, c, e.src) for b, c, e in v] == [(b, c, e.src) for b, c, e in jf[k]]
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, jf[k], err_msg=k)
        else:
            assert v == jf[k], k

    jstate = _jax_fields(jax_init_state(jworld, jscene, seed=3))
    tstate = to_numpy(init_state(tworld, tscene, seed=3))
    assert set(jstate) == set(tstate)
    for k, v in tstate.items():
        np.testing.assert_array_equal(v, jstate[k], err_msg=k)
        assert v.dtype == jstate[k].dtype, k

    jparams = _jax_fields(JaxParams.from_coefficients(jworld.coefficients))
    tparams = to_numpy(Params.from_coefficients(tworld.coefficients, "cpu"))
    for k, v in tparams.items():
        np.testing.assert_array_equal(v, jparams[k], err_msg=k)
        assert v.dtype == jparams[k].dtype, k


@pytest.mark.parametrize("name", ["stirring_cup.yaml", "dam_break.yaml"])
def test_from_numpy_round_trip(name):
    """JAX pytrees -> port (leaf by leaf) -> numpy: unchanged."""
    jworld = jax_load_config(REPO / "configs" / name).world_config
    jscene = jax_build_scene(jworld, forces_mode="pmajor", capacity=256)
    jstate = _jax_fields(jax_init_state(jworld, jscene, seed=1))
    jparams = _jax_fields(JaxParams.from_coefficients(jworld.coefficients))
    jscene_f = _jax_fields(jscene)
    for conv, src in (
        (state_from_numpy, jstate),
        (params_from_numpy, jparams),
        (scene_from_numpy, jscene_f),
    ):
        back = to_numpy(conv(src, device="cpu"))
        for k, v in back.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, src[k], err_msg=k)
            else:
                assert v == src[k], k


def test_forces_modes():
    world = load_config(REPO / "configs" / "stirring_cup.yaml").world_config
    assert build_scene(world, device="cpu").forces_mode == "dense"  # "auto" at capacity 640
    scene = build_scene(world, forces_mode="pmajor", enable_spring=True, device="cpu")
    assert (scene.fold_pairs, scene.pmajor_symm) == (False, True)
    for mode in ("dense", "chunked", "gather", "cellwise"):
        scene = build_scene(world, forces_mode=mode, device="cpu")
        assert (scene.forces_mode, scene.fold_pairs, scene.pmajor_symm) == (mode, False, False)
    assert build_scene(world, forces_mode="gather", max_neighbors=7,
                       device="cpu").max_neighbors == 7
    with pytest.raises(ValueError, match="unknown forces_mode"):
        build_scene(world, forces_mode="sparse", device="cpu")
    # The slot-grid backend resolves its options as the JAX build_scene does.
    jworld = jax_load_config(REPO / "configs" / "stirring_cup.yaml").world_config
    for kw in ({}, {"cell_capacity": 8}, {"enable_spring": True}):
        got = build_scene(world, forces_mode="pallas", device="cpu", **kw)
        ref = jax_build_scene(jworld, forces_mode="pallas", **kw)
        for name in ("forces_mode", "cell_capacity", "fold_pairs", "pmajor_symm", "enable_spring"):
            assert getattr(got, name) == getattr(ref, name), (kw, name)


def test_chip_smoke_dam_break_equals_yaml():
    """The one copy of the dam-break world that chip_smoke.py and the bench
    entry use (sand_crate_tpu_torch.bench.DAM_BREAK) equals the YAML."""
    from sand_crate_tpu_torch import bench

    raw = yaml.safe_load((REPO / "configs" / "dam_break.yaml").read_text())
    assert bench.DAM_BREAK == raw
    # The dict parses to the same world as the file.
    a = load_config_dict(bench.DAM_BREAK).world_config
    b = load_config(REPO / "configs" / "dam_break.yaml").world_config
    assert a == b
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert not hasattr(chip_smoke, "DAM_BREAK")  # no second copy


def test_stirring_cup_dict_equals_yaml():
    """The stirring-cup world of the card (bench.STIRRING_CUP, for machines
    without PyYAML) equals configs/stirring_cup.yaml."""
    from sand_crate_tpu_torch import bench

    raw = yaml.safe_load((REPO / "configs" / "stirring_cup.yaml").read_text())
    assert bench.STIRRING_CUP == raw
    a = load_config_dict(bench.STIRRING_CUP).world_config
    b = load_config(REPO / "configs" / "stirring_cup.yaml").world_config
    assert a == b


def test_wave_machine_dict_equals_yaml():
    """The wave-machine world of the card (bench.WAVE_MACHINE, chip_smoke's
    mid-size crate) equals configs/wave_machine.yaml."""
    from sand_crate_tpu_torch import bench

    raw = yaml.safe_load((REPO / "configs" / "wave_machine.yaml").read_text())
    assert bench.WAVE_MACHINE == raw
    a = load_config_dict(bench.WAVE_MACHINE).world_config
    b = load_config(REPO / "configs" / "wave_machine.yaml").world_config
    assert a == b


def test_functional_entry_defaults_to_the_card():
    """build_scene and Params.from_coefficients, the functional entry beside
    Crate, run on the card unless the caller asks for the CPU: with no device
    they land on CUDA, and without a card they raise instead of falling back."""
    world = load_config(REPO / "configs" / "stirring_cup.yaml").world_config
    if torch.cuda.is_available():
        assert build_scene(world).segments0.device.type == "cuda"
        assert Params.from_coefficients(world.coefficients).dt.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="build_scene runs on the CUDA device.*device='cpu'"):
            build_scene(world)
        with pytest.raises(RuntimeError, match="from_coefficients runs on the CUDA.*device='cpu'"):
            Params.from_coefficients(world.coefficients)
    assert build_scene(world, device="cpu").segments0.device.type == "cpu"
    assert Params.from_coefficients(world.coefficients, "cpu").dt.device.type == "cpu"


def test_carry_over_defaults_to_the_card():
    """params_from_numpy, scene_from_numpy and state_from_numpy, which carry
    the JAX package's pytrees into the port, run on the card unless the
    caller asks for the CPU: with no device they land on CUDA, and without a
    card they raise instead of falling back."""
    jworld = jax_load_config(REPO / "configs" / "stirring_cup.yaml").world_config
    jscene = jax_build_scene(jworld, forces_mode="pmajor", capacity=256)
    leaves = (
        (state_from_numpy, _jax_fields(jax_init_state(jworld, jscene, seed=1)), "pos"),
        (params_from_numpy, _jax_fields(JaxParams.from_coefficients(jworld.coefficients)), "dt"),
        (scene_from_numpy, _jax_fields(jscene), "segments0"),
    )
    for conv, src, field in leaves:
        if torch.cuda.is_available():
            assert getattr(conv(src), field).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError,
                               match=f"{conv.__name__} runs on the CUDA device.*device='cpu'"):
                conv(src)
        assert getattr(conv(src, device="cpu"), field).device.type == "cpu"

def test_port_imports_no_jax_nor_yaml():
    """Importing every module of the port, and chip_smoke, loads neither JAX
    nor the JAX package, nor the modules that a GPU host may lack
    (PyYAML, pygame, cv2, PIL, tqdm): those are imported inside the
    functions that use them."""
    modules = sorted(
        "sand_crate_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if "_build" not in p.parts
    )
    modules = [m.removesuffix(".__init__") for m in modules]
    for name in ("cli", "__main__", "playback", "render", "native", "neighbors", "cellwise",
                 "sweep", "ops.chunked", "utils.pygame_draw", "collectives", "spatial",
                 "parallel", "entry", "yaml_subset", "tools.soak", "tools.perf_probe",
                 "tools.occupancy_stats", "tools.small_n_probe", "tools.chunked_sweep",
                 "tools.spatial_balance", "tools.rebalance_midscale"):
        assert f"sand_crate_tpu_torch.{name}" in modules, name
    # Only modules that the imports below add count (an interpreter start-up
    # hook, or torch itself, may have loaded others before).
    code = (
        "import sys, importlib\n"
        "import numpy, torch\n"
        "before = set(sys.modules)\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sand_crate_tpu', 'tools', 'yaml', 'pygame', 'cv2', 'PIL', 'tqdm')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr
