"""sand_crate_tpu_torch: the PyTorch / CUDA port of sand_crate_tpu.

The same 2D particle-liquid simulator as the JAX package beside it — a pure
step over fixed-capacity particle tensors with a cell-sorted state — running
on an NVIDIA Hopper GPU, with the pair passes of its two large-crate
backends as hand-written CUDA kernels (``csrc/pmajor.cu`` for "pmajor",
per-self K1/K2 or, under ``SAND_CRATE_PMSUB=1``, the chunk-window K10;
``csrc/grid_pair.cu`` for the slot-grid "pallas" mode), and the other
backends in plain torch: "dense" and "chunked", which vmap over a crate
axis (``sweep.py``: batched crates, sweeps, datagen), the cell grid
"cellwise" and the fixed-K neighbor lists "gather".  Around the step:
``Crate``, playback, rendering (a C rasterizer, ``native/``), recording and
the command line, ``python -m sand_crate_tpu_torch run|replay|sweep|datagen|
bench``.  It imports neither JAX nor ``sand_crate_tpu``.  On CPU tensors
every kernel runs as its plain torch version.
"""

from .config import COEFFICIENT_NAMES, Config, load_config, load_config_dict
from .engine import Crate, crate_from_config
from .physics import rollout, step, trajectory
from .scene import build_all, build_scene, init_state
from .state import FORCE_LABELS, CrateState, Diagnostics, Params, Scene

__version__ = "0.1.0"

__all__ = [
    "Config",
    "Crate",
    "CrateState",
    "Diagnostics",
    "FORCE_LABELS",
    "COEFFICIENT_NAMES",
    "Params",
    "Scene",
    "build_all",
    "build_scene",
    "crate_from_config",
    "init_state",
    "load_config",
    "load_config_dict",
    "rollout",
    "step",
    "trajectory",
]
