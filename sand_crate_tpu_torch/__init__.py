"""sand_crate_tpu_torch: the PyTorch / CUDA port of sand_crate_tpu.

The same 2D particle-liquid simulator as the JAX package beside it — a pure
step over fixed-capacity particle tensors with a cell-sorted state — running
on an NVIDIA Hopper GPU, with the pair passes of its two backends as
hand-written CUDA kernels (``csrc/pmajor.cu`` for "pmajor", per-self K1/K2
or, under ``SAND_CRATE_PMSUB=1``, the chunk-window K10;
``csrc/grid_pair.cu`` for the slot-grid "pallas" mode), and the small- and
mid-crate backends "dense" and "chunked" in plain torch, which vmap over a
crate axis (``sweep.py``: batched crates, sweeps, datagen).  It imports
neither JAX nor ``sand_crate_tpu``.  On CPU tensors every kernel runs as its plain
torch version.  ``python -m sand_crate_tpu_torch.bench`` is its headline
benchmark.
"""

from .config import COEFFICIENT_NAMES, Config, load_config, load_config_dict
from .engine import Crate
from .physics import rollout, step
from .scene import build_scene, init_state
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
    "build_scene",
    "init_state",
    "load_config",
    "load_config_dict",
    "rollout",
    "step",
]
