"""Scene/playback configuration for the PyTorch port (framework-free).

The same schema and parser as ``sand_crate_tpu/config.py``.  YAML text is read
and written with PyYAML where it is installed and otherwise with
``yaml_subset`` (the YAML of the scene files), so no host needs PyYAML.

Loads the reference YAML schema verbatim (see config/*.yaml and
load_config.py:29-46) and extends it:

* Motored-body ``velocity_func`` / ``angular_velocity_func`` lambda strings are
  parsed without ``eval`` (the reference evals arbitrary YAML strings at
  rigid_body.py:81-83).  The two shipped forms
  ``lambda t: np.cos(t * F) * A`` are recognized as live-editable declarative
  motors (plus sin/constant variants); any other lambda falls back to
  :class:`ExprMotor`, a whitelisted-AST interpreter that evaluates the
  expression on tensors inside the step.  New configs may instead provide a
  declarative motor spec::

      angular_velocity: {amplitude: 1.4, frequency: 5.0, phase: 0.0, offset: 0.0}

  meaning ``offset + amplitude * cos(frequency * t + phase)``.

* An optional ``world.initial_particles`` list seeds particles at t=0 in bulk
  (used by the large dam-break benchmark scene), something the reference can
  only do slowly through emitters::

      initial_particles:
        - block: {x0: 0.1, y0: 0.1, x1: 0.5, y1: 0.9, spacing: 0.01,
                  velocity: [0, 0]}
"""

from __future__ import annotations

import ast
import json
import math
import operator
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np

from . import yaml_subset

#: The repository's shipped scene files (``configs/*.yaml``).
CONFIGS_DIR = Path(__file__).resolve().parents[1] / "configs"

#: The 13 physics knobs of the reference, in its canonical order
#: (config/stirring_cup.yaml:10-22).  ``gravity`` is a
#: 2-vector; everything else is scalar.
COEFFICIENT_NAMES = (
    "dt",
    "particle_radius",
    "wall_collision_decay",
    "spring_overlap_balance",
    "spring_amplifier",
    "pressure_amplifier",
    "ignored_pressure",
    "collider_noise_level",
    "viscosity",
    "max_particles",
    "surface_smoothing",
    "target_pressure",
    "gravity",
)


# --- safe motor-expression compiler ----------------------------------------
# The reference ``eval``s arbitrary YAML lambda strings into motor functions
# (rigid_body.py:81-83).  ExprMotor covers that
# config surface without ``eval``: the string is parsed with ``ast`` and only
# numeric literals, ``t``, arithmetic, and a whitelist of elementwise
# numpy/math functions are admitted.  The compiled body is evaluated against
# a caller-supplied array namespace, so the SAME expression runs as torch ops
# inside the step (tensor ``t``) and as float64 numpy in the oracle.

_EXPR_BIN = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.Pow: operator.pow,
    ast.Mod: operator.mod,
    ast.FloorDiv: operator.floordiv,
}
_EXPR_UNARY = {ast.USub: operator.neg, ast.UAdd: operator.pos}
#: math-module spellings normalized to their numpy names.
_EXPR_FUNC_ALIASES = {
    "atan": "arctan", "asin": "arcsin", "acos": "arccos",
    "atan2": "arctan2", "fabs": "abs", "pow": "power",
}
_EXPR_FUNCS = frozenset(
    "sin cos tan arcsin arccos arctan arctan2 sinh cosh tanh exp expm1 "
    "log log1p log2 log10 sqrt cbrt abs absolute sign floor ceil round "
    "minimum maximum clip power hypot".split()
)
_EXPR_CONSTS = {"pi": math.pi, "e": math.e, "tau": math.tau, "inf": math.inf}
_EXPR_MODULES = ("np", "numpy", "jnp", "math")


def _expr_func_name(func: ast.expr) -> str:
    """Whitelisted function name from a Call's func node (or raise)."""
    if isinstance(func, ast.Name):
        name = func.id
    elif (
        isinstance(func, ast.Attribute)
        and isinstance(func.value, ast.Name)
        and func.value.id in _EXPR_MODULES
    ):
        name = func.attr
    else:
        raise ValueError(f"Unsupported motor function {ast.dump(func)}")
    name = _EXPR_FUNC_ALIASES.get(name, name)
    if name not in _EXPR_FUNCS:
        raise ValueError(f"Motor function {name!r} is not in the safe whitelist")
    return name


def _expr_validate(node: ast.expr) -> None:
    """Raise ValueError on any AST node outside the safe grammar."""
    if isinstance(node, ast.Constant):
        if not isinstance(node.value, (int, float)):
            raise ValueError(f"Non-numeric constant {node.value!r}")
    elif isinstance(node, ast.Name):
        if node.id != "t" and node.id not in _EXPR_CONSTS:
            raise ValueError(f"Unknown name {node.id!r} (only 't' and constants)")
    elif isinstance(node, ast.Attribute):
        # e.g. np.pi / math.tau
        if not (
            isinstance(node.value, ast.Name)
            and node.value.id in _EXPR_MODULES
            and node.attr in _EXPR_CONSTS
        ):
            raise ValueError(f"Unsupported attribute {ast.dump(node)}")
    elif isinstance(node, ast.BinOp):
        if type(node.op) not in _EXPR_BIN:
            raise ValueError(f"Unsupported operator {type(node.op).__name__}")
        _expr_validate(node.left)
        _expr_validate(node.right)
    elif isinstance(node, ast.UnaryOp):
        if type(node.op) not in _EXPR_UNARY:
            raise ValueError(f"Unsupported operator {type(node.op).__name__}")
        _expr_validate(node.operand)
    elif isinstance(node, ast.Call):
        _expr_func_name(node.func)
        if node.keywords:
            raise ValueError("Keyword arguments are not supported in motors")
        for a in node.args:
            _expr_validate(a)
    else:
        raise ValueError(f"Unsupported syntax {type(node).__name__} in motor")


def _expr_eval(node: ast.expr, t, xp):
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return t if node.id == "t" else _EXPR_CONSTS[node.id]
    if isinstance(node, ast.Attribute):
        return _EXPR_CONSTS[node.attr]
    if isinstance(node, ast.BinOp):
        return _EXPR_BIN[type(node.op)](
            _expr_eval(node.left, t, xp), _expr_eval(node.right, t, xp)
        )
    if isinstance(node, ast.UnaryOp):
        return _EXPR_UNARY[type(node.op)](_expr_eval(node.operand, t, xp))
    if isinstance(node, ast.Call):
        fn = getattr(xp, _expr_func_name(node.func))
        return fn(*(_expr_eval(a, t, xp) for a in node.args))
    raise AssertionError(node)  # unreachable: _expr_validate admits nothing else


class ExprMotor:
    """A compiled safe motor expression ``lambda t: <expr>``.

    Hash/eq on the AST dump (whitespace-insensitive) so it can ride
    :class:`Scene`'s static fields.  ``__call__(t, xp)`` interprets the
    validated AST against the given namespace (numpy by default; physics
    passes a torch namespace so the motor runs on the step's tensors).
    """

    __slots__ = ("src", "_body", "_key")

    def __init__(self, src: str, body: ast.expr | None = None):
        self.src = " ".join(src.split())
        if body is None:
            tree = ast.parse(src.strip(), mode="eval").body
            if not (
                isinstance(tree, ast.Lambda)
                and len(tree.args.args) == 1
                and tree.args.args[0].arg == "t"
                and not (tree.args.posonlyargs or tree.args.kwonlyargs
                         or tree.args.vararg or tree.args.kwarg)
            ):
                raise ValueError(f"Motor must be a single-arg lambda: {src!r}")
            body = tree.body
        _expr_validate(body)
        self._body = body
        self._key = ast.dump(body)  # whitespace/notation-insensitive identity

    def __call__(self, t, xp=np):
        return _expr_eval(self._body, t, xp)

    def __eq__(self, other) -> bool:
        return isinstance(other, ExprMotor) and self._key == other._key

    def __hash__(self) -> int:
        return hash((ExprMotor, self._key))

    def __repr__(self) -> str:
        return f"ExprMotor({self.src!r})"


@dataclass
class MotorSpec:
    """One scalar motor channel: ``offset + amplitude * cos(frequency*t + phase)``.

    ``expr`` (when set) supersedes the cosine form: the channel is an
    arbitrary safe expression of ``t`` (see :class:`ExprMotor`), and the
    cosine fields are zero so array-based consumers that miss the override
    contribute nothing rather than something wrong.
    """

    amplitude: float = 0.0
    frequency: float = 0.0
    phase: float = 0.0
    offset: float = 0.0
    expr: Optional[ExprMotor] = None

    def __call__(self, t: float) -> float:
        if self.expr is not None:
            return float(self.expr(t))
        return self.offset + self.amplitude * math.cos(self.frequency * t + self.phase)

    def as_tuple(self) -> tuple[float, float, float, float]:
        if self.expr is not None:
            return (0.0, 0.0, 0.0, 0.0)
        return (self.amplitude, self.frequency, self.phase, self.offset)


_CONST_RE = re.compile(r"^lambda\s+t\s*:\s*([-+0-9.eE]+)$")
# e.g. "lambda t: np.cos(t * 5) * 1.4"  (config/stirring_cup.yaml:47)
#      "lambda t: np.cos(t * 8) * 1.5"  (config/wave_machine.yaml:49)
_TRIG_RE = re.compile(
    r"^lambda\s+t\s*:\s*(?:np\.)?(cos|sin)\(\s*t\s*\*\s*([-+0-9.eE]+)\s*\)"
    r"(?:\s*\*\s*([-+0-9.eE]+))?$"
)
_TRIG_PREFACTOR_RE = re.compile(
    r"^lambda\s+t\s*:\s*([-+0-9.eE]+)\s*\*\s*(?:np\.)?(cos|sin)\(\s*t\s*\*\s*([-+0-9.eE]+)\s*\)$"
)


def parse_motor_string(expr: str) -> MotorSpec:
    """Safely parse the lambda-string motor forms the reference configs use.

    Recognized grammars (no ``eval``):
      * ``lambda t: C``                       -> constant C
      * ``lambda t: np.cos(t * F) * A``       -> A*cos(F*t)
      * ``lambda t: np.sin(t * F) * A``       -> A*cos(F*t - pi/2)
      * ``lambda t: A * np.cos(t * F)``       -> A*cos(F*t)
      * any other safe scalar expression of ``t`` -> :class:`ExprMotor`
        (AST-whitelisted, traced into the jitted step — covers third-party
        configs like ``lambda t: np.sin(t)**2`` that the reference would
        ``eval``, rigid_body.py:81-83).

    The cosine fast paths stay preferred because they are pure array data
    (live-sweepable, vmappable); ExprMotor channels are static scene
    structure (editing one recompiles the step).
    """
    expr = expr.strip()
    m = _CONST_RE.match(expr)
    if m:
        return MotorSpec(offset=float(m.group(1)))
    m = _TRIG_RE.match(expr)
    if m:
        fn, freq, amp = m.group(1), float(m.group(2)), float(m.group(3) or 1.0)
        phase = 0.0 if fn == "cos" else -math.pi / 2
        return MotorSpec(amplitude=amp, frequency=freq, phase=phase)
    m = _TRIG_PREFACTOR_RE.match(expr)
    if m:
        amp, fn, freq = float(m.group(1)), m.group(2), float(m.group(3))
        phase = 0.0 if fn == "cos" else -math.pi / 2
        return MotorSpec(amplitude=amp, frequency=freq, phase=phase)
    try:
        return MotorSpec(expr=ExprMotor(expr))
    except (ValueError, SyntaxError) as e:
        raise ValueError(
            f"Unsupported motor expression {expr!r} ({e}). Use a declarative "
            "motor spec {amplitude, frequency, phase, offset} instead."
        ) from e


#: Fast path: ``lambda t: np.array([Cx, Cy])`` with numeric constants (the
#: only vector form round 1/2 accepted) stays a pure-constant MotorSpec pair.
_VEC_CONST_RE = re.compile(
    r"^lambda\s+t\s*:\s*np\.array\(\[\s*([-+0-9.eE]+)\s*,\s*([-+0-9.eE]+)\s*\]\)$"
)


def parse_vector_motor_string(src: str) -> tuple[MotorSpec, MotorSpec]:
    """Parse a legacy ``velocity_func`` lambda returning a 2-vector.

    Accepts ``lambda t: np.array([ex, ey])`` / ``np.asarray`` / a bare tuple
    or list body, where ``ex``/``ey`` are any safe scalar expressions of
    ``t`` (the reference evals these strings, rigid_body.py:81-83).  Each
    component becomes its own motor channel.
    """
    src = src.strip()
    m = _VEC_CONST_RE.match(src)
    if m:
        return (
            MotorSpec(offset=float(m.group(1))),
            MotorSpec(offset=float(m.group(2))),
        )
    try:
        tree = ast.parse(src, mode="eval").body
        if not (isinstance(tree, ast.Lambda) and len(tree.args.args) == 1
                and tree.args.args[0].arg == "t"):
            raise ValueError("must be a single-arg lambda of t")
        body = tree.body
        if (
            isinstance(body, ast.Call)
            and isinstance(body.func, ast.Attribute)
            and isinstance(body.func.value, ast.Name)
            and body.func.value.id in _EXPR_MODULES
            and body.func.attr in ("array", "asarray")
            and len(body.args) == 1
            and not body.keywords
        ):
            body = body.args[0]
        if not (isinstance(body, (ast.List, ast.Tuple)) and len(body.elts) == 2):
            raise ValueError("body must be a 2-vector (np.array/list/tuple)")
        def component(el: ast.expr, axis: str) -> MotorSpec:
            try:  # plain numeric component -> live-editable constant channel
                return MotorSpec(offset=float(ast.literal_eval(el)))
            except (ValueError, TypeError):
                return MotorSpec(expr=ExprMotor(f"lambda t: <{axis} of {src}>", body=el))

        ex, ey = body.elts
        return component(ex, "x"), component(ey, "y")
    except (ValueError, SyntaxError) as e:
        raise ValueError(
            f"Unsupported velocity_func {src!r} ({e}); use 'velocity_motor'."
        ) from e


def parse_motor(value: Any) -> MotorSpec:
    """Parse a motor channel from a YAML value (string lambda / dict / number)."""
    if value is None:
        return MotorSpec()
    if isinstance(value, str):
        return parse_motor_string(value)
    if isinstance(value, (int, float)):
        return MotorSpec(offset=float(value))
    if isinstance(value, dict):
        return MotorSpec(
            amplitude=float(value.get("amplitude", 0.0)),
            frequency=float(value.get("frequency", 0.0)),
            phase=float(value.get("phase", 0.0)),
            offset=float(value.get("offset", 0.0)),
        )
    raise TypeError(f"Cannot parse motor spec from {value!r}")


# Body kind codes shared with the compiled step.
BODY_FIXED = 0
BODY_MOTORED = 1
BODY_FREE = 2
_BODY_KINDS = {"fixed": BODY_FIXED, "motored": BODY_MOTORED, "free": BODY_FREE}


@dataclass
class RigidBodyConfig:
    """Declarative rigid body (mirrors rigid_body.py:19-68).

    ``segments`` are in body-local coordinates; placement applies
    scale -> rotate (degrees, CCW in crate coords) -> translate, matching the
    reference's ``place_in_world`` (rigid_body.py:36-40).
    """

    kind: int
    segments: list  # S x 2 x 2 nested lists (local coordinates)
    name: str = ""
    scale: tuple[float, float] = (1.0, 1.0)
    position: tuple[float, float] = (0.0, 0.0)
    rotation: float = 0.0  # degrees
    center_velocity: tuple[float, float] = (0.0, 0.0)
    angular_velocity0: float = 0.0
    motor_vx: MotorSpec = field(default_factory=MotorSpec)
    motor_vy: MotorSpec = field(default_factory=MotorSpec)
    motor_ang: MotorSpec = field(default_factory=MotorSpec)


@dataclass
class ParticleSourceConfig:
    """Particle emitter (mirrors particle_source.py:9-15)."""

    radius: float
    position: tuple[float, float]
    velocity: tuple[float, float]
    flow: float
    active_ticks: int
    noise: float = 0.05


@dataclass
class InitialParticlesConfig:
    """Bulk particle seeding (extension; used by the dam-break benchmark)."""

    x0: float
    y0: float
    x1: float
    y1: float
    spacing: float
    velocity: tuple[float, float] = (0.0, 0.0)
    jitter: float = 0.0  # fraction of spacing


@dataclass
class WorldConfig:
    rigid_bodies: list[RigidBodyConfig]
    particle_sources: list[ParticleSourceConfig]
    coefficients: dict[str, Any]
    initial_particles: list[InitialParticlesConfig] = field(default_factory=list)


@dataclass
class PlaybackConfig:
    save_recording: bool = False
    ticks_to_record: int = 1000
    recording_output_dir_path: Path = Path("data/recordings")
    screen_x: int = 1000
    screen_y: int = 1000


@dataclass
class Config:
    world_config: WorldConfig
    playback_config: PlaybackConfig
    raw: dict = field(default_factory=dict)


def _parse_rigid_body(entry: dict) -> RigidBodyConfig:
    """Parse one ``{fixed|motored|free: kwargs}`` body entry."""
    (kind_name, kwargs), = entry.items()
    if kind_name not in _BODY_KINDS:
        raise ValueError(f"Unknown rigid body type {kind_name!r}")
    kwargs = dict(kwargs)
    vel = kwargs.pop("velocity", kwargs.pop("center_velocity", (0.0, 0.0)))
    motor_v = kwargs.pop("velocity_func", None)
    motor_a = kwargs.pop("angular_velocity_func", None)
    # Declarative alternatives to the legacy lambda strings.
    motor_v_decl = kwargs.pop("velocity_motor", None)
    motor_a_decl = kwargs.pop("angular_velocity", None)

    if isinstance(motor_v_decl, dict) and (
        "x" in motor_v_decl or "y" in motor_v_decl
    ):
        motor_vx = parse_motor(motor_v_decl.get("x"))
        motor_vy = parse_motor(motor_v_decl.get("y"))
    elif motor_v_decl is not None:
        motor_vx = parse_motor(motor_v_decl)
        motor_vy = parse_motor(motor_v_decl)
    elif isinstance(motor_v, str):
        motor_vx, motor_vy = parse_vector_motor_string(motor_v)
    else:
        motor_vx = MotorSpec()
        motor_vy = MotorSpec()

    motor_ang = parse_motor(motor_a_decl if motor_a_decl is not None else motor_a)

    return RigidBodyConfig(
        kind=_BODY_KINDS[kind_name],
        segments=kwargs.pop("segments"),
        name=kwargs.pop("name", ""),
        scale=tuple(kwargs.pop("scale", (1.0, 1.0))),
        position=tuple(kwargs.pop("position", (0.0, 0.0))),
        rotation=float(kwargs.pop("rotation", 0.0)),
        center_velocity=tuple(vel),
        angular_velocity0=float(kwargs.pop("angular_clockwise_velocity", 0.0)),
        motor_vx=motor_vx,
        motor_vy=motor_vy,
        motor_ang=motor_ang,
    )


def _parse_initial_particles(entry: dict) -> InitialParticlesConfig:
    if "block" in entry:
        entry = entry["block"]
    return InitialParticlesConfig(
        x0=float(entry["x0"]),
        y0=float(entry["y0"]),
        x1=float(entry["x1"]),
        y1=float(entry["y1"]),
        spacing=float(entry["spacing"]),
        velocity=tuple(entry.get("velocity", (0.0, 0.0))),
        jitter=float(entry.get("jitter", 0.0)),
    )


def load_config_dict(raw: dict) -> Config:
    """Build a Config from a parsed YAML dict (reference schema)."""
    world = raw["world"]
    coefficients = dict(world.get("coefficients") or {})
    missing = [k for k in COEFFICIENT_NAMES if k not in coefficients]
    if missing:
        raise ValueError(f"Missing coefficients in config: {missing}")
    world_config = WorldConfig(
        rigid_bodies=[_parse_rigid_body(b) for b in world.get("rigid_bodies", [])],
        particle_sources=[
            ParticleSourceConfig(
                radius=float(s["radius"]),
                position=tuple(s["position"]),
                velocity=tuple(s["velocity"]),
                flow=float(s["flow"]),
                active_ticks=int(s["active_ticks"]),
                noise=float(s.get("noise", 0.05)),
            )
            for s in (world.get("particle_sources") or [])
        ],
        coefficients=coefficients,
        initial_particles=[
            _parse_initial_particles(e) for e in world.get("initial_particles", [])
        ],
    )
    pb = raw.get("playback", {})
    playback_config = PlaybackConfig(
        save_recording=bool(pb.get("save_recording", False)),
        ticks_to_record=int(pb.get("ticks_to_record", 1000)),
        recording_output_dir_path=Path(
            pb.get("recording_output_dir_path", "data/recordings")
        ),
        screen_x=int(pb.get("screen_x", 1000)),
        screen_y=int(pb.get("screen_y", 1000)),
    )
    return Config(world_config=world_config, playback_config=playback_config, raw=raw)


def load_config(config_file_path: str | Path) -> Config:
    """Load a scene file (reference schema; load_config.py:29-46 equivalent).

    A ``.json`` file is read with ``json`` (JSON is a subset of YAML, so the
    dict is the one ``yaml.safe_load`` gives); any other file is YAML, read
    with PyYAML where it is installed and otherwise with
    :mod:`~sand_crate_tpu_torch.yaml_subset`, which gives the same dict for
    the scene files' YAML."""
    path = Path(config_file_path)
    text = path.read_text()
    if path.suffix == ".json":
        return load_config_dict(json.loads(text))
    try:
        import yaml
    except ImportError:
        return load_config_dict(yaml_subset.load(text))
    return load_config_dict(yaml.safe_load(text))


def dump_config(config: Config) -> str:
    """Serialize the (possibly edited) config back to YAML for recordings
    (PyYAML where it is installed, else :func:`yaml_subset.dump`)."""
    try:
        import yaml
    except ImportError:
        return yaml_subset.dump(config.raw)
    return yaml.safe_dump(config.raw, sort_keys=False)
