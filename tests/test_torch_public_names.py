"""Every public function and class of the JAX package has its namesake in
the port.

Both packages are read as source (``ast``), so no module is imported: for
each module of ``sand_crate_tpu/``, every top-level ``def`` and ``class``
whose name has no leading underscore must be bound at the top level of the
port's module of the same path (``sand_crate_tpu_torch/``), by a ``def``, a
``class``, an assignment or an import.  Constants are not checked: the JAX
package's TPU tile sizes (``VCAP``, ``OWN``, ``SUB_G`` and the like) have no
counterpart.  The exceptions below are named with their reasons.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "sand_crate_tpu", ROOT / "sand_crate_tpu_torch"

# Modules of the JAX package with no port module, and why.
MODULES_LEFT_OUT = {
    "numpy_ref.py": "the float64 oracle that the tests of both packages share",
}
# Public names of a JAX module that the port leaves out, and why.
NAMES_LEFT_OUT = {
    ("ops/pair_kernel.py", "occ_from_row_start"):
        "the port's pallas backend sums every slot pair: no lo/hi add-on split to size "
        "(ROADMAP, deviations)",
}

MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _blocks(body):
    """The statements of ``body`` and of the top-level ``if`` / ``try``
    blocks in it (a name bound there is bound at import)."""
    for node in body:
        yield node
        if isinstance(node, (ast.If, ast.Try)):
            for part in (node.body, node.orelse, getattr(node, "finalbody", []),
                         *(h.body for h in getattr(node, "handlers", []))):
                yield from _blocks(part)


def public_defs(path: Path) -> set:
    """The top-level functions and classes of ``path`` without a leading
    underscore."""
    return {n.name for n in _blocks(ast.parse(path.read_text()).body)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def bound_names(path: Path) -> set:
    """Every name bound at the top level of ``path``."""
    out = set()
    for n in _blocks(ast.parse(path.read_text()).body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            for target in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                out.update(e.id for e in ast.walk(target) if isinstance(e, ast.Name))
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


def test_the_modules_exist():
    """Every JAX module has a port module of the same path, but those left
    out; every exception names a module or name that exists."""
    missing = [m for m in MODULES if m not in MODULES_LEFT_OUT and not (PORT_PKG / m).exists()]
    assert not missing, missing
    assert all(m in MODULES and not (PORT_PKG / m).exists() for m in MODULES_LEFT_OUT)
    for module, name in NAMES_LEFT_OUT:
        assert name in public_defs(JAX_PKG / module), (module, name)
        assert name not in bound_names(PORT_PKG / module), (module, name)


@pytest.mark.parametrize("module", [m for m in MODULES if m not in MODULES_LEFT_OUT])
def test_public_names_exist_in_the_port(module):
    want = {n for n in public_defs(JAX_PKG / module) if (module, n) not in NAMES_LEFT_OUT}
    missing = sorted(want - bound_names(PORT_PKG / module))
    assert not missing, f"sand_crate_tpu_torch/{module} lacks {missing}"


def test_the_per_kick_functions_are_there():
    """The seven per-kick functions (ROADMAP fault F1) are callables of the
    port's physics module."""
    from sand_crate_tpu_torch import physics

    for name in ("apply_tension", "apply_gravity", "apply_pressure_force", "apply_spring",
                 "apply_viscosity", "apply_wall_bounce", "apply_continuous_collision"):
        assert callable(getattr(physics, name)), name
