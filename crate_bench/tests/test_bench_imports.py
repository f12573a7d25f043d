"""Nothing of the benchmark imports JAX or the JAX package: each module's
imports by their top-level name, compared whole (the port's package name
begins with the JAX package's), and the modules a whole run loads."""

from __future__ import annotations

import ast
import subprocess
import sys

from crate_bench import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "sand_crate_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((registry.HERE).rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_a_cpu_run_loads_neither():
    """A run of a tiny cell on the CPU, then ``sys.modules`` by top-level
    name: the harness, the program and the reference load no JAX."""
    code = (
        "import sys, torch\n"
        "from crate_bench import run, registry\n"
        "from crate_bench.tests import small\n"
        "b = registry.load_benchmark()\n"
        "run.run_cell(b, 'dam_break_1m.live', 3, 0.2, False, torch.device('cpu'),"
        " cfg=small.dam_break(600))\n"
        "for m in b['per_layer']: registry.metric_module(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        + repr(FORBIDDEN) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
