"""What the benchmark may import and read: nothing of JAX or of the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), none of the JAX benchmark's files, and, in the reference,
nothing of the port."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tensornetworksfork_tpu"}
PORT = "tensornetworksfork_tpu_torch"
SOURCES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


def top_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_import(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_reads_no_jax_benchmark_file(path):
    if path.parent.name == "tests" and path.name == "test_pb_imports.py":
        return
    text = path.read_text()
    for name in ("bench.py", "benchmarks/", "baseline_cache.json"):
        assert name not in text, name


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_imports(path)
    assert "portbench" not in top_imports(path)


def test_prefix_is_not_a_match():
    # the check compares whole names: the port's own name must pass
    assert PORT not in FORBIDDEN and PORT.startswith("tensornetworksfork_tpu")


def test_a_run_loads_no_jax():
    code = ("import sys; import portbench.run, portbench.harness as h; "
            "import portbench.drivers.sweep, portbench.drivers.serve; "
            "import tensornetworksfork_tpu_torch.core.sweep, "
            "tensornetworksfork_tpu_torch.models.estimators, "
            "tensornetworksfork_tpu_torch.utils.serving; print(h.forbidden_modules())")
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
