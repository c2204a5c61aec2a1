"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "xfeatslam_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    bad = {m for m in _imports(path) if m.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "contextlib", "numpy", "torch"}, (
            path, tops)


def test_a_run_loads_no_jax():
    """A whole (small, CPU) run in a fresh process, then sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, run\n"
        "from benchmark.tests.tiny import tiny\n"
        "out = run.run(tiny('offline.kitti.b256'), 3, 0.2, True, "
        "device='cpu')\n"
        "assert out['correct'], out\n"
        "print(harness.loaded_forbidden())\n" % str(HERE.parent))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
