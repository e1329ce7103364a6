"""What the benchmark loads: no JAX and no JAX package (top-level names
compared whole, since the port's name begins with the JAX package's), and a
reference that imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness import runner

BENCH = Path(__file__).resolve().parents[1]


def test_top_level_names_are_compared_whole():
    mods = {"slam_tricks_tpu_torch": 0, "slam_tricks_tpu_torch.ops": 0,
            "jaxtyping": 0, "flaxen": 0, "numpy": 0}
    assert runner.forbidden_modules(mods) == []
    mods.update({"jax": 0, "jax.numpy": 0, "slam_tricks_tpu.solvers": 0,
                 "flax": 0, "jaxlib": 0})
    assert runner.forbidden_modules(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib", "slam_tricks_tpu.solvers"]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert _imports(path) <= {"typing", "numpy", "torch", "benchmark"}, \
            path
        assert not any(n.startswith("slam_tricks_tpu") for n in _imports(path))


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "slam_tricks_tpu"}, path


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.harness import runner, checks, loops\n"
            "from benchmark.kinds import closed_solves\n"
            "from benchmark.scenes import cube_room, circle_trajectory\n"
            "from benchmark.reference import lm_ba\n"
            "from benchmark.solvers import flat_sm, banded, control_tf32\n"
            "import slam_tricks_tpu_torch.solvers.schur_flat_sm\n"
            "import slam_tricks_tpu_torch.solvers.banded_flat\n"
            "print(runner.forbidden_modules())\n" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
