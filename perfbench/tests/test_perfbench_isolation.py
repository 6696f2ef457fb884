"""Nothing of the benchmark imports JAX, the JAX package, the old bench
scripts or the smoke; the reference imports nothing of the program."""

import ast

from perfbench.harness.cell import BENCH

NEVER = {"jax", "jaxlib", "flax", "lrp_imagecaptioning_tpu", "bench", "experiments",
         "chip_smoke"}
PROGRAM = "lrp_imagecaptioning_torch"


def imported(path) -> set:
    """The top-level names (before the first dot) of every import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_old_benchmarks():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not imported(f) & NEVER, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert PROGRAM not in imported(f), f
        assert imported(f) <= {"__future__", "math", "dataclasses", "torch", "numpy"}, f
