"""The PyTorch port imports neither jax nor the JAX package (nor the JAX
side's ``experiments/`` and ``bench.py``), and neither does chip_smoke.py."""

import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "lrp_imagecaptioning_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "lrp_imagecaptioning_tpu", "experiments", "bench")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_no_jax_in_a_fresh_process():
    mods = list(_modules())
    assert "lrp_imagecaptioning_torch.pipeline" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py", *sorted(PKG.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    assert not set(_imported_roots(path)) & set(FORBIDDEN)
