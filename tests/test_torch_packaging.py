"""The port's packaging in pyproject.toml: an installed copy holds every file
the kernel build reads (``ops/_build.py``: each source ``csrc/<stem>.cu`` and
the headers ``csrc/*.cuh`` it hashes and includes), the serving contract's
``.proto``, and the ``lrpic-torch`` console script. Checked against the
package-data globs, without building a wheel."""

import fnmatch
import importlib
import pathlib
import subprocess
import tomllib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "lrp_imagecaptioning_torch"


def _setuptools():
    return tomllib.loads((ROOT / "pyproject.toml").read_text())


def _packaged(path: pathlib.Path) -> bool:
    """Whether ``path`` matches a package-data glob of the package that holds it."""
    data = _setuptools()["tool"]["setuptools"]["package-data"]
    for pkg, globs in data.items():
        pkg_dir = ROOT / pkg.replace(".", "/")
        try:
            rel = path.resolve().relative_to(pkg_dir)
        except ValueError:
            continue
        if any(fnmatch.fnmatch(str(rel), g) for g in globs):
            return True
    return False


def test_every_file_the_kernel_build_reads_is_package_data():
    from lrp_imagecaptioning_torch.ops import _build

    read = [_build.CSRC / f"{stem}.cu" for stem, _ in _build.SIGNATURES.values()]
    read += sorted(_build.CSRC.glob("*.cuh"))
    assert any(p.suffix == ".cuh" for p in read)
    missing = [str(p.relative_to(ROOT)) for p in read if not p.exists() or not _packaged(p)]
    assert not missing


def test_every_tracked_data_file_of_the_port_is_package_data():
    files = subprocess.run(["git", "ls-files", PKG], cwd=ROOT, capture_output=True, text=True,
                           check=True).stdout.split()
    data = [ROOT / f for f in files if not f.endswith(".py")]
    assert any(p.suffix == ".proto" for p in data)
    assert not [str(p) for p in data if not _packaged(p)]


def test_packages_and_console_script():
    project = _setuptools()
    include = project["tool"]["setuptools"]["packages"]["find"]["include"]
    for init in (ROOT / PKG).rglob("__init__.py"):
        name = ".".join(init.parent.relative_to(ROOT).parts)
        assert any(fnmatch.fnmatch(name, g) for g in include), name
    target = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"][
        "lrpic-torch"]
    module, attr = target.split(":")
    assert module == f"{PKG}.cli" and callable(getattr(importlib.import_module(module), attr))
