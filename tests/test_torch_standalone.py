"""The port stands on its own: no module of ``dbgphmm_tpu_torch``, and not
``chip_smoke.py``, imports JAX or anything of the JAX package
``dbgphmm_tpu``; importing the port's entry points loads neither; and its
native host libraries are built into ``dbgphmm_tpu_torch/build/`` only."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dbgphmm_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FOREIGN = ("jax", "dbgphmm_tpu")


def _absolute_imports(path):
    """Top-level package names of every absolute import in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = [(name, line) for name, line in _absolute_imports(path)
           if name in FOREIGN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_entry_points_load_nothing_of_jax():
    """The package, the CLI, the posterior, e2e and chip_smoke (as a
    module, without running main) in a fresh interpreter."""
    code = (
        "import importlib.util, sys\n"
        "import dbgphmm_tpu_torch, dbgphmm_tpu_torch.cli\n"
        "import dbgphmm_tpu_torch.multi_dbg.posterior, dbgphmm_tpu_torch.e2e\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FOREIGN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["positions", "flow", "seedchain",
                                  "kshortest"])
def test_host_library_builds_into_the_ports_build_directory(name):
    """Each copied host kernel of csrc/host/ compiles with g++ into
    dbgphmm_tpu_torch/build/, and no shared library lies anywhere else in
    the package."""
    from dbgphmm_tpu_torch.ops import _build

    so = _build.host_so(name)
    assert so.parent == _build.BUILD_DIR == PORT / "build"
    assert so.exists() and so.name.startswith(f"lib{name}_")
    stray = [p for p in PORT.rglob("*.so") if _build.BUILD_DIR not in p.parents]
    assert not stray, stray
