"""Nothing that the benchmark runs loads JAX or the JAX package, compared
by whole top-level names ('packnet_sfm_tpu_torch' is the program, not
'packnet_sfm_tpu'); nothing under reference/ imports the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from portbench.harness import PACKAGE
from portbench.run import FORBIDDEN, forbidden_modules

ROOT = PACKAGE.parent


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((PACKAGE / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top in ("torch", "math", "typing", "__future__", "portbench"), (f.name, name)
            assert not name.startswith("portbench.") or name.startswith("portbench.reference"), \
                (f.name, name)


def test_no_file_of_the_benchmark_imports_jax():
    for f in sorted(PACKAGE.rglob("*.py")):
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "packnet_sfm_tpu_torch.fake_for_test", sys)
    assert "packnet_sfm_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "packnet_sfm_tpu.fake_for_test", sys)
    assert "packnet_sfm_tpu" in forbidden_modules()


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A whole tiny run on the CPU, in a fresh process, leaves no module of
    JAX or the JAX package in sys.modules."""
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
from portbench.tests import tiny
from portbench.harness import run_cell
from portbench.run import forbidden_modules
reg = tiny.write({str(tmp_path)!r}, ("tiny_eval",))
out = run_cell(reg, "tiny_eval", 5, 0.5, True, torch.device("cpu"))
assert out["correct"], out["checks"]
assert "packnet_sfm_tpu_torch" in {{m.split(".")[0] for m in sys.modules}}
print("FOUND", forbidden_modules())
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND []" in res.stdout
