"""Nothing the benchmark runs imports JAX, the JAX package ``repro`` or the
old ``benchmarks/`` (each module's top-level name compared whole: the
port's ``repro_torch`` begins with ``repro``), and the references import
nothing of the program.  Checked in the sources and in a fresh process
that runs a tiny cell, since a test process shares ``sys.modules`` with
every other test file."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from perfbench import harness

BENCH = Path(harness.__file__).resolve().parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.partition(".")[0]


def test_sources_import_nothing_forbidden():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path
    assert set(harness.FORBIDDEN) & {"repro_torch"} == set()


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "references").glob("*.py"):
        assert set(_imports(path)) <= {"__future__", "typing", "math",
                                       "importlib", "torch"}, path
    assert set(_imports(BENCH / "check.py")) <= {
        "__future__", "typing", "numpy", "torch"}


CHILD = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import harness
from perfbench.conftest import tiny
cell, pc = tiny("olmo2_7b.chat")
harness.run_cell(cell, 5, 0.3, False, t_start=time.perf_counter(),
                 device="cpu", port_cfg=pc, log=lambda _: None)
names = {{m.partition(".")[0] for m in sys.modules}}
print(json.dumps({{"forbidden": harness.forbidden_loaded(),
                  "port": "repro_torch" in names}}))
"""


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch_x", "jaxtyping", "benchmarks_old"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(harness.forbidden_loaded()) - set(
        m.partition(".")[0] for m in sys.modules if m.partition(".")[0]
        in harness.FORBIDDEN)
    monkeypatch.setitem(sys.modules, "repro.kernels", sys)
    assert "repro" in harness.forbidden_loaded()
    assert "repro_torch_x" not in harness.forbidden_loaded()


def test_a_fresh_run_loads_nothing_forbidden():
    root = str(BENCH.parent)
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=root, src=root + "/src")],
        capture_output=True, text=True, timeout=120, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port": True}
