"""No JAX, no JAX package on the chip's path, compared by whole top-level
names; nothing of the program in the reference."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

from benchmarks import harness
from benchmarks.tests import fixture

REFERENCE = fixture.REPO / "benchmarks" / "reference"


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "monkeynet_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "monkeynet_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "optax", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["monkeynet_tpu", "optax"]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_neither_the_program_nor_jax():
    for path in REFERENCE.glob("*.py"):
        assert not _imports(path) & {"monkeynet_tpu_torch", *harness.FORBIDDEN}, path
        assert not any(n.startswith("monkeynet") for n in _imports(path)), path


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A whole dry run in a fresh process, then the run's own check."""
    root = fixture.make_root(tmp_path)
    code = (
        "import sys; from benchmarks import run, harness\n"
        f"run.drive({str(root)!r}, 'vox256.train', 7, 0.2, 0, 'cpu')\n"
        "run.drive" f"({str(root)!r}, 'taichi64.transfer', 7, 0.2, 1, 'cpu')\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted(m for m in sys.modules if m.startswith('benchmarks.reference')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=fixture.REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert "benchmarks.reference.model" in lines[-1]


def test_reference_alone_loads_nothing_of_the_program():
    code = ("import sys, benchmarks.reference.model, benchmarks.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'monkeynet_tpu_torch', 'monkeynet_tpu', 'jax', 'jaxlib', 'flax', 'optax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=fixture.REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_without_the_program_or_a_card_a_run_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints nothing on stdout."""
    import shutil

    shutil.copy(fixture.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(fixture.REPO / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload",
                          "taichi64.transfer", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
