"""What the harness loads: no JAX, no JAX package (whole top-level names),
no module of the port under `benchmark/reference/`; without a card the
command exits non-zero and prints no result."""

from __future__ import annotations

import ast
import glob
import os
import os.path as osp
import subprocess
import sys
import types

from benchmark import harness

BENCH = harness.BENCH_DIR


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in glob.glob(osp.join(BENCH, "**", "*.py"), recursive=True):
        found = _imports(path) & set(harness.FORBIDDEN)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_port():
    for path in glob.glob(osp.join(BENCH, "reference", "*.py")):
        mods = _imports(path)
        assert harness.PACKAGE not in mods, path
        assert mods <= {"__future__", "math", "numpy", "torch", "benchmark"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    assert harness.PACKAGE.startswith("zeroshotsemanticsegmentation_tpu")
    monkeypatch.setitem(sys.modules, harness.PACKAGE + ".fake",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == [] or \
        "jax" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in harness.forbidden_modules()


def test_without_a_card_the_command_prints_no_result(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(
        [sys.executable, osp.join(BENCH, "run.py"), "--workload",
         "fcn32s-voc.serve-b16", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
