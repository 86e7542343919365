"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package,
judged by whole top-level module names (the port's name begins with the
JAX package's), and the plain reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "deflatedmlmc_schwinger_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not (_imports(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "gauge.py", "stats.py", "roofline.py"):
        assert "deflatedmlmc_schwinger_tpu_torch" not in _imports(BENCH / name), name


def test_whole_names_decide():
    sys.path.insert(0, str(BENCH))
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["deflatedmlmc_schwinger_tpu_torch_x"] = sys
        assert run.loaded_forbidden() == []
        sys.modules["jaxlib.foo"] = sys
        assert run.loaded_forbidden() == ["jaxlib"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax(tmp_path):
    """Every module reachable from benchmark/run.py's cell path, in a fresh
    process: the harness, both estimators, every metric reader, one small
    cell on the CPU."""
    code = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}, {str(BENCH / 'tests')!r}]
import torch
torch.set_num_threads(2)
import core, readings, run
from conftest import small_spec
import estimators.hutchinson, estimators.mlmc
import json
for m in json.load(open({str(ROOT / 'BENCHMARK.json')!r}))["per_layer"]:
    core.load_metric(m["name"])
r = core.run_cell(small_spec("hutch128.b128", lattice=16), 5, 0.5, False, "cpu",
                  time.perf_counter(), {str(tmp_path)!r}, log=lambda *a: None)
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
