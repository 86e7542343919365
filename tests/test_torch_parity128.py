"""The benchmark's cell ``parity128.b128`` (configuration
``schwinger128-parity``: complex128 solves to 1e-12, an 8-vector gamma3
basis at 1e-9) on the CPU, cut by benchmark/tests/conftest.py
``small_spec`` to 16^2 (still four levels; 32^2 takes 40 s): a sound run
through ``core.run_cell`` is judged correct by the plain reference
(benchmark/reference.py), the same run in complex64 is judged incorrect
by ``relres_max``, and the configuration file passes the manifest's
``check_configuration``."""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CELL = "parity128.b128"


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_tests():
    """benchmark/tests' conftest and manifest tests, loaded under names of
    their own (this directory has a conftest of its own)."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    conf = _load("bench_conftest", BENCH / "tests" / "conftest.py")
    held = sys.modules.get("conftest")
    sys.modules["conftest"] = conf
    try:
        manifest = _load("bench_test_manifest", BENCH / "tests" / "test_bench_manifest.py")
    finally:
        if held is None:
            sys.modules.pop("conftest", None)
        else:
            sys.modules["conftest"] = held
    return conf, manifest


def _run(spec, tmp_path, seed=2147483629):
    import core

    torch.set_num_threads(2)
    return core.run_cell(spec, seed, 0.5, False, "cpu", time.perf_counter(), str(tmp_path),
                         log=lambda *a: None)


def test_configuration_passes_the_check():
    _, manifest = _bench_tests()
    entry = next(c for c in manifest.MANIFEST["configs"] if c["name"] == "schwinger128-parity")
    data = json.loads((ROOT / entry["file"]).read_text())
    manifest.check_configuration(entry, data)
    assert entry["reduced"] == ["matrix", "mass", "solver", "probe_batch"]
    tc = data["trace_config"]
    assert (tc["dtype"], tc["function_tol"], tc["nr_deflat_vctrs"],
            tc["defl_eigvs_tol_Hutch"]) == ("complex128", 1e-12, 8, 1e-9)
    cell = next(w for w in manifest.MANIFEST["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "schwinger128-parity", "hutchinson.b128", 1)


@pytest.mark.parametrize("dtype, correct", [("complex128", True), ("complex64", False)])
def test_small_cell_against_the_reference(dtype, correct, tmp_path):
    conf, _ = _bench_tests()
    spec = conf.small_spec(CELL, lattice=16)
    spec["config"]["trace_config"]["dtype"] = dtype
    r = _run(spec, tmp_path)
    checks = r["checks"]
    assert r["correct"] is correct, checks
    assert r["attempted"] > 0 and r["failed"] == 0
    if correct:
        assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    else:
        # complex64 solves stop at their floor, far above function_tol 1e-12
        assert checks["relres_max"]["value"] > 100 * checks["relres_max"]["limit"], checks
