"""Tests of the benchmark itself (python -m pytest benchmark/tests -q).

They import the harness from benchmark/ and the port from the repository's
root. The tests marked ``card`` need an NVIDIA card; a fixture decides
whether one is there, so every worker collects the same tests."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the port on the card")
    return torch.device("cuda:0")


def small_spec(name: str, probe_batch: int = 8, lattice: int = 32) -> dict:
    """A cell of BENCHMARK.json cut to a lattice the CPU solves in seconds:
    the same profile, estimator and checks, 16 deflation vectors, batches
    of ``probe_batch``, and the dense-exact MLMC levels kept below level 0."""
    import core

    spec = copy.deepcopy(core.load_cell(name, ROOT))
    tc = spec["config"]["trace_config"]
    spec["config"]["operator"].update(nx=lattice, nt=lattice)
    tc["latt_dims"] = [lattice, lattice]
    if tc["nr_deflat_vctrs"]:
        tc.update(nr_deflat_vctrs=16, defl_buffer=16)
    tc["aggrs"] = [16, 4, 4]
    tc["mlmc_exact_dense_max_n"] = min(tc["mlmc_exact_dense_max_n"], 256)
    spec["traffic"]["probe_batch"] = probe_batch
    return spec
