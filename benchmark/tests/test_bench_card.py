"""On the card: one short run of each cell through benchmark/run.py is
correct and prints the cell's metrics; the result names the card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_short_run_on_the_card(cell, card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                          "--seed", str(2 ** 32 + 7), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    e2e = {m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == e2e
