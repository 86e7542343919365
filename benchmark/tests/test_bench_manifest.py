"""BENCHMARK.json against the contract it is written to, and the files it
names."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"][1] == "benchmark/run.py"
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_check_budget_fits_with_24_cells():
    """2 + 14 n runs of run_seconds + 60 s, 2 x 90 s of compilation per
    cell and 1200 s spare fit into 43200 s for n = 24."""
    n = 24
    total = (2 + 14 * n) * (MANIFEST["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in names
            names.add((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert _line(entry[key]), (entry["name"], key)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert {"samples_per_s", "sampling_s_to_1pct", "setup_s"} <= set(e2e)
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"
        layers.setdefault(m["layer"], set()).add(m["name"])
    import core

    for m in MANIFEST["per_layer"]:
        mod = core.load_metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    import core
    import reference

    spec = core.load_cell(cell, ROOT)
    assert (BENCH / "estimators" / f"{spec['traffic']['estimator']}.py").exists()
    assert set(spec["limits"]) <= {"relres_max", "est_gap", "tr1_err"}
    assert "relres_max" in spec["limits"]
    assert reference.judge.__doc__


# the upstream set's parameters (its gateway.py); TraceConfig's defaults are
# its schwinger128 values
UPSTREAM_KEYS = ("trace_tol", "max_nr_levels", "coarsest_level_directly", "accuracy_mg_eigvs",
                 "nr_deflat_vctrs", "mlmc_deflat_vctrs", "mlmc_levels_to_skip", "aggrs", "dof",
                 "defl_type", "defl_eigvs_tol_Hutch", "defl_eigvs_tol_MLMC", "diff_lev_op_tol",
                 "use_permuted", "latt_dims", "x_displacement", "check_quality_MG",
                 "test_vectors_type", "function_tol", "mass", "matrix")


def check_configuration(entry: dict, data: dict) -> None:
    """The file holds the configuration as it is run: the program's profile
    of the same name, with the field and mass of the generated operator in
    place of the profile's where they differ. ``reduced`` lists every key in
    which it departs from the upstream set that ``source`` names
    (TraceConfig's defaults are its schwinger128 values), each with the
    upstream value and the reason; every other upstream key is as upstream
    has it."""
    import core
    from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig
    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params

    assert entry["file"].startswith("benchmark/configs/")
    assert data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] == list(data["departures"])
    assert len(entry["reduced"]) <= 16
    run = core.trace_config(data["trace_config"])
    profile = set_params(data["profile"])
    op = data["operator"]
    generated = f"generated:{op['nx']}x{op['nt']}:beta={op['beta']}:seed={op['field_seed']}"
    assert run.matrix == generated
    assert run.mass == op["mass"] and tuple(run.latt_dims) == (op["nx"], op["nt"])
    differ = {f.name for f in dataclasses.fields(run)
              if getattr(run, f.name) != getattr(profile, f.name)}
    assert differ <= {"matrix", "mass"}
    upstream = TraceConfig()
    for key in entry["reduced"]:
        assert getattr(run, key) != getattr(upstream, key), key
        assert data["departures"][key]["why"]
    for key in UPSTREAM_KEYS:
        if key not in entry["reduced"]:
            assert getattr(run, key) == getattr(upstream, key), key


def _configuration(name: str):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == name)
    return entry, json.loads((ROOT / entry["file"]).read_text())


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_configuration_lists_every_departure_from_its_source(config):
    check_configuration(*_configuration(config))


@pytest.mark.parametrize("edit", ["function_tol", "solver.smooth_iters", "unlisted"])
def test_an_edited_configuration_fails_the_check(edit):
    """schwinger128 with one field changed from its profile, or with a
    departure from upstream taken out of ``reduced``, is refused."""
    entry, data = _configuration("schwinger128")
    entry, tc = dict(entry), data["trace_config"]
    if edit == "function_tol":
        tc["function_tol"] = 1e-3
    elif edit == "solver.smooth_iters":
        tc["solver"]["smooth_iters"] = 8
    else:
        entry["reduced"] = [k for k in entry["reduced"] if k != "nr_deflat_vctrs"]
        data["reduced"] = list(entry["reduced"])
        del data["departures"]["nr_deflat_vctrs"]
    with pytest.raises(AssertionError):
        check_configuration(entry, data)


def test_gauge_copy_matches_the_program_generator():
    import numpy as np

    import gauge
    from deflatedmlmc_schwinger_tpu_torch.io.gauge import sample_links, stencil_from_links

    op = dict(nx=12, nt=10, beta=5.0, field_seed=11, mass=-0.17)
    tt, tx = sample_links(12, 10, 5.0, 11)
    assert np.array_equal(gauge.coefficients(op), stencil_from_links(tt, tx, -0.17))
