"""``correct`` on the CPU at a size a test run holds: a sound run of each
cell is correct; the control (the reference in the program's place, one
precision down) is not; and neither is a run whose timed path is broken
underneath: a step that hands back the previous batch's estimates, half
of a batch left out with the mean of the rest in its place, and a solution
altered where the solver produces it, and a solution altered on one row
that the solver flags as stalled. (One card: no exchange between chips to
leave out.)"""

from __future__ import annotations

import json
import time

import pytest
import torch

import core
import gauge
import reference
from conftest import ROOT, small_spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(spec, tmp_path, seed=12345678901):
    torch.set_num_threads(2)
    return core.run_cell(spec, seed, 1.0, False, "cpu", time.perf_counter(), str(tmp_path),
                         log=lambda *a: None)


def _failed(r):
    return [k for k, c in r["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path):
    r = _run(small_spec(cell), tmp_path)
    assert r["correct"], r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["metrics"]) == {"samples_per_s", "sampling_s_to_1pct", "setup_s"}
    assert r["attempted"] > 0 and r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tmp_path, monkeypatch):
    spec = small_spec(cell)
    C = gauge.coefficients(spec["config"]["operator"])
    judge = reference.judge

    def control_judge(ref, outputs, names):
        ctrl = reference.Control(C, ref.state).outputs(outputs["Z"])
        return judge(ref, ctrl, names)

    monkeypatch.setattr(reference, "judge", control_judge)
    r = _run(spec, tmp_path)
    assert not r["correct"] and _failed(r)


def _patch_step(monkeypatch, cell, broken):
    if cell.startswith("mlmc"):
        import estimators.mlmc as mod
        name = "mlmc_step_batch"
    else:
        import estimators.hutchinson as mod
        name = "hutchinson_step_batch"
    monkeypatch.setattr(mod, name, broken(getattr(mod, name)))


def _stale(step):
    last = {}

    def broken(*args, **kw):
        out = step(*args, **kw)
        if kw.get("gather", True):
            return out                    # set-up's rough trace, not the window
        prev = last.get("out", out)
        last["out"] = out
        return (prev[0],) + tuple(out[1:])
    return broken


def _half(step):
    def broken(*args, **kw):
        if kw.get("gather", True):
            return step(*args, **kw)      # set-up's rough trace, not the window
        args = list(args)
        i = next(j for j, a in enumerate(args) if isinstance(a, torch.Tensor) and a.dim() == 2)
        probes = args[i]
        h = probes.shape[0] // 2
        args[i] = probes[:h]
        out = step(*args, **kw)
        e = torch.cat([out[0], out[0].mean().expand(probes.shape[0] - h)])
        rest = [torch.cat([t, t[:1].expand(probes.shape[0] - h)])
                if isinstance(t, torch.Tensor) and t.dim() == 1 else t for t in out[1:]]
        return (e, *rest)
    return broken


def _stall_one_row_in_the_window(monkeypatch):
    """From the window on, the first row of every solve is flagged as
    stalled, with its solution off by 2e-3: one row in 32, under the
    configuration's max_stalled_frac, so the program itself carries on."""
    import window
    from deflatedmlmc_schwinger_tpu_torch.mg import cycle

    fgmres, run = cycle.fgmres, window.Window.run

    def stalled(*args, **kw):
        res = fgmres(*args, **kw)
        x, flags = res.x.clone(), res.stalled.clone()
        x[0] *= 1 + 2e-3
        flags[0] = True
        return res._replace(x=x, stalled=flags)

    def run_stalled(self, *args, **kw):
        monkeypatch.setattr(cycle, "fgmres", stalled)
        return run(self, *args, **kw)
    monkeypatch.setattr(window.Window, "run", run_stalled)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered", "stalled"])
def test_broken_timed_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    if fault == "stale":
        _patch_step(monkeypatch, cell, _stale)
    elif fault == "half":
        _patch_step(monkeypatch, cell, _half)
    elif fault == "altered":
        from deflatedmlmc_schwinger_tpu_torch.mg import cycle

        fgmres = cycle.fgmres

        def altered(*args, **kw):
            res = fgmres(*args, **kw)
            return res._replace(x=res.x * (1 + 2e-3))
        monkeypatch.setattr(cycle, "fgmres", altered)
    else:
        _stall_one_row_in_the_window(monkeypatch)
        r = _run(small_spec(cell, probe_batch=32), tmp_path)
        assert r["failed"] > 0 and not r["correct"], r["checks"]
        return
    r = _run(small_spec(cell), tmp_path)
    assert not r["correct"], r["checks"]
