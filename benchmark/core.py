"""One run of one cell: set-up, warm-up, the timed window, the traced
stretch (``--trace 1``), the reference's check, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
BENCHMARK.json gives it:
    benchmark/configs/<config>.json    the configuration as it is run
    benchmark/traffic/<traffic>.json   estimator, level, batch, warm-up,
                                       traced and checked batches
    benchmark/cells/<cell>.json        the limit of each number compared
    benchmark/metrics/<metric>.py      one reader per per-layer metric
    benchmark/estimators/<name>.py     one set-up per estimator
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

import devtrace
import gauge
import reference
import stats
from window import Window

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def trace_config(d: dict):
    """The program's TraceConfig from a configuration file's fields."""
    from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig, TraceConfig

    kw = {}
    fields = {f.name: f for f in dataclasses.fields(TraceConfig)}
    for k, v in d.items():
        if k not in fields:
            raise ValueError(f"unknown TraceConfig field {k!r}")
        if k == "dtype":
            v = getattr(torch, v)
        elif k in ("solver", "defl_solver") and v is not None:
            v = SolverConfig(**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return TraceConfig(**kw)


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, traffic,
    limits and the per-layer metrics that it reports."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in manifest["end_to_end"]
                  if name in m.get("workloads", [name])]
    return dict(cell=cell,
                config=load_json(root / configs[cell["config"]]["file"]),
                traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
                limits=load_json(HERE / "cells" / f"{name}.json")["limits"],
                per_layer=per_layer, end_to_end=end_to_end)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, trace_dir: str, log=print) -> dict:
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk
    from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator
    from deflatedmlmc_schwinger_tpu_torch.utils.timer import PhaseTimer

    device = torch.device(device)
    cuda = device.type == "cuda"
    traffic, config = spec["traffic"], spec["config"]
    if cuda:
        torch.empty(0, device=device)     # the caching allocator, before its statistics
        torch.cuda.reset_peak_memory_stats(device)
        sk.load_library()
    cfg = trace_config(config["trace_config"]).replace(probe_batch=int(traffic["probe_batch"]))
    C = gauge.coefficients(config["operator"])
    op = StencilOperator.from_numpy(C, device=device, dtype=cfg.dtype)
    timer = PhaseTimer(device)
    est_mod = importlib.import_module(f"estimators.{traffic['estimator']}")
    est = est_mod.setup(op, cfg, traffic, int(seed), timer)
    win = Window(est, cfg, device)
    t_batch = win.warm_up(int(traffic["warmup_batches"]))
    nchk = int(traffic["check_batches"])
    win.choose_checked(nchk, int(seed), seconds, t_batch)
    setup_s = time.perf_counter() - t_start

    win.run(seconds, t_batch)
    batch_s = win.batch_seconds()
    es, batch_iters, iters_total, stalled = win.host_arrays()
    N = int(es.size)
    rate = N / win.seconds
    variance = stats.population_variance(es)
    trace_est = est.trace_estimate(complex(es.mean()))
    trace_abs = abs(trace_est)
    target = stats.stop_target(cfg.stop_safety, cfg.trace_tol, trace_abs, est.tol_factor())
    window = dict(samples=N, seconds=win.seconds, batch_s=batch_s, batch_iters=batch_iters,
                  iters_total=iters_total, stalled=stalled, variance=variance,
                  trace_abs=trace_abs, target=target, samples_per_s=rate)
    log(f"[window] {N} samples in {win.seconds:.3f} s, {len(batch_s)} batches, "
        f"trace {trace_est:.6f}, dev^2 {variance:.6g}, "
        f"target {target:.6g}, stalled {stalled}")

    checked, outputs = checked_outputs(win, es)

    stretch = None
    if trace:
        stretch = traced_stretch(win, sk, int(traffic["trace_batches"]), trace_dir)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    state = est.reference_state()
    phases = dict(timer.totals)
    del win, est, op
    if cuda:
        torch.cuda.empty_cache()

    outputs.update(Z=reference.probe_rows(seed, outputs["samples"], outputs["X"].shape[1],
                                          device),
                   tr1=state["tr1"])
    got = (reference.judge(reference.Reference(C, state), outputs, list(spec["limits"]))
           if len(checked) == nchk else {k: float("inf") for k in spec["limits"]})
    checks = {k: dict(value=got[k], limit=float(spec["limits"][k])) for k in spec["limits"]}
    correct = len(checked) == nchk and all(c["value"] <= c["limit"] for c in checks.values())

    ctx = dict(window=window, phases=phases, trace=stretch)
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        e2e = dict(samples_per_s=rate,
                   sampling_s_to_1pct=stats.sampling_s_to_target(variance, target, rate),
                   setup_s=setup_s)
        metrics = {m["name"]: dict(value=float(e2e[m["name"]]), unit=m["unit"])
                   for m in spec["end_to_end"]}
    dev = dict(platform="gpu" if cuda else device.type,
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1, memory_peak_bytes=peak)
    result = dict(correct=bool(correct), attempted=N, failed=stalled, metrics=metrics,
                  device=dev)
    if trace and stretch:
        dev["busy_s"] = stretch["busy_s"]
        dev["window_s"] = stretch["window_s"]
        result["breakdown"] = dict(device_ops=devtrace.top(stretch["by_name"]),
                                   idle_gaps=devtrace.top(stretch["idle_by"]))
    result["checks"] = checks
    return result


def checked_outputs(win: Window, es: np.ndarray):
    """(the checked batch indices, their outputs on the host: sample
    indices, solutions X, estimates e), from the window's kept solutions
    and its estimates ``es`` in batch order."""
    pos = {s // win.B: i for i, s in enumerate(win.starts)}
    checked = sorted(k for k in win.kept if k in pos)
    if not checked:
        return checked, dict(samples=np.zeros(0, dtype=np.int64), X=np.zeros((0, 1)),
                             e=np.zeros(0))
    return checked, dict(
        samples=np.concatenate([np.arange(k * win.B, (k + 1) * win.B) for k in checked]),
        X=np.concatenate([_rows(win.kept[k], win.B) for k in checked]),
        e=np.concatenate([es[pos[k] * win.B:(pos[k] + 1) * win.B] for k in checked]))


def _rows(x: torch.Tensor, B: int) -> np.ndarray:
    """A kept solution as B complex128 host rows; a row that the solve did
    not return reads as zeros."""
    x = x.cpu().numpy().astype(np.complex128)
    if x.shape[0] < B:
        x = np.concatenate([x, np.zeros((B - x.shape[0], x.shape[1]), x.dtype)])
    return x


def traced_stretch(win: Window, sk, batches: int, trace_dir: str) -> Optional[Dict]:
    """Profile ``batches`` more batches of the window's loop, twice, after
    one profiled batch that takes the profiler's own first-use cost: first
    the device's work alone, with the stencil kernels' calls recorded (busy
    and idle time, device time by kernel, device operations), then with
    the host's operators too, for the labels of the idle gaps (the host
    operators' recording lengthens the gaps). Returns the first reading
    with the second's ``idle_by`` and the first stretch's batches, outer
    iterations and kernel calls."""
    calls: List[tuple] = []
    devtrace.profile_stretch(lambda: win.chunk(1), trace_dir, host=False)
    win.reset()
    with devtrace.recorded_calls(sk, calls):
        read = devtrace.profile_stretch(lambda: win.chunk(batches), trace_dir, host=False)
    if not read:
        return None
    read.update(batches=batches, calls=calls,
                outer_iters=int(sum(int(i.max()) for i in win.iters)))
    labelled = devtrace.profile_stretch(lambda: win.chunk(batches), trace_dir, host=True)
    read["idle_by"] = labelled.get("idle_by", {})
    return read
