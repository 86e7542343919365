"""Where the time goes on the 512^2 path (G302) and on the 16^2 path (G101):
the host setup's costliest functions, then sampling batches timed plainly
and under torch.profiler (device-busy share, device operations per batch,
device time by kernel).

    python bench_torch/path_busy.py

G302 is ``set_params("schwinger512")`` unchanged (16 probes per batch); G101
is the 16^2 profile as chip_smoke.py runs it (generated operator, complex128,
GMRES smoother, k = 64 deflation, 8 probes per batch). Each path: hierarchy
(under cProfile) and deflation, 3 warm-up batches, 5 timed, 5 profiled.
"""

from __future__ import annotations

import cProfile
import pstats
import subprocess
import sys
import time
from pathlib import Path

import torch

from g102_batch import report_profile

WARMUP, BATCHES = 3, 5


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("path_busy: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls
    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params
    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, setup_hierarchy
    from deflatedmlmc_schwinger_tpu_torch.trace.deflation import hutchinson_deflation
    from deflatedmlmc_schwinger_tpu_torch.trace.hutchinson import hutchinson_step_batch
    from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    pin_full_precision_matmuls()
    device = torch.device("cuda:0")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, cfg in (("G302", set_params("schwinger512")), ("G101", cs.small_cfg())):
        op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                              dtype=cfg.complex_dtype(), device=device)
        pr = cProfile.Profile()
        t0 = time.perf_counter()
        hier = pr.runcall(setup_hierarchy, op, cfg)
        torch.cuda.synchronize()
        print(f"[{label}] mg_setup {time.perf_counter() - t0:.3f} s under cProfile; "
              f"costliest functions by their own time:")
        stats = pstats.Stats(pr)
        rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
        for (fname, line, func), (_, calls, own, cum, _) in rows:
            print(f"[{label}]   {own:.3f} s own, {cum:.3f} s with callees, {calls} calls: "
                  f"{Path(fname).name}:{line} {func}")
        solver = MGSolver(hier, cfg.solver)
        t0 = time.perf_counter()
        defl = hutchinson_deflation(op, solver, cfg)
        torch.cuda.synchronize()
        print(f"[{label}] deflation (k = {cfg.nr_deflat_vctrs}) {time.perf_counter() - t0:.3f} s")
        probes = make_probe_source("torch", cfg.seed, device)
        B = int(cfg.probe_batch)

        def batches(first: int, count: int) -> int:
            iters = 0
            for i in range(first, first + count):
                _, it, _ = hutchinson_step_batch(
                    op, solver, cfg, defl, probes(i * B, B, op.n, op.dtype), gather=False)
                iters += int(it.max())
            torch.cuda.synchronize()
            return iters

        batches(0, WARMUP)
        t = time.perf_counter()
        iters = batches(WARMUP, BATCHES)
        dt = time.perf_counter() - t
        print(f"[{label}] {1e3 * dt / BATCHES:.2f} ms per batch of {B}, "
              f"{B * BATCHES / dt:.1f} probe solves/s, {iters} outer iterations "
              f"(sum of the batches' maxima)")
        with torch.profiler.profile(activities=activities):
            batches(0, 1)               # the profiler's own first-use cost
        with torch.profiler.profile(activities=activities) as prof:
            t = time.perf_counter()
            batches(WARMUP, BATCHES)
            wall = time.perf_counter() - t
        report_profile(label, prof, wall, BATCHES)
        del op, hier, solver, defl
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
