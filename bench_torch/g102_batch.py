"""One G102 sampling batch on the card, with the tiled K3 and with the
per-root K3 in the same process: milliseconds per batch, probe solves per
second, and the split of device time by kernel under torch.profiler.

    python bench_torch/g102_batch.py

Sets up the 128^2 flagship profile as chip_smoke.py runs it (hierarchy,
k = 128 deflation basis), then solves batches of 128 deflated probes the way
hutchinson's sampling loop does. The two K3 versions take turns (per-root,
tiled, tiled, per-root; 3 warm-up and 10 timed batches each, the same
probes), then 10 batches of each run under the profiler.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

WARMUP, BATCHES = 3, 10
GROUPS = (  # (label, substrings of the kernel's name), first match wins
    ("K3 tiled", ("poly_tiled",)),
    ("K3 per root", ("poly_step",)),
    ("K1 + K2", ("stencil_matvec", "stencil_residual")),
    ("GEMM", ("gemm", "cutlass", "gemv", "cublas")),
    ("gather (index)", ("index",)),
    ("copy", ("copy", "memcpy", "Memcpy")),
    ("elementwise and reductions", ("elementwise", "reduce", "vectorized")),
)


def report_profile(label: str, prof, wall: float, batches: int) -> None:
    """Print what a torch.profiler run over ``batches`` batches (``wall``
    seconds on the host) recorded on the device: busy time per batch, its
    share of the wall, device operations per batch, and the split by GROUPS."""
    by_group, total, launches, other = defaultdict(float), 0.0, 0, []
    for ev in prof.key_averages():
        # device-side events only: a host operator's entry repeats the
        # time of the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us <= 0:
            continue
        total += dev_us
        launches += ev.count
        group = next((g for g, keys in GROUPS if any(k in ev.key for k in keys)), "other")
        by_group[group] += dev_us
        if group == "other":
            other.append((dev_us, ev.key))
    print(f"[profile] {label}: {1e3 * wall / batches:.2f} ms per batch under the profiler, "
          f"device busy {1e-3 * total / batches:.2f} ms per batch "
          f"({total / (1e4 * wall):.1f}% of it), {launches / batches:.0f} device "
          f"operations per batch")
    if total <= 0:
        print("[profile] the profiler recorded no device time")
        return
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}:   {g}: {1e-3 * us / batches:.3f} ms per batch, "
              f"{100 * us / total:.1f}% of device time")
    for us, key in sorted(other, reverse=True)[:6]:
        print(f"[profile] {label}:     other: {key[:90]}: {1e-3 * us / batches:.3f} ms per batch")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("g102_batch: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls
    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, setup_hierarchy
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk
    from deflatedmlmc_schwinger_tpu_torch.trace.deflation import hutchinson_deflation
    from deflatedmlmc_schwinger_tpu_torch.trace.hutchinson import hutchinson_step_batch
    from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    pin_full_precision_matmuls()
    device = torch.device("cuda:0")
    cfg = cs.flagship_cfg()
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=cfg.complex_dtype(), device=device)
    t0 = time.perf_counter()
    solver = MGSolver(setup_hierarchy(op, cfg), cfg.solver)
    defl = hutchinson_deflation(op, solver, cfg)
    torch.cuda.synchronize()
    print(f"setup (hierarchy + k = {cfg.nr_deflat_vctrs} deflation) {time.perf_counter() - t0:.2f} s")
    probes = make_probe_source("torch", cfg.seed, device)
    B = int(cfg.probe_batch)

    tiled = sk.stencil_poly_smooth

    def per_root(coeffs, r, roots, nx, nt, *, with_residual=False):
        return sk.stencil_poly_smooth_per_root(coeffs, r, roots, nx, nt,
                                               with_residual=with_residual)

    def batches(first: int, count: int) -> int:
        iters = 0
        for i in range(first, first + count):
            _, it, _ = hutchinson_step_batch(op, solver, cfg, defl,
                                             probes(i * B, B, op.n, op.dtype), gather=False)
            iters += int(it.max())
        torch.cuda.synchronize()
        return iters

    def timed(label: str, fn) -> None:
        sk.stencil_poly_smooth = fn
        sk.reset_launch_counts()
        batches(0, WARMUP)
        t = time.perf_counter()
        iters = batches(WARMUP, BATCHES)
        dt = time.perf_counter() - t
        print(f"[batch] {label}: {1e3 * dt / BATCHES:.2f} ms per batch of {B}, "
              f"{B * BATCHES / dt:.1f} probe solves/s, {iters} outer iterations "
              f"(sum of the batches' maxima), launches {sk.launch_counts()} "
              f"per-root K3 {sk.stencil_poly_smooth_per_root.launches}")

    for label, fn in (("per-root K3", per_root), ("tiled K3", tiled),
                      ("tiled K3 again", tiled), ("per-root K3 again", per_root)):
        timed(label, fn)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        batches(0, 1)               # the profiler's own first-use cost
    for label, fn in (("tiled K3", tiled), ("per-root K3", per_root)):
        sk.stencil_poly_smooth = fn
        batches(0, WARMUP)
        with torch.profiler.profile(activities=activities) as prof:
            t = time.perf_counter()
            batches(WARMUP, BATCHES)
            wall = time.perf_counter() - t
        report_profile(label, prof, wall, BATCHES)
    sk.stencil_poly_smooth = tiled


if __name__ == "__main__":
    main()
