#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Builds the stencil kernels from deflatedmlmc_schwinger_tpu_torch/csrc
   with nvcc (sm_90a) and prints the build time.
2. Holds each kernel (K1 stencil_matvec, K2 stencil_residual, K3
   stencil_poly_smooth with and without the residual) to its plain PyTorch
   version on the card: at the G301 shapes (64 probes, 256^2, complex64) to
   1e-5 relative, and on a small non-square complex128 lattice to 1e-12.
   Times each kernel and its plain version with CUDA events.
3. Runs gateway.G301 (deflated Hutchinson, generated 256^2 lattice) on
   cuda:0 to its stopping rule, checks that every kernel was launched on
   that path, that no more probe rows stalled than the configuration
   allows, and that the trace lies within G301's own trace_tol (1%) of the
   JAX package's recorded G301 estimate, 28640.7.
4. Prints the card's name and power limit, a JSON line with the kernels'
   numbers, and as the last line {"ok": true, "device": {...}}.

Any failure raises, so the script exits non-zero and prints no result line.
It needs a CUDA card, nvcc and the rest of this repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REFERENCE_TRACE = 28640.7   # the JAX package's recorded G301 estimate
TOL_C64 = 1e-5
TOL_C128 = 1e-12
REPS = 50


def _rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _flat(out):
    """One tensor from a kernel's output (K3 with residual returns two)."""
    import torch

    return torch.cat(out) if isinstance(out, tuple) else out


def _time_ms(fn, reps: int = REPS) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _randn(shape, dtype, gen, device):
    import torch

    return torch.randn(shape, dtype=dtype, generator=gen, device=device)


def check_kernels(device) -> list:
    """Phase 2: every kernel against its plain version; returns the
    kernels' JSON entries (without launch counts)."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params
    from deflatedmlmc_schwinger_tpu_torch.io import csr_from_stencil, load_operator
    from deflatedmlmc_schwinger_tpu_torch.mg.host_setup import _poly_roots_host
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    cfg = set_params("schwinger256")
    op, _ = load_operator(cfg.matrix, cfg.mass, dtype=torch.complex64, device=device)
    C, nx, nt = op.coeffs, op.nx, op.nt
    roots = _poly_roots_host(csr_from_stencil(op.host_coeffs().astype("complex128")),
                             cfg.solver.smooth_iters)
    gen = torch.Generator(device=device).manual_seed(1234)
    B = cfg.probe_batch
    v = _randn((B, op.n), torch.complex64, gen, device)
    w = _randn((B, op.n), torch.complex64, gen, device)

    # small non-square complex128 lattice
    sop, _ = load_operator("generated:24x40:beta=3.0:seed=5", -0.2,
                           dtype=torch.complex128, device=device)
    sv = _randn((3, sop.n), torch.complex128, gen, device)
    sw = _randn((3, sop.n), torch.complex128, gen, device)
    sC = sop.coeffs

    cases = [
        ("stencil_matvec", "deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py:86",
         lambda C_, a, b, X, T: sk.stencil_matvec(C_, a, X, T),
         lambda C_, a, b, X, T: sk.stencil_matvec_plain(C_, a, X, T)),
        ("stencil_residual", "deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py:93",
         lambda C_, a, b, X, T: sk.stencil_residual(C_, a, b, X, T),
         lambda C_, a, b, X, T: sk.stencil_residual_plain(C_, a, b, X, T)),
        ("stencil_poly_smooth", "deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py:102",
         lambda C_, a, b, X, T: sk.stencil_poly_smooth(C_, a, roots, X, T,
                                                       with_residual=True),
         lambda C_, a, b, X, T: sk.stencil_poly_smooth_plain(C_, a, roots, X, T,
                                                             with_residual=True)),
        ("stencil_poly_smooth (no residual)", None,
         lambda C_, a, b, X, T: sk.stencil_poly_smooth(C_, a, roots, X, T)[0],
         lambda C_, a, b, X, T: sk.stencil_poly_smooth_plain(C_, a, roots, X, T)[0]),
    ]
    entries = []
    for name, replaces, kern, plain in cases:
        got = _flat(kern(C, v, w, nx, nt))
        ref = _flat(plain(C, v, w, nx, nt))
        torch.cuda.synchronize()
        err64 = _rel_err(got, ref)
        abs64 = float((got - ref).abs().max())
        sgot = _flat(kern(sC, sv, sw, sop.nx, sop.nt))
        sref = _flat(plain(sC, sv, sw, sop.nx, sop.nt))
        torch.cuda.synchronize()
        err128 = _rel_err(sgot, sref)
        if not (torch.isfinite(got).all() and torch.isfinite(sgot).all()):
            raise RuntimeError(f"{name}: non-finite output")
        if err64 > TOL_C64 or err128 > TOL_C128:
            raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                               f"(c64 rel {err64:.3e} > {TOL_C64:g} or "
                               f"c128 rel {err128:.3e} > {TOL_C128:g})")
        ms = _time_ms(lambda: kern(C, v, w, nx, nt))
        plain_ms = _time_ms(lambda: plain(C, v, w, nx, nt))
        print(f"[kernels] {name}: c64 G301 shapes rel err {err64:.3e} (abs {abs64:.3e}), "
              f"c128 24x40 rel err {err128:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if replaces is not None:
            entries.append(dict(name=name, route="cuda",
                                source="deflatedmlmc_schwinger_tpu_torch/csrc/stencil.cu",
                                replaces=replaces, launches=0, max_abs_err=abs64,
                                ms=ms, plain_ms=plain_ms))
    return entries


def run_g301(device) -> dict:
    """Phase 3: the port's main path through its gateway entry."""
    import math

    from deflatedmlmc_schwinger_tpu_torch import gateway
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    cfg = gateway.set_params("schwinger256")
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    result = gateway.G301(device=device)
    wall = time.perf_counter() - t0
    counts = sk.launch_counts()
    phases = dict(result["timer"].totals)
    tr = complex(result["trace"])
    stderr = result["std_dev"] / math.sqrt(result["nr_ests"])
    print(f"[G301] trace {tr} stderr {stderr:.6g} (rel {stderr / abs(tr):.3e}) "
          f"nr_ests {result['nr_ests']} function_iters {result['function_iters']} "
          f"stalled_rows {result['stalled_rows']} wall {wall:.3f} s")
    print("[G301] phase seconds " + " ".join(
        f"{k}={phases.get(k, 0.0):.4f}" for k in ("mg_setup", "defl_setup",
                                                   "rough_trace", "sampling")))
    print(f"[G301] kernel launches {counts}")
    if not all(math.isfinite(x) for x in (tr.real, tr.imag, stderr)):
        raise RuntimeError("G301 produced a non-finite result")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise RuntimeError(f"G301 did not launch {missing}")
    solved = result["nr_ests"] + max(cfg.nr_rough_iters, cfg.probe_batch)
    if result["stalled_rows"] > cfg.max_stalled_frac * solved:
        raise RuntimeError(f"{result['stalled_rows']} stalled rows of {solved}")
    if abs(tr - REFERENCE_TRACE) > cfg.trace_tol * REFERENCE_TRACE:
        raise RuntimeError(f"G301 trace {tr} is not within {cfg.trace_tol:.0%} "
                           f"of {REFERENCE_TRACE}")
    return counts


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    pin_full_precision_matmuls()
    device = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cached = sk.library_path().exists()
    sk.load_library()
    print(f"[build] {sk.library_path()} in {time.perf_counter() - t0:.2f} s"
          f"{' (already built)' if cached else ''}")

    entries = check_kernels(device)
    counts = run_g301(device)
    for e in entries:
        e["launches"] = counts[e["name"]]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
