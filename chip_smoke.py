#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Builds the stencil kernels from deflatedmlmc_schwinger_tpu_torch/csrc
   with nvcc (sm_90a) and prints the build time.
2. Holds each kernel (K1 stencil_matvec, K2 stencil_residual, K3
   stencil_poly_smooth with and without the residual) to its plain PyTorch
   version on the card: at the G301 shapes (64 probes, 256^2, complex64) to
   1e-5 relative, and on a small non-square complex128 lattice to 1e-12;
   then at the G102 shapes (128 probes, 128^2, complex64, K3 with the
   depth-16 sampling and depth-4 setup roots) to 1e-5. Times each kernel
   and its plain version with CUDA events.
3. Runs gateway.G301 (deflated Hutchinson, generated 256^2 lattice) on
   cuda:0 to its stopping rule, checks that every kernel was launched on
   that path, that no more probe rows stalled than the configuration
   allows, and that the trace lies within G301's own trace_tol (1%) of the
   JAX package's recorded G301 estimate, 28640.7.
4. Runs the 128^2 flagship profile (set_params("schwinger128"), unchanged
   but for the operator: a generated 128^2 lattice, FLAGSHIP_MATRIX at
   FLAGSHIP_MASS, since schwinger128.mat is not in the repository) through
   EXAMPLE_001 (the G102 path: k = 128 gamma3 deflation, displaced trace)
   and EXAMPLE_002 (the G202 path: deflated MG-MLMC, level 1 skipped, level
   2 dense-exact). Each path must launch every kernel, keep its stalled
   rows (deflation-correction solves included) within max_stalled_frac,
   and have k finite deflation eigenvalues.
5. Computes the exact displaced trace tr(D^{-1} Pi^T) of the same operator
   in complex128 on the card (dense LU, column blocks) and checks that both
   estimates lie within 5 of their own reported standard errors of it.
6. Prints the card's name and power limit, a JSON line with the kernels'
   numbers (launches per path), and as the last line
   {"ok": true, "device": {...}}.

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
# the operator of the 128^2 flagship paths (PERF.md, section 4: why this mass)
FLAGSHIP_MATRIX = "generated:128x128:beta=5.0:seed=11"
FLAGSHIP_MASS = -0.17
ORACLE_SIGMAS = 5.0
KERNEL_SOURCE = "deflatedmlmc_schwinger_tpu_torch/csrc/stencil.cu"
REPLACES = {
    "stencil_matvec": "deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py:86",
    "stencil_residual": "deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py:93",
    "stencil_poly_smooth": "deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py:102",
}


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


def _cases(sk, roots_by_depth):
    """(name, kernel, plain version) for K1, K2 and K3 at each root depth,
    with and without the residual."""
    cases = [
        ("stencil_matvec",
         lambda C_, a, b, X, T: sk.stencil_matvec(C_, a, X, T),
         lambda C_, a, b, X, T: sk.stencil_matvec_plain(C_, a, X, T)),
        ("stencil_residual",
         lambda C_, a, b, X, T: sk.stencil_residual(C_, a, b, X, T),
         lambda C_, a, b, X, T: sk.stencil_residual_plain(C_, a, b, X, T)),
    ]
    for depth, roots in roots_by_depth.items():
        cases += [
            (f"stencil_poly_smooth depth {depth}",
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth(
                 C_, a, r, X, T, with_residual=True),
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth_plain(
                 C_, a, r, X, T, with_residual=True)),
            (f"stencil_poly_smooth depth {depth} (no residual)",
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth(C_, a, r, X, T)[0],
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth_plain(C_, a, r, X, T)[0]),
        ]
    return cases


def _check(label, cases, C, v, w, nx, nt, small=None) -> dict:
    """Each case against its plain version (c64 to TOL_C64; on ``small`` =
    (C, v, w, nx, nt) in c128 to TOL_C128), timed with CUDA events.
    Returns {case name: (max abs err, rel err, kernel ms, plain ms)}."""
    import torch

    out = {}
    for name, kern, plain in cases:
        got = _flat(kern(C, v, w, nx, nt))
        ref = _flat(plain(C, v, w, nx, nt))
        torch.cuda.synchronize()
        err64 = _rel_err(got, ref)
        abs64 = float((got - ref).abs().max())
        msg = f"[kernels {label}] {name}: c64 rel err {err64:.3e} (abs {abs64:.3e})"
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{label} {name}: non-finite output")
        if err64 > TOL_C64:
            raise RuntimeError(f"{label} {name}: kernel disagrees with its plain version "
                               f"(c64 rel {err64:.3e} > {TOL_C64:g})")
        if small is not None:
            sC, sv, sw, snx, snt = small
            sgot = _flat(kern(sC, sv, sw, snx, snt))
            sref = _flat(plain(sC, sv, sw, snx, snt))
            torch.cuda.synchronize()
            err128 = _rel_err(sgot, sref)
            if not torch.isfinite(sgot).all() or err128 > TOL_C128:
                raise RuntimeError(f"{label} {name}: c128 rel {err128:.3e} > {TOL_C128:g}")
            msg += f", c128 24x40 rel err {err128:.3e}"
        ms = _time_ms(lambda: kern(C, v, w, nx, nt))
        plain_ms = _time_ms(lambda: plain(C, v, w, nx, nt))
        print(f"{msg}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out[name] = (abs64, err64, ms, plain_ms)
    return out


def _roots(op, depth: int):
    from deflatedmlmc_schwinger_tpu_torch.io import csr_from_stencil
    from deflatedmlmc_schwinger_tpu_torch.mg.host_setup import _poly_roots_host

    return _poly_roots_host(csr_from_stencil(op.host_coeffs().astype("complex128")), depth)


def check_kernels(device) -> dict:
    """Phase 2: every kernel against its plain version at the G301 shapes
    (and on a small c128 lattice) and at the G102 shapes."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params
    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator(device=device).manual_seed(1234)
    results = {}
    sop, _ = load_operator("generated:24x40:beta=3.0:seed=5", -0.2,
                           dtype=torch.complex128, device=device)
    small = (sop.coeffs, _randn((3, sop.n), torch.complex128, gen, device),
             _randn((3, sop.n), torch.complex128, gen, device), sop.nx, sop.nt)
    for label, cfg in (("G301", set_params("schwinger256")), ("G102", flagship_cfg())):
        op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                              dtype=torch.complex64, device=device)
        depths = {cfg.solver.smooth_iters}
        if cfg.defl_solver is not None:
            depths.add(cfg.defl_solver.smooth_iters)
        roots = {dp: _roots(op, dp) for dp in sorted(depths, reverse=True)}
        v = _randn((cfg.probe_batch, op.n), torch.complex64, gen, device)
        w = _randn((cfg.probe_batch, op.n), torch.complex64, gen, device)
        results[label] = _check(label, _cases(sk, roots), op.coeffs, v, w, op.nx, op.nt,
                                small if label == "G301" else None)
        del op, v, w
    return results


def flagship_cfg():
    """The JAX package's schwinger128 profile, field for field, on the
    generated flagship operator."""
    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params

    return set_params("schwinger128").replace(matrix=FLAGSHIP_MATRIX, mass=FLAGSHIP_MASS)


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


def run_flagship(label: str, device):
    """Phase 4: one 128^2 flagship path through its example entry; returns
    (result, kernel launches of that run, wall seconds)."""
    import math

    from deflatedmlmc_schwinger_tpu_torch import examples
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    cfg = flagship_cfg()
    entry = examples.EXAMPLE_001 if label == "G102" else examples.EXAMPLE_002
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    result = entry(cfg, device=device)
    wall = time.perf_counter() - t0
    counts = sk.launch_counts()
    phases = dict(result["timer"].totals)
    tr = complex(result["trace"])
    k = int(cfg.nr_deflat_vctrs)
    Br = max(cfg.nr_rough_iters, cfg.probe_batch)
    if label == "G102":
        stderr = result["std_dev"] / math.sqrt(result["nr_ests"])
        solved = result["nr_ests"] + Br + k
        print(f"[{label}] nr_ests {result['nr_ests']} function_iters "
              f"{result['function_iters']} probe solves/s in sampling "
              f"{result['nr_ests'] / phases['sampling']:.1f}")
    else:
        stderr = result["std_dev"]
        sampled = [r["nr_ests"] for r in result["results"][:-1] if r["ests_dev"] > 0]
        solved = sum(sampled) + Br + 2 * k
        for i, r in enumerate(result["results"]):
            print(f"[{label}] level {i}: nr_ests {r['nr_ests']} function_iters "
                  f"{r['function_iters']} trace {complex(r['ests_avg']):.6f} "
                  f"dev {r['ests_dev']:.6g}")
    stalled = result["stalled_rows"] + result["defl_stalled_rows"]
    defl = result["deflation"]
    good = int(sum(abs(rs) <= 0.5 * abs(th) for th, rs in zip(defl.values, defl.resnorms)))
    print(f"[{label}] trace {tr} stderr {stderr:.6g} (rel {stderr / abs(tr):.3e}) "
          f"stalled_rows {result['stalled_rows']} + {result['defl_stalled_rows']} "
          f"(deflation corrections) of {solved} wall {wall:.3f} s")
    print(f"[{label}] deflation: {len(defl.values)} eigenvalues, {good} with "
          f"res <= 0.5|theta|, |theta| in [{min(abs(defl.values)):.4g}, "
          f"{max(abs(defl.values)):.4g}], tr1 {defl.tr1:.6f}")
    print(f"[{label}] phase seconds " + " ".join(f"{n}={t:.4f}" for n, t in phases.items()))
    print(f"[{label}] kernel launches {counts}")
    if not all(math.isfinite(x) for x in (tr.real, tr.imag, stderr)):
        raise RuntimeError(f"{label} produced a non-finite result")
    if len(defl.values) != k or not all(math.isfinite(x) for x in defl.values):
        raise RuntimeError(f"{label}: the deflation basis has no {k} finite eigenvalues")
    missing = [n for n, c in counts.items() if c <= 0]
    if missing:
        raise RuntimeError(f"{label} did not launch {missing}")
    if stalled > cfg.max_stalled_frac * solved:
        raise RuntimeError(f"{label}: {stalled} stalled rows of {solved}")
    return result, counts, wall, stderr


def dense_displaced_trace(device):
    """Phase 5: the exact tr(D^{-1} Pi^T) = sum_j (D^{-1})[(j - d) % N, j] of
    the flagship operator, in complex128 on the card: D assembled column by
    column through the plain stencil, one LU factorization, then lu_solve
    over blocks of unit vectors. Independent of the estimators' solvers."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    cfg = flagship_cfg()
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=torch.complex128, device=device)
    n = op.n
    block = 2048                      # unit vectors per solve (1 GB each)
    d = 2 * cfg.nt * cfg.x_displacement if cfg.use_permuted else 0
    ar = torch.arange(block, device=device)
    Dt = torch.empty((n, n), dtype=torch.complex128, device=device)  # row j = D e_j
    for j0 in range(0, n, block):
        E = torch.zeros((block, n), dtype=torch.complex128, device=device)
        E[ar, j0 + ar] = 1
        Dt[j0:j0 + block] = sk.stencil_matvec_plain(op.coeffs, E, op.nx, op.nt)
    LU, piv = torch.linalg.lu_factor(Dt.mT)
    del Dt
    tr = torch.zeros((), dtype=torch.complex128, device=device)
    for j0 in range(0, n, block):
        E = torch.zeros((n, block), dtype=torch.complex128, device=device)
        E[j0 + ar, ar] = 1
        X = torch.linalg.lu_solve(LU, piv, E)            # columns D^{-1} e_j
        tr = tr + X[(j0 + ar - d) % n, ar].sum()
    value = complex(tr.item())
    del LU, piv, E, X
    torch.cuda.empty_cache()
    return value


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

    kernels = check_kernels(device)
    counts = {"G301": run_g301(device)}
    flagship = {}
    for label in ("G102", "G202"):
        result, counts[label], wall, stderr = run_flagship(label, device)
        flagship[label] = (complex(result["trace"]), stderr)
        del result
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exact = dense_displaced_trace(device)
    print(f"[oracle] dense tr(D^-1 Pi^T) = {exact} in {time.perf_counter() - t0:.3f} s "
          f"(complex128 LU on the card)")
    for label, (tr, stderr) in flagship.items():
        err = abs(tr - exact)
        print(f"[oracle] {label}: |trace - exact| = {err:.6g} = {err / stderr:.3f} stderr, "
              f"realized relative error {err / abs(exact):.3e}")
        if err > ORACLE_SIGMAS * stderr:
            raise RuntimeError(f"{label} trace {tr} is {err / stderr:.2f} stderr from the "
                               f"exact {exact}")

    entries = []
    for name, replaces in REPLACES.items():
        key = name if name != "stencil_poly_smooth" else f"{name} depth 16"
        abs_err, _, ms, plain_ms = kernels["G102"][key]
        g301_key = name if name != "stencil_poly_smooth" else f"{name} depth 4"
        g_abs, _, g_ms, g_plain = kernels["G301"][g301_key]
        per_path = {p: c[name] for p, c in counts.items()}
        entries.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE, replaces=replaces,
            launches=sum(per_path.values()), launches_per_path=per_path,
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, shapes="G102",
            g301_shapes=dict(max_abs_err=g_abs, ms=g_ms, plain_ms=g_plain)))

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
