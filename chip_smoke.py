#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Builds the stencil kernels from deflatedmlmc_schwinger_tpu_torch/csrc
   with nvcc (sm_90a) and prints the build time.
2. Holds each kernel (K1 stencil_matvec, K2 stencil_residual, K3
   stencil_poly_smooth, the tiled kernel that takes several roots per
   launch, with and without the residual) to its plain PyTorch version on
   the card: at the G301 shapes (64 probes, 256^2, complex64) to 1e-5
   relative, and on a small non-square complex128 lattice to 1e-12; then at
   the G102 shapes (128 probes, 128^2, complex64, K3 with the depth-16
   sampling and depth-4 setup roots) to 1e-5. Times each kernel and its
   plain version with CUDA events, K3 also beside the earlier kernel with
   one launch per root (stencil_poly_smooth_per_root), and K1 and K2 beside
   the torch.sparse CSR call that computes each (A @ v, and addmm with
   alpha = -1) on the same operator. Computes each kernel's
   bound from the shapes: the larger of its bytes (each operand once) over
   HBM_BYTES_PER_S and its flops over FP32_FLOPS_PER_S.
   Then holds the tiled K3 to its plain version on shapes that stress its
   windows: a lattice smaller than a window, one that no tile divides,
   batches that the probes of a pass do not divide, depths 1, 5, 7 and 16,
   in complex64 (1e-5) and complex128 (1e-12).
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
   and have k finite deflation eigenvalues. On no path may the per-root
   K3 be launched: K3's launches are launches of the tiled kernel.
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
# The card's data-sheet peaks the bounds are reckoned against (NVIDIA H100
# SXM): device memory, and float32 outside the tensor cores (the stencil's
# coefficients differ per site, so it is no matrix product).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Real flops per site and probe: 18 complex multiply-adds for D; K2 adds two
# complex subtractions; a K3 root scales two values (12), adds them to x (4)
# and, where it applies D, subtracts D step from cur (144 + 4).
FLOPS_D = 144
FLOPS_K2 = FLOPS_D + 4
FLOPS_K3_ROOT = 12 + 4 + FLOPS_D + 4
FLOPS_K3_LAST_NO_D = 12 + 4
STRESS_LATTICES = ("generated:24x40:beta=3.0:seed=5", "generated:20x52:beta=3.0:seed=6")
STRESS_BATCHES = (3, 37)
STRESS_DEPTHS = (1, 5, 7, 16)
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


def _bound(n_blocks: int, flops_per_site_probe: int, B: int, nx: int, nt: int,
           itemsize: int):
    """(bound ms, bound by): the least time for ``n_blocks`` probe blocks
    (B, 2, nx, nt) and the 18 used coefficient fields moved once, and for
    the flops, at the card's data-sheet peaks."""
    sites = nx * nt
    nbytes = (n_blocks * B * 2 + 18) * sites * itemsize
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_flops = 1e3 * flops_per_site_probe * sites * B / FP32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def _cases(sk, roots_by_depth):
    """(name, kernel, plain version, other, blocks moved, flops per site and
    probe) for K1, K2 and K3 at each root depth, with and without the
    residual. ``other`` is a second implementation timed beside the kernel:
    the per-root kernel for K3, None else."""
    cases = [
        ("stencil_matvec",
         lambda C_, a, b, X, T: sk.stencil_matvec(C_, a, X, T),
         lambda C_, a, b, X, T: sk.stencil_matvec_plain(C_, a, X, T),
         None, 2, FLOPS_D),
        ("stencil_residual",
         lambda C_, a, b, X, T: sk.stencil_residual(C_, a, b, X, T),
         lambda C_, a, b, X, T: sk.stencil_residual_plain(C_, a, b, X, T),
         None, 3, FLOPS_K2),
    ]
    for depth, roots in roots_by_depth.items():
        cases += [
            (f"stencil_poly_smooth depth {depth}",
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth(
                 C_, a, r, X, T, with_residual=True),
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth_plain(
                 C_, a, r, X, T, with_residual=True),
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth_per_root(
                 C_, a, r, X, T, with_residual=True),
             3, depth * FLOPS_K3_ROOT),
            (f"stencil_poly_smooth depth {depth} (no residual)",
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth(C_, a, r, X, T)[0],
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth_plain(C_, a, r, X, T)[0],
             lambda C_, a, b, X, T, r=roots: sk.stencil_poly_smooth_per_root(
                 C_, a, r, X, T)[0],
             2, (depth - 1) * FLOPS_K3_ROOT + FLOPS_K3_LAST_NO_D),
        ]
    return cases


def _check(label, cases, C, v, w, nx, nt, small=None) -> dict:
    """Each case against its plain version (c64 to TOL_C64; on ``small`` =
    (C, v, w, nx, nt) in c128 to TOL_C128), timed with CUDA events.
    Returns {case name: dict(max_abs_err, rel_err, ms, plain_ms, other_ms,
    bound_ms, bound_by)}."""
    import torch

    out = {}
    B = v.shape[0]
    for name, kern, plain, other, n_blocks, flops in cases:
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
        other_ms = None
        if other is not None:
            oerr = _rel_err(_flat(other(C, v, w, nx, nt)), ref)
            if oerr > TOL_C64:
                raise RuntimeError(f"{label} {name}: the per-root kernel disagrees with "
                                   f"the plain version (c64 rel {oerr:.3e})")
            other_ms = _time_ms(lambda: other(C, v, w, nx, nt))
        ms = _time_ms(lambda: kern(C, v, w, nx, nt))
        plain_ms = _time_ms(lambda: plain(C, v, w, nx, nt))
        bound_ms, bound_by = _bound(n_blocks, flops, B, nx, nt, C.element_size())
        msg += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {bound_ms / ms:.1%} of bound")
        if other_ms is not None:
            msg += f", per-root kernel {other_ms:.4f} ms"
        print(msg)
        out[name] = dict(max_abs_err=abs64, rel_err=err64, ms=ms, plain_ms=plain_ms,
                         other_ms=other_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def _library_ms(op, v, w) -> dict:
    """The yardsticks of K1 and K2: the one torch.sparse call that computes
    each with the same operator (CSR) on the same blocks, which the port
    never makes: ``A @ v`` for K1, ``torch.addmm(b, A, x, alpha=-1)`` for K2.
    Returns {kernel name: (ms, max abs difference from the kernel)}, with
    (None, reason) where the installed PyTorch has no such complex CSR
    product on the card."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.io import csr_from_stencil
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    A = csr_from_stencil(op.host_coeffs())
    At = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype("int64")), torch.from_numpy(A.indices.astype("int64")),
        torch.from_numpy(A.data), size=A.shape).to(v.device)
    vt, wt = v.T.contiguous(), w.T.contiguous()
    calls = {
        "stencil_matvec": (lambda: At @ vt,
                           lambda: sk.stencil_matvec(op.coeffs, v, op.nx, op.nt)),
        "stencil_residual": (lambda: torch.addmm(vt, At, wt, alpha=-1),
                             lambda: sk.stencil_residual(op.coeffs, v, w, op.nx, op.nt)),
    }
    out = {}
    for name, (library, kernel) in calls.items():
        try:
            y = library()
        except (RuntimeError, NotImplementedError) as e:
            reason = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            print(f"[kernels] {name}: no torch.sparse CSR call for it here: {reason}")
            out[name] = (None, reason)
            continue
        diff = float((y.T - kernel()).abs().max())
        if not diff <= 1e-4:
            raise RuntimeError(f"{name}: the torch.sparse call computes something else "
                               f"(max abs difference {diff:.3e})")
        out[name] = (_time_ms(library), diff)
    return out


def check_window_stress(device) -> int:
    """The tiled K3 against its plain version where its window logic is
    stressed; returns the number of cases."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator(device=device).manual_seed(4321)
    worst = {torch.complex64: 0.0, torch.complex128: 0.0}
    n = 0
    for spec in STRESS_LATTICES:
        for dtype, tol in ((torch.complex64, TOL_C64), (torch.complex128, TOL_C128)):
            op, _ = load_operator(spec, -0.2, dtype=dtype, device=device)
            roots = {m: _roots(op, m) for m in STRESS_DEPTHS}
            for B in STRESS_BATCHES:
                r = _randn((B, op.n), dtype, gen, device)
                for m in STRESS_DEPTHS:
                    for wr in (True, False):
                        got = sk.stencil_poly_smooth(op.coeffs, r, roots[m], op.nx, op.nt,
                                                     with_residual=wr)
                        ref = sk.stencil_poly_smooth_plain(op.coeffs, r, roots[m], op.nx,
                                                           op.nt, with_residual=wr)
                        torch.cuda.synchronize()
                        for g, f, what in zip(got, ref, ("x", "residual")):
                            if f is None:
                                if g is not None:
                                    raise RuntimeError("a residual where none was asked for")
                                continue
                            err = _rel_err(g, f)
                            worst[dtype] = max(worst[dtype], err)
                            if not torch.isfinite(g).all() or err > tol:
                                raise RuntimeError(
                                    f"tiled K3 {what} on {spec} {dtype} B={B} depth {m} "
                                    f"residual={wr}: rel err {err:.3e} > {tol:g}")
                        n += 1
    print(f"[kernels stress] tiled K3 on {', '.join(STRESS_LATTICES)}; B in {STRESS_BATCHES}; "
          f"depths {STRESS_DEPTHS}; with and without residual: {n} cases, worst rel err "
          f"c64 {worst[torch.complex64]:.3e}, c128 {worst[torch.complex128]:.3e}")
    return n


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
        for name, (lib_ms, lib_note) in _library_ms(op, v, w).items():
            results[label][name]["library_ms"] = lib_ms
            if lib_ms is not None:
                print(f"[kernels {label}] {name}: torch.sparse CSR call {lib_ms:.4f} ms "
                      f"(max abs difference from the kernel {lib_note:.3e})")
        del op, v, w
    check_window_stress(device)
    return results


def flagship_cfg():
    """The JAX package's schwinger128 profile, field for field, on the
    generated flagship operator."""
    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params

    return set_params("schwinger128").replace(matrix=FLAGSHIP_MATRIX, mass=FLAGSHIP_MASS)


def _no_per_root_launch(label: str, sk) -> None:
    """K3 on a path is the tiled kernel alone."""
    n = sk.stencil_poly_smooth_per_root.launches
    if n:
        raise RuntimeError(f"{label} launched the per-root K3 {n} times")


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
    print(f"[G301] kernel launches {counts} (stencil_poly_smooth: launches of the tiled "
          f"kernel, several roots each)")
    if not all(math.isfinite(x) for x in (tr.real, tr.imag, stderr)):
        raise RuntimeError("G301 produced a non-finite result")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise RuntimeError(f"G301 did not launch {missing}")
    _no_per_root_launch("G301", sk)
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
    print(f"[{label}] kernel launches {counts} (stencil_poly_smooth: launches of the "
          f"tiled kernel, several roots each)")
    if not all(math.isfinite(x) for x in (tr.real, tr.imag, stderr)):
        raise RuntimeError(f"{label} produced a non-finite result")
    if len(defl.values) != k or not all(math.isfinite(x) for x in defl.values):
        raise RuntimeError(f"{label}: the deflation basis has no {k} finite eigenvalues")
    missing = [n for n, c in counts.items() if c <= 0]
    if missing:
        raise RuntimeError(f"{label} did not launch {missing}")
    _no_per_root_launch(label, sk)
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
        g301_key = name if name != "stencil_poly_smooth" else f"{name} depth 4"
        k102, k301 = kernels["G102"][key], kernels["G301"][g301_key]
        per_path = {p: c[name] for p, c in counts.items()}
        entry = dict(
            name=name, route="cuda", source=KERNEL_SOURCE, replaces=replaces,
            launches=sum(per_path.values()), launches_per_path=per_path,
            max_abs_err=k102["max_abs_err"], ms=k102["ms"], plain_ms=k102["plain_ms"],
            bound_ms=k102["bound_ms"], bound_by=k102["bound_by"],
            library_ms=k102.get("library_ms"), shapes="G102",
            g301_shapes={k: k301.get(k) for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        if name == "stencil_poly_smooth":
            # launches count the tiled kernel's launches, several roots each
            entry["per_root_kernel_ms"] = k102["other_ms"]
            entry["g301_shapes"]["per_root_kernel_ms"] = k301["other_ms"]
            entry["variants"] = {
                f"{lbl} {k[len(name) + 1:]}": {f: v[f] for f in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                | {"per_root_kernel_ms": v["other_ms"]}
                for lbl, res in kernels.items() for k, v in res.items()
                if k.startswith(name)}
        entries.append(entry)

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
