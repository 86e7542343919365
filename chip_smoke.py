#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Builds the stencil kernels from deflatedmlmc_schwinger_tpu_torch/csrc
   with nvcc (sm_90a) and prints the build time.
2. Holds each kernel (K1 stencil_matvec and K2 stencil_residual, both the
   row kernel; K3 stencil_poly_smooth, the tiled kernel that takes several
   roots per launch, with and without the residual) to its plain PyTorch
   version on the card: at the G301 shapes (64 probes, 256^2, complex64) to
   1e-5 relative, and on a small non-square complex128 lattice to 1e-12;
   then at the G102 shapes (128 probes, 128^2, complex64, K3 with the
   depth-16 sampling and depth-4 setup roots) to 1e-5. Times each kernel
   and its plain version with CUDA events, beside its yardstick in turns
   (kernel, yardstick, yardstick, kernel): the per-site K1 and K2
   (stencil_matvec_per_site, stencil_residual_per_site; the row kernel must
   agree with them to 1e-6 relative in complex64) and the per-root K3
   (stencil_poly_smooth_per_root); K1 and K2 also beside the torch.sparse
   CSR call that computes each (A @ v, and addmm with alpha = -1) on the
   same operator, and with their device time (a CUDA graph of REPS launches
   replayed) and host time per call (no synchronise), for the row kernel
   and the per-site one. Computes each kernel's bound from the shapes: the
   larger of its bytes (each operand once) over HBM_BYTES_PER_S and its
   flops over FP32_FLOPS_PER_S.
   Then holds the tiled K3 to its plain version on shapes that stress its
   windows: a lattice smaller than a window, one that no tile divides,
   batches that the probes of a pass do not divide, depths 1, 5, 7 and 16,
   in complex64 (1e-5) and complex128 (1e-12); and the row kernel of K1/K2
   on the plans other than whole aligned rows: an odd-T complex64 lattice,
   a misaligned contiguous view, a lattice of fewer rows than a tile's
   halo, and column tiles (random seeded coefficients).
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
   and have k finite deflation eigenvalues. On no path, here or in phase
   12's ranks, may a yardstick (per-root K3, per-site K1 or K2) be
   launched: K3's launches are launches of the tiled kernel, K1's and
   K2's of the row kernel.
5. Computes the exact displaced trace tr(D^{-1} Pi^T) of the same operator
   in complex128 on the card (dense LU, column blocks) and checks that both
   estimates lie within 5 of their own reported standard errors of it.
6. Holds K1 and K2 to their plain versions at the G101/G201 shapes (8
   probes, 16^2, complex128, to 1e-12) and K1-K3 at the G302 shapes (16
   probes, 512^2, complex64, and 8 probes, the block that each of two
   sample ranks gives the replicated solver in phase 12), each with its
   bound and, for K1 and K2, the per-site kernels, the device and host
   times and the torch.sparse call, as in phase 2.
7. Runs the unchanged 16^2 profile (set_params("schwinger16") with
   function_tol 1e-12: complex128, GMRES smoother, k = 64) on a generated
   16^2 operator (SMALL_MATRIX at SMALL_MASS; schwinger16.mat is not in the
   repository) through EXAMPLE_001 (the G101 path) and EXAMPLE_002 (the G201
   path), and holds both within 5 of their own standard errors of the exact
   tr(D^{-1}) from a complex128 dense inverse on the card. Both must launch
   K1 and K2; their smoother is GMRES, so K3 is no kernel of these paths.
8. Runs gateway.G302 (deflated Hutchinson, generated 512^2, 4 levels, 16
   probes per batch): trace within 1% of the JAX package's recorded
   115047.9, stalled rows within max_stalled_frac, K1-K3 launched; prints
   the phase seconds and the peak device memory.
9. Runs the 256^2 profile again with setup_backend='device' (test vectors
   and Galerkin products on the card): trace within 1% of 28640.7; prints
   the outer iterations per probe and the mg_setup seconds of both backends.
10. Checkpoints: a Hutchinson run on a generated 64^2 lattice cut by
   max_nr_ests with a checkpoint directory, resumed, and held equal to the
   uninterrupted run (same nr_ests and iterations, trace to round-off).
11. Times the fused (z, A z) V-cycle (MGSolver.precond_matvec through
   fgmres's matvec_precond) beside the precond + matvec pair on one
   128-probe batch at the G102 shapes; the iteration counts must be equal.
12. Several ranks of torch.distributed on the one card (the gloo backend,
   staged through the host), started through parallel/worker.py after the
   kernels are built: K1 and K2 against their plain versions on the padded
   local blocks of 2 and 4 x shards (8 and 16 probes), timed as in phase 2
   beside the per-site kernels and the torch.sparse call on the same padded
   coefficients; the halo matvec on 2
   and 4 x shards at 512^2 with 16 probes (kernel K1 on the padded block
   against its plain version and against single-device K1, 1e-5 relative);
   ShardedMGSolver.solve on a (2, 2) mesh at the G302 hierarchy against
   MGSolver.solve on the same 16 probes (iteration counts equal or within 1
   per row, x within 10 times the solve tolerance); psum_moments and
   allgather_moments across 4 ranks against the host Chan merge;
   gateway.G302(devices=2) (probe batches split) and gateway.G302(devices=4)
   with DMLMC_X_SHARDS=2 (the lattice cut in two as well): trace within 1%
   of 115047.9, the nr_ests of a one-rank run on the same host-gathered
   loop, the same result on every rank, stalled rows within
   max_stalled_frac, K1 and K2 launched by rank 0 on the sharded path;
   prints walls, phase seconds and the transport share of sampling.
13. The complex64 policies on the 16^2 operator (SMALL_MATRIX built in
   complex64, a 3-level hierarchy, K1 and K2 must launch): a crippled solver
   must make hutchinson and mlmc raise the stall error under the default
   max_stalled_frac and report stalled rows with 1.0; 32 matched probes
   solved in complex64 at the floor and at 5e-4 must stay within 1e-3 and
   5e-3 of |tr| of the same probes solved in complex128; two float64
   refinement steps must cut the error of the deflation correction tr1 at
   least tenfold against a dense complex128 oracle.
14. Prints the card's name and power limit, a JSON line with the kernels'
   numbers (launches per path; for K1 and K2 per_site_kernel_ms, device_ms,
   per_site_device_ms, host_us and per_site_host_us), and as the last line
   {"ok": true, "device": {...}}.

Any failure raises, so the script exits non-zero and prints no result line.
It needs a CUDA card, nvcc and the rest of this repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REFERENCE_TRACE = 28640.7   # the JAX package's recorded G301 estimate
REFERENCE_TRACE_G302 = 115047.9   # and its recorded G302 estimate
# the operator of the 16^2 paths (PERF.md, section 4: why this mass)
SMALL_MATRIX = "generated:16x16:beta=5.0:seed=1"
SMALL_MASS = -0.29
CHECKPOINT_MATRIX = "generated:64x64:beta=5.0:seed=8"
TOL_C64 = 1e-5
TOL_C128 = 1e-12
TOL_PER_SITE_C64 = 1e-6     # the row kernel against the per-site one: fma contraction only
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
FP64_FLOPS_PER_S = 34e12    # float64 outside the tensor cores (complex128 shapes)
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
# (X, T, B, dtype, misaligned view): the row kernel's other copy paths
ROW_PATHS = ((9, 13, 5, "complex64", False), (24, 40, 3, "complex64", True),
             (2, 8, 3, "complex64", False), (1, 16, 2, "complex128", False),
             (3, 2100, 3, "complex64", False), (3, 2100, 3, "complex128", False),
             (128, 128, 128, "complex64", True))
ROW_KERNELS = ("stencil_matvec", "stencil_residual")
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


def _graph_ms(fn, reps: int = REPS, replays: int = 5) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    work per call does not pace the loop. ``fn`` runs eagerly first, which
    sets up what the capture must not do (builds, shared-memory limits)."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (reps * replays)
    del graph
    return ms


def _host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call over ``calls`` calls without a
    synchronise (the launch path's own cost while the device keeps up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def _randn(shape, dtype, gen, device):
    import torch

    return torch.randn(shape, dtype=dtype, generator=gen, device=device)


def _bound(n_blocks: int, flops_per_site_probe: int, B: int, nx: int, nt: int,
           itemsize: int):
    """(bound ms, bound by): the least time for ``n_blocks`` probe blocks
    (B, 2, nx, nt) and the 18 used coefficient fields moved once, and for
    the flops, at the card's data-sheet peaks (``itemsize`` 8: complex64,
    float32 rate; 16: complex128, float64 rate)."""
    sites = nx * nt
    nbytes = (n_blocks * B * 2 + 18) * sites * itemsize
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    peak = FP32_FLOPS_PER_S if itemsize == 8 else FP64_FLOPS_PER_S
    t_flops = 1e3 * flops_per_site_probe * sites * B / peak
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def _cases(sk, roots_by_depth):
    """(name, kernel, plain version, yardstick, blocks moved, flops per site
    and probe) for K1, K2 and K3 at each root depth, with and without the
    residual. The yardstick is the earlier kernel timed beside this one:
    the per-site kernel for K1 and K2, the per-root kernel for K3."""
    cases = [
        ("stencil_matvec",
         lambda C_, a, b, X, T: sk.stencil_matvec(C_, a, X, T),
         lambda C_, a, b, X, T: sk.stencil_matvec_plain(C_, a, X, T),
         lambda C_, a, b, X, T: sk.stencil_matvec_per_site(C_, a, X, T),
         2, FLOPS_D),
        ("stencil_residual",
         lambda C_, a, b, X, T: sk.stencil_residual(C_, a, b, X, T),
         lambda C_, a, b, X, T: sk.stencil_residual_plain(C_, a, b, X, T),
         lambda C_, a, b, X, T: sk.stencil_residual_per_site(C_, a, b, X, T),
         3, FLOPS_K2),
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


def _check(label, cases, C, v, w, nx, nt, small=None, tol=TOL_C64) -> dict:
    """Each case against its plain version (to ``tol``, relative; on
    ``small`` = (C, v, w, nx, nt) in c128 to TOL_C128), timed with CUDA events
    beside its yardstick in turns (kernel, yardstick, yardstick, kernel);
    K1 and K2 also by CUDA-graph replay (device ms) and per call on the host.
    Returns {case name: dict(max_abs_err, rel_err, ms, plain_ms, other_ms,
    bound_ms, bound_by, and for K1/K2 device_ms, other_device_ms, host_us,
    other_host_us)}."""
    import torch

    out = {}
    B = v.shape[0]
    for name, kern, plain, other, n_blocks, flops in cases:
        got = _flat(kern(C, v, w, nx, nt))
        ref = _flat(plain(C, v, w, nx, nt))
        torch.cuda.synchronize()
        err64 = _rel_err(got, ref)
        abs64 = float((got - ref).abs().max())
        msg = (f"[kernels {label}] {name}: {str(C.dtype)[6:]} rel err {err64:.3e} "
               f"(abs {abs64:.3e})")
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{label} {name}: non-finite output")
        if err64 > tol:
            raise RuntimeError(f"{label} {name}: kernel disagrees with its plain version "
                               f"(rel {err64:.3e} > {tol:g})")
        if small is not None:
            sC, sv, sw, snx, snt = small
            sgot = _flat(kern(sC, sv, sw, snx, snt))
            sref = _flat(plain(sC, sv, sw, snx, snt))
            torch.cuda.synchronize()
            err128 = _rel_err(sgot, sref)
            if not torch.isfinite(sgot).all() or err128 > TOL_C128:
                raise RuntimeError(f"{label} {name}: c128 rel {err128:.3e} > {TOL_C128:g}")
            msg += f", c128 24x40 rel err {err128:.3e}"
        oout = _flat(other(C, v, w, nx, nt))
        oerr = _rel_err(oout, ref)
        if oerr > tol:
            raise RuntimeError(f"{label} {name}: the yardstick disagrees with "
                               f"the plain version (rel {oerr:.3e})")
        row = name in ROW_KERNELS
        if row:
            verr = _rel_err(got, oout)
            if C.dtype == torch.complex64 and verr > TOL_PER_SITE_C64:
                raise RuntimeError(f"{label} {name}: the row kernel differs from the "
                                   f"per-site kernel by {verr:.3e} relative")
            msg += f", vs per-site {verr:.3e}"
        k_fn = lambda: kern(C, v, w, nx, nt)  # noqa: E731
        o_fn = lambda: other(C, v, w, nx, nt)  # noqa: E731
        turns = [_time_ms(f) for f in (k_fn, o_fn, o_fn, k_fn)]
        ms, other_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        plain_ms = _time_ms(lambda: plain(C, v, w, nx, nt))
        bound_ms, bound_by = _bound(n_blocks, flops, B, nx, nt, C.element_size())
        what = "per-site" if row else "per-root"
        msg += (f"; kernel {turns[0]:.4f}/{turns[3]:.4f} ms, {what} kernel "
                f"{turns[1]:.4f}/{turns[2]:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
        res = dict(max_abs_err=abs64, rel_err=err64, ms=ms, plain_ms=plain_ms,
                   other_ms=other_ms, bound_ms=bound_ms, bound_by=bound_by)
        if row:
            dturns = [_graph_ms(f) for f in (k_fn, o_fn, o_fn, k_fn)]
            res.update(device_ms=(dturns[0] + dturns[3]) / 2,
                       other_device_ms=(dturns[1] + dturns[2]) / 2,
                       host_us=_host_us(k_fn), other_host_us=_host_us(o_fn))
            msg += (f"; device (graph) {dturns[0]:.4f}/{dturns[3]:.4f} ms, per-site "
                    f"{dturns[1]:.4f}/{dturns[2]:.4f} ms, "
                    f"{bound_ms / res['device_ms']:.1%} of bound; host "
                    f"{res['host_us']:.2f} us per call, per-site {res['other_host_us']:.2f} us")
        print(msg)
        out[name] = res
    return out


def _library_ms(C, v, w, nx, nt) -> dict:
    """The yardsticks of K1 and K2: the one torch.sparse call that computes
    each with the same operator (the CSR matrix of the coefficients ``C``,
    periodic over ``nx`` rows, zero coefficients dropped) on the same blocks,
    which the port never makes: ``A @ v`` for K1,
    ``torch.addmm(b, A, x, alpha=-1)`` for K2.
    Returns {kernel name: (ms, max abs difference from the kernel)}, with
    (None, reason) where the installed PyTorch has no such complex CSR
    product on the card."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.io import csr_from_stencil
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    A = csr_from_stencil(C.cpu().numpy())
    A.eliminate_zeros()
    At = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype("int64")), torch.from_numpy(A.indices.astype("int64")),
        torch.from_numpy(A.data), size=A.shape).to(v.device)
    vt, wt = v.T.contiguous(), w.T.contiguous()
    calls = {
        "stencil_matvec": (lambda: At @ vt,
                           lambda: sk.stencil_matvec(C, v, nx, nt)),
        "stencil_residual": (lambda: torch.addmm(vt, At, wt, alpha=-1),
                             lambda: sk.stencil_residual(C, v, w, nx, nt)),
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


def _add_library_ms(label, results, C, v, w, nx, nt) -> None:
    for name, (lib_ms, lib_note) in _library_ms(C, v, w, nx, nt).items():
        results[name]["library_ms"] = lib_ms
        if lib_ms is not None:
            print(f"[kernels {label}] {name}: torch.sparse CSR call {lib_ms:.4f} ms "
                  f"(max abs difference from the kernel {lib_note:.3e})")


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


def check_row_paths(device) -> int:
    """K1 and K2 (the row kernel) against their plain versions on the plans
    other than whole aligned rows (ROW_PATHS): per-element copies for odd T
    in complex64 and for a contiguous view at an odd element offset, the
    wrapped halo rows of a lattice of one or two rows, column tiles of a row
    wider than a block. Random seeded (2, 2, 5, X, T) coefficients. Returns
    the number of cases."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator(device=device).manual_seed(606)
    n_cases, worst = 0, {}
    for nx, nt, B, dtype_name, misaligned in ROW_PATHS:
        dtype = getattr(torch, dtype_name)
        tol = TOL_C64 if dtype == torch.complex64 else TOL_C128
        n = 2 * nx * nt
        C = _randn((2, 2, 5, nx, nt), dtype, gen, device)
        if misaligned:
            v = _randn((B * n + 1,), dtype, gen, device)[1:].view(B, n)
            w = _randn((B * n + 1,), dtype, gen, device)[1:].view(B, n)
            assert v.is_contiguous() and v.data_ptr() % 16
        else:
            v, w = (_randn((B, n), dtype, gen, device) for _ in range(2))
        plan = sk.launch_plan(B, nx, nt, C.element_size(), 132, residual=False,
                              aligned=not misaligned)
        for got, ref in ((sk.stencil_matvec(C, v, nx, nt), sk.stencil_matvec_plain(C, v, nx, nt)),
                         (sk.stencil_residual(C, w, v, nx, nt),
                          sk.stencil_residual_plain(C, w, v, nx, nt))):
            torch.cuda.synchronize()
            err = _rel_err(got, ref)
            worst[dtype_name] = max(worst.get(dtype_name, 0.0), err)
            if not torch.isfinite(got).all() or err > tol:
                raise RuntimeError(f"row kernel on {nx}x{nt} B={B} {dtype_name} misaligned="
                                   f"{misaligned} (R={plan.rows}, W={plan.cols}, "
                                   f"bulk={plan.bulk}): rel err {err:.3e} > {tol:g}")
            n_cases += 1
    print(f"[kernels row paths] K1/K2 on {[p[:4] + (('misaligned',) if p[4] else ()) for p in ROW_PATHS]}: "
          f"{n_cases} cases, worst rel err " + ", ".join(f"{k} {e:.3e}" for k, e in worst.items()))
    return n_cases


def _roots(op, depth: int):
    from deflatedmlmc_schwinger_tpu_torch.io import csr_from_stencil
    from deflatedmlmc_schwinger_tpu_torch.mg.host_setup import _poly_roots_host

    return _poly_roots_host(csr_from_stencil(op.host_coeffs().astype("complex128")), depth)


def check_kernels(device) -> dict:
    """Phases 2 and 6: every kernel against its plain version at the G301
    shapes (and on a small c128 lattice), the G102 shapes, the G101/G201
    shapes (complex128, K1 and K2) and the G302 shapes: 16 probes as on one
    rank, and 8 as each of two sample ranks gives the replicated solver."""
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
    g302 = set_params("schwinger512")
    for label, cfg in (("G301", set_params("schwinger256")), ("G102", flagship_cfg()),
                       ("G101", small_cfg()), ("G302", g302),
                       ("G302 B8", g302.replace(probe_batch=g302.probe_batch // 2))):
        op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                              dtype=cfg.dtype, device=device)
        # K3 is a kernel of the polynomial smoother's paths only
        depths = set()
        if cfg.solver.smoother == "poly":
            depths.add(cfg.solver.smooth_iters)
            if cfg.defl_solver is not None:
                depths.add(cfg.defl_solver.smooth_iters)
        roots = {dp: _roots(op, dp) for dp in sorted(depths, reverse=True)}
        v = _randn((cfg.probe_batch, op.n), cfg.dtype, gen, device)
        w = _randn((cfg.probe_batch, op.n), cfg.dtype, gen, device)
        results[label] = _check(label, _cases(sk, roots), op.coeffs, v, w, op.nx, op.nt,
                                small if label == "G301" else None,
                                TOL_C64 if cfg.dtype == torch.complex64 else TOL_C128)
        _add_library_ms(label, results[label], op.coeffs, v, w, op.nx, op.nt)
        del op, v, w
    check_window_stress(device)
    check_row_paths(device)
    return results


def flagship_cfg():
    """The JAX package's schwinger128 profile, field for field, on the
    generated flagship operator."""
    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params

    return set_params("schwinger128").replace(matrix=FLAGSHIP_MATRIX, mass=FLAGSHIP_MASS)


def small_cfg():
    """The JAX package's G101/G201 configuration (the schwinger16 profile
    with function_tol 1e-12), field for field, on the generated 16^2
    operator."""
    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params

    return set_params("schwinger16").replace(function_tol=1e-12, matrix=SMALL_MATRIX,
                                             mass=SMALL_MASS)


def _no_yardstick_launch(label: str, counts: dict) -> None:
    """K1-K3 on a path are the row and tiled kernels alone: ``counts``
    (stencil_kernels.yardstick_counts()) must be all 0."""
    launched = {k: n for k, n in counts.items() if n}
    if launched:
        raise RuntimeError(f"{label} launched yardstick kernels {launched}")


def run_generated(label: str, entry, cfg, reference: float, device) -> dict:
    """A k = 0 Hutchinson path on a generated lattice (G301, G302, and the
    256^2 profile on the device setup backend) through ``entry(device=...)``,
    held to the JAX package's recorded trace of that configuration. Returns
    dict(counts, result, wall, peak_gb)."""
    import math

    import torch

    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    result = entry(device=device)
    wall = time.perf_counter() - t0
    counts = sk.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phases = dict(result["timer"].totals)
    tr = complex(result["trace"])
    stderr = result["std_dev"] / math.sqrt(result["nr_ests"])
    print(f"[{label}] trace {tr} stderr {stderr:.6g} (rel {stderr / abs(tr):.3e}) "
          f"nr_ests {result['nr_ests']} function_iters {result['function_iters']} "
          f"({result['function_iters'] / result['nr_ests']:.2f} outer iterations per probe) "
          f"stalled_rows {result['stalled_rows']} wall {wall:.3f} s "
          f"peak device memory {peak_gb:.3f} GB")
    print(f"[{label}] phase seconds " + " ".join(
        f"{k}={phases.get(k, 0.0):.4f}" for k in ("mg_setup", "defl_setup",
                                                   "rough_trace", "sampling")))
    print(f"[{label}] kernel launches {counts} (stencil_poly_smooth: launches of the tiled "
          f"kernel, several roots each)")
    if not all(math.isfinite(x) for x in (tr.real, tr.imag, stderr)):
        raise RuntimeError(f"{label} produced a non-finite result")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise RuntimeError(f"{label} did not launch {missing}")
    _no_yardstick_launch(label, sk.yardstick_counts())
    solved = result["nr_ests"] + max(cfg.nr_rough_iters, cfg.probe_batch)
    if result["stalled_rows"] > cfg.max_stalled_frac * solved:
        raise RuntimeError(f"{label}: {result['stalled_rows']} stalled rows of {solved}")
    if abs(tr - reference) > cfg.trace_tol * reference:
        raise RuntimeError(f"{label} trace {tr} is not within {cfg.trace_tol:.0%} "
                           f"of {reference}")
    return dict(counts=counts, result=result, wall=wall, peak_gb=peak_gb)


def run_profile(label: str, cfg, mlmc: bool, device, kernels_of_path):
    """A deflated path through its example entry (EXAMPLE_002 with ``mlmc``,
    else EXAMPLE_001): the 128^2 flagship profile (G102, G202) or the 16^2
    profile (G101, G201). ``kernels_of_path`` names the kernels the path must
    launch. Returns (result, kernel launches of that run, wall seconds,
    standard error)."""
    import math

    from deflatedmlmc_schwinger_tpu_torch import examples
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    entry = examples.EXAMPLE_002 if mlmc else examples.EXAMPLE_001
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    result = entry(cfg, device=device)
    wall = time.perf_counter() - t0
    counts = sk.launch_counts()
    phases = dict(result["timer"].totals)
    tr = complex(result["trace"])
    k = int(cfg.nr_deflat_vctrs)
    Br = max(cfg.nr_rough_iters, cfg.probe_batch)
    if not mlmc:
        stderr = result["std_dev"] / math.sqrt(result["nr_ests"])
        solved = result["nr_ests"] + Br + k
        print(f"[{label}] nr_ests {result['nr_ests']} function_iters "
              f"{result['function_iters']} probe solves/s in sampling "
              f"{result['nr_ests'] / phases['sampling']:.1f}")
    else:
        stderr = result["std_dev"]
        sampled = [r["nr_ests"] for r in result["results"][:-1] if r["ests_dev"] > 0]
        # the gamma3 basis' correction solves: once, and once more where the
        # level-0 difference reuses that basis
        solved = sum(sampled) + Br + (2 * k if cfg.mlmc_fine_deflation else k)
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
    missing = [n for n in kernels_of_path if counts[n] <= 0]
    if missing:
        raise RuntimeError(f"{label} did not launch {missing}")
    _no_yardstick_launch(label, sk.yardstick_counts())
    if stalled > cfg.max_stalled_frac * solved:
        raise RuntimeError(f"{label}: {stalled} stalled rows of {solved}")
    return result, counts, wall, stderr


def check_oracle(label: str, tr: complex, stderr: float, exact: complex) -> None:
    """An estimate must lie within ORACLE_SIGMAS of its own standard errors
    of the exact dense value."""
    err = abs(tr - exact)
    print(f"[oracle] {label}: |trace - exact| = {err:.6g} = {err / stderr:.3f} stderr, "
          f"realized relative error {err / abs(exact):.3e}")
    if err > ORACLE_SIGMAS * stderr:
        raise RuntimeError(f"{label} trace {tr} is {err / stderr:.2f} stderr from the "
                           f"exact {exact}")


def dense_trace_small(device) -> complex:
    """The exact tr(D^{-1}) of the 16^2 operator (n = 512): D assembled
    through the plain stencil and inverted in complex128 on the card."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    cfg = small_cfg()
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=torch.complex128, device=device)
    eye = torch.eye(op.n, dtype=torch.complex128, device=device)
    D = sk.stencil_matvec_plain(op.coeffs, eye, op.nx, op.nt).T   # row j of the batch = D e_j
    return complex(torch.linalg.inv(D).diagonal().sum().item())


def check_checkpoint_resume(device) -> None:
    """Phase 10: a checkpointed Hutchinson run cut by max_nr_ests and
    resumed equals the uninterrupted one. The stopping rule is put out of
    reach (trace_tol 1e-9), so every run ends at max_nr_ests, the
    device-resident loop without a checkpoint included."""
    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params
    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson

    cfg = set_params("schwinger256").replace(
        matrix=CHECKPOINT_MATRIX, latt_dims=(64, 64), aggrs=(16, 4), probe_batch=16,
        max_nr_ests=96, trace_tol=1e-9)
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims, dtype=cfg.dtype,
                          device=device)
    with tempfile.TemporaryDirectory() as cut_dir, tempfile.TemporaryDirectory() as whole_dir:
        first = hutchinson(op, cfg.replace(max_nr_ests=48), verbose=False,
                           checkpoint_dir=cut_dir)
        resumed = hutchinson(op, cfg, verbose=False, checkpoint_dir=cut_dir)
        whole = hutchinson(op, cfg, verbose=False, checkpoint_dir=whole_dir)
    device_loop = hutchinson(op, cfg, verbose=False)
    diff = abs(resumed["trace"] - whole["trace"]) / abs(whole["trace"])
    diff_dev = abs(resumed["trace"] - device_loop["trace"]) / abs(device_loop["trace"])
    print(f"[checkpoint] cut at {first['nr_ests']} of {cfg.max_nr_ests} probes, resumed: "
          f"nr_ests {resumed['nr_ests']} function_iters {resumed['function_iters']} trace "
          f"{complex(resumed['trace'])}; uninterrupted: nr_ests {whole['nr_ests']} "
          f"function_iters {whole['function_iters']}, relative difference {diff:.3e}; "
          f"device-resident loop without a checkpoint: relative difference {diff_dev:.3e}")
    if first["nr_ests"] != 48:
        raise RuntimeError(f"the cut run took {first['nr_ests']} probes, not 48")
    for other in (whole, device_loop):
        if (resumed["nr_ests"], resumed["function_iters"]) != (
                other["nr_ests"], other["function_iters"]):
            raise RuntimeError("the resumed run's counts differ from the uninterrupted run's")
    # the checkpointed loops merge the same batches in float64 on the host;
    # the device-resident loop keeps complex64 runs' moments in float32
    if diff > 1e-6 or diff_dev > 1e-5:
        raise RuntimeError(f"the resumed trace differs by {diff:.3e} from the "
                           f"uninterrupted run, {diff_dev:.3e} from the device-resident loop")


def time_fused_precond_matvec(device) -> None:
    """Phase 11: one 128-probe batch of the G102 sampling solve, with the
    precond + matvec pair and with the fused precond_matvec form, in turns
    (pair, fused, fused, pair) after one warm-up of each."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, setup_hierarchy
    from deflatedmlmc_schwinger_tpu_torch.solvers import fgmres
    from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source

    cfg = flagship_cfg()
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims, dtype=cfg.dtype,
                          device=device)
    solver = MGSolver(setup_hierarchy(op, cfg), cfg.solver)
    b = make_probe_source("torch", cfg.seed, device)(0, cfg.probe_batch, op.n, cfg.dtype)
    kw = dict(tol=cfg.solver.effective_tol(cfg.function_tol, cfg.dtype),
              restart=cfg.solver.restart, max_restarts=cfg.solver.max_restarts)
    forms = {"pair": dict(precond=solver.precond(0)),
             "fused": dict(matvec_precond=solver.precond_matvec(0))}

    def run(form):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fgmres(solver.matvec(0), b, **forms[form], **kw)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), res

    ref = {form: run(form)[1] for form in forms}                 # warm-up
    if not torch.equal(ref["pair"].iters, ref["fused"].iters):
        raise RuntimeError("the fused precond_matvec form changes the iteration counts")
    times = {form: [] for form in forms}
    for form in ("pair", "fused", "fused", "pair", "pair", "fused"):
        times[form].append(run(form)[0])
    dx = float((ref["pair"].x - ref["fused"].x).abs().max() / ref["pair"].x.abs().max())
    print(f"[fused] G102 shapes, one batch of {cfg.probe_batch} probes, "
          f"{int(ref['pair'].iters.sum())} outer iterations in both forms "
          f"(max {int(ref['pair'].iters.max())}), x differs by {dx:.3e} relative: "
          + "; ".join(f"{form} " + ", ".join(f"{t:.2f}" for t in ts) + " ms"
                      for form, ts in times.items()))


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


# ---- phase 12: several ranks on the one card ---------------------------------

X_SHARDS = (2, 4)
SOLVE_TOL_FACTOR = 10.0      # sharded x within this many solve tolerances


def _g302_operator(device):
    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params
    from deflatedmlmc_schwinger_tpu_torch.io import load_operator

    cfg = set_params("schwinger512")
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims, dtype=cfg.dtype,
                          device=device)
    return cfg, op


def _g302_probes(cfg, op):
    from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source

    return make_probe_source("torch", cfg.seed, op.device)(0, cfg.probe_batch, op.n, cfg.dtype)


def rank_halo(x_shards: int) -> dict:
    """One rank of the halo check: its block of D v through kernel K1 on the
    padded block, through the plain version, and the whole product through
    single-device K1, all at the G302 shapes with 16 probes."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk
    from deflatedmlmc_schwinger_tpu_torch.parallel import halo, make_mesh
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import rank_device

    device = rank_device("cuda")
    cfg, op = _g302_operator(device)
    # every rank draws the same block: same seed, same kind of device
    v = _randn((cfg.probe_batch, op.n), cfg.dtype,
               torch.Generator(device=device).manual_seed(99), device)
    mesh = make_mesh((1, x_shards), ("samples", "x"))
    sh = halo.shard_coeffs(op, mesh, "x")
    blk = halo.local_block(v, mesh, op.nx, op.nt)
    sk.reset_launch_counts()
    got = halo.halo_apply(sh, blk)
    launches = sk.launch_counts()["stencil_matvec"]
    yardsticks = sk.yardstick_counts()
    plain = halo._halo_kernel(sh.coeffs, blk, *halo.halo_rows(sh, blk))
    whole = halo.gather_blocks(got, mesh)
    single = op.matvec(v)
    whole_plain = sk.stencil_matvec_plain(op.coeffs, v, op.nx, op.nt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        halo.halo_apply(sh, blk)
    torch.cuda.synchronize()
    return dict(rank=mesh.rank, vs_plain=_rel_err(got, plain), vs_single=_rel_err(whole, single),
                vs_whole_plain=_rel_err(whole, whole_plain), launches=launches,
                yardsticks=yardsticks, finite=bool(torch.isfinite(whole).all()),
                apply_ms=1e3 * (time.perf_counter() - t0) / 20,
                local_shape=tuple(blk.shape))


def rank_sharded_solve(hier_path: str) -> dict:
    """One rank of the solve check: ShardedMGSolver.solve on a (2, 2) mesh
    against MGSolver.solve, same hierarchy, same 16 probes."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls
    from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk
    from deflatedmlmc_schwinger_tpu_torch.parallel import ShardedMGSolver, make_mesh
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import (
        rank_device,
        reset_transport_stats,
        transport_stats,
    )
    from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import load_hierarchy

    pin_full_precision_matmuls()
    device = rank_device("cuda")
    cfg, op = _g302_operator(device)
    hier = load_hierarchy(hier_path, device, cfg.dtype)
    b = _g302_probes(cfg, op)
    mesh = make_mesh((2, 2), ("samples", "x"))
    ss = ShardedMGSolver(hier, mesh, cfg.solver)
    ss.solve(b, cfg.function_tol)                     # warm-up
    sk.reset_launch_counts()
    reset_transport_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ss.solve(b, cfg.function_tol)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    counts, moved = sk.launch_counts(), dict(transport_stats)
    yardsticks = sk.yardstick_counts()
    solver = MGSolver(hier, cfg.solver)
    solver.solve(b, cfg.function_tol)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = solver.solve(b, cfg.function_tol)
    torch.cuda.synchronize()
    return dict(rank=mesh.rank, iters=res.iters.tolist(), ref_iters=ref.iters.tolist(),
                dx=_rel_err(res.x, ref.x), relres=float((res.resnorm / res.bnorm).max()),
                stalled=int(res.stalled.sum()), counts=counts, yardsticks=yardsticks,
                transport=moved,
                sharded_s=sharded_s, replicated_s=time.perf_counter() - t0)


def rank_moments() -> dict:
    """One rank of the moments check: psum_moments over its share of 64
    seeded estimates on the card, and allgather_moments of its own
    RunningMoments."""
    import numpy as np
    import torch

    from deflatedmlmc_schwinger_tpu_torch.parallel import (
        allgather_moments,
        make_mesh,
        psum_moments,
    )
    from deflatedmlmc_schwinger_tpu_torch.trace.stats import RunningMoments

    mesh = make_mesh()
    es = _moment_samples().reshape(mesh.size, -1)[mesh.rank]
    local = RunningMoments()
    local.update_batch(es)
    merged = allgather_moments(local)
    cnt, mre, mim, m2 = psum_moments(
        torch.from_numpy(es.astype(np.complex64)).to(mesh.device), mesh.groups["samples"])
    return dict(merged=(merged.count, merged.mean, merged.m2),
                psum=(float(cnt), complex(float(mre), float(mim)), float(m2)))


def _moment_samples():
    import numpy as np

    rng = np.random.default_rng(77)
    return 100.0 + rng.standard_normal(64) + 1j * rng.standard_normal(64)


def check_padded_kernels(device) -> dict:
    """K1 and K2 against their plain versions on the padded local blocks of
    the lattice-sharded path: (B, 2, X/k + 2, 512) against coefficients with
    two rows of zeros, for k = 2 and 4 x shards and 8 and 16 probes. The
    library yardstick is the CSR product with the same padded coefficients."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator(device=device).manual_seed(4242)
    _, op = _g302_operator(device)
    out = {}
    for k in X_SHARDS:
        xl = op.nx // k
        padded = torch.nn.functional.pad(op.coeffs[:, :, :, :xl], (0, 0, 1, 1)).contiguous()
        for B in (8, 16):
            label = f"G302 x{k} B{B}"
            n = 2 * (xl + 2) * op.nt
            v = _randn((B, n), op.dtype, gen, device)
            w = _randn((B, n), op.dtype, gen, device)
            out[label] = _check(label, _cases(sk, {}), padded, v, w, xl + 2, op.nt)
            _add_library_ms(label, out[label], padded, v, w, xl + 2, op.nt)
    return out


def run_g302_ranks(label: str, devices: int, x_shards: int, cfg, reference) -> dict:
    """gateway.G302(devices=N) as a user calls it, held to the JAX package's
    recorded trace and to ``reference``, the one-rank run on the same loop."""
    import math
    import os

    from deflatedmlmc_schwinger_tpu_torch import gateway

    os.environ["DMLMC_X_SHARDS"] = str(x_shards)
    t0 = time.perf_counter()
    try:
        r = gateway.G302(device="cuda", devices=devices)
    finally:
        del os.environ["DMLMC_X_SHARDS"]
    wall = time.perf_counter() - t0
    tr = complex(r["trace"])
    phases, moved, counts = r["phase_seconds"], r["transport_seconds"], r["kernel_launches"]
    diff = abs(tr - reference["trace"]) / abs(reference["trace"])
    print(f"[{label}] backend {r['backend']}, ranks share cuda:0; trace {tr} nr_ests "
          f"{r['nr_ests']} function_iters {r['function_iters']} stalled_rows "
          f"{r['stalled_rows']} ranks agree {r['ranks_agree']} {r['ranks_differ_in'] or ''}; one-rank run on the same loop: "
          f"nr_ests {reference['nr_ests']} function_iters {reference['function_iters']}, "
          f"relative trace difference {diff:.3e}; wall {wall:.3f} s (ranks' start included)")
    print(f"[{label}] rank 0 phase seconds " + " ".join(
        f"{k}={phases.get(k, 0.0):.4f}" for k in ("mg_setup", "defl_setup", "rough_trace",
                                                   "sampling"))
          + f"; in transport {' '.join(f'{k}={v:.4f}' for k, v in moved.items())}; "
          f"sampling: {phases['sampling'] / (r['nr_ests'] / cfg.probe_batch):.4f} s per batch "
          f"of {cfg.probe_batch}, {moved['sampling'] / phases['sampling']:.1%} of it in "
          f"transport (waits for the other ranks included)")
    print(f"[{label}] rank 0 kernel launches {counts}")
    _no_yardstick_launch(f"{label} rank 0", r["yardstick_launches"])
    if not r["ranks_agree"]:
        raise RuntimeError(f"{label}: the ranks returned different results")
    if not all(math.isfinite(x) for x in (tr.real, tr.imag, r["std_dev"])):
        raise RuntimeError(f"{label} produced a non-finite result")
    if abs(tr - REFERENCE_TRACE_G302) > cfg.trace_tol * REFERENCE_TRACE_G302:
        raise RuntimeError(f"{label} trace {tr} is not within {cfg.trace_tol:.0%} of "
                           f"{REFERENCE_TRACE_G302}")
    if r["nr_ests"] != reference["nr_ests"]:
        raise RuntimeError(f"{label} took {r['nr_ests']} probes, the one-rank run "
                           f"{reference['nr_ests']}")
    solved = r["nr_ests"] + max(cfg.nr_rough_iters, cfg.probe_batch)
    if r["stalled_rows"] > cfg.max_stalled_frac * solved:
        raise RuntimeError(f"{label}: {r['stalled_rows']} stalled rows of {solved}")
    must = ("stencil_matvec", "stencil_residual") + (
        () if x_shards > 1 else ("stencil_poly_smooth",))
    missing = [k for k in must if counts[k] <= 0]
    if missing:
        raise RuntimeError(f"{label}: rank 0 did not launch {missing}")
    if x_shards > 1 and counts["stencil_poly_smooth"]:
        raise RuntimeError(f"{label} launched K3, which the lattice-sharded path does not use")
    return dict(counts=counts, wall=wall, result=r)


def check_parallel(device) -> dict:
    """Phase 12. Returns dict(kernels=the padded-block rows, counts={path:
    rank 0's launches})."""
    import numpy as np

    from deflatedmlmc_schwinger_tpu_torch.mg import setup_hierarchy
    from deflatedmlmc_schwinger_tpu_torch.parallel import make_mesh
    from deflatedmlmc_schwinger_tpu_torch.parallel.worker import launch
    from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson
    from deflatedmlmc_schwinger_tpu_torch.trace.stats import RunningMoments
    from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import save_hierarchy

    padded = check_padded_kernels(device)

    for k in X_SHARDS:
        t0 = time.perf_counter()
        ranks = launch("chip_smoke:rank_halo", k, args=(k,), timeout_s=300)
        print(f"[halo x{k}] 512^2, 16 probes, local blocks {ranks[0]['local_shape']}: K1 on the "
              f"padded block vs its plain version "
              f"{max(r['vs_plain'] for r in ranks):.3e}, gathered vs single-device K1 "
              f"{max(r['vs_single'] for r in ranks):.3e}, gathered vs the plain stencil on the "
              f"whole lattice {max(r['vs_whole_plain'] for r in ranks):.3e} (relative, worst "
              f"rank; the plain halo version adds its taps in the kernel's order); "
              f"{ranks[0]['apply_ms']:.3f} ms per apply with its ring exchange; "
              f"{time.perf_counter() - t0:.1f} s with the ranks' start")
        for r in ranks:
            _no_yardstick_launch(f"halo x{k} rank {r['rank']}", r["yardsticks"])
            if not r["finite"] or r["launches"] != 1 or max(
                    r["vs_plain"], r["vs_single"], r["vs_whole_plain"]) > TOL_C64:
                raise RuntimeError(f"halo matvec on {k} x shards, rank {r['rank']}: {r}")

    cfg, op = _g302_operator(device)
    t0 = time.perf_counter()
    hier = setup_hierarchy(op, cfg)
    setup_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        hier_path = str(Path(tmp) / "hierarchy.npz")
        save_hierarchy(hier, hier_path)
        t0 = time.perf_counter()
        ranks = launch("chip_smoke:rank_sharded_solve", 4, args=(hier_path,), timeout_s=600)
        solve_wall = time.perf_counter() - t0
    r0 = ranks[0]
    tol = cfg.solver.effective_tol(cfg.function_tol, cfg.dtype)
    print(f"[sharded solve] mesh (2, 2), G302 hierarchy (built in {setup_s:.2f} s), 16 probes, "
          f"tol {tol:g}: iterations sharded {r0['iters']} replicated {r0['ref_iters']}; "
          f"x differs by {r0['dx']:.3e} relative; worst relative residual {r0['relres']:.3e}; "
          f"stalled {r0['stalled']}; rank 0 launches {r0['counts']}; one solve "
          f"{r0['sharded_s']:.3f} s sharded ({r0['transport']['seconds']:.3f} s in "
          f"{r0['transport']['calls']} transport calls, {r0['transport']['bytes'] / 1e6:.1f} MB) "
          f"against {r0['replicated_s']:.3f} s replicated with 4 ranks taking turns on the "
          f"card; {solve_wall:.1f} s with the ranks' start")
    for r in ranks:
        _no_yardstick_launch(f"sharded solve rank {r['rank']}", r["yardsticks"])
        if (r["iters"], r["dx"]) != (r0["iters"], r0["dx"]):
            raise RuntimeError("the ranks of the sharded solve hold different results")
        if max(abs(a - b) for a, b in zip(r["iters"], r["ref_iters"])) > 1:
            raise RuntimeError(f"sharded iteration counts {r['iters']} vs {r['ref_iters']}")
        if r["dx"] > SOLVE_TOL_FACTOR * tol or r["stalled"] or r["relres"] > tol:
            raise RuntimeError(f"sharded solve, rank {r['rank']}: {r}")
        if r["counts"]["stencil_matvec"] <= 0 or r["counts"]["stencil_residual"] <= 0:
            raise RuntimeError(f"sharded solve, rank {r['rank']} launched {r['counts']}")

    want = RunningMoments()
    want.update_batch(_moment_samples())
    for r in launch("chip_smoke:rank_moments", 4, timeout_s=300):
        n, mean, m2 = r["merged"]
        pn, pmean, pm2 = r["psum"]
        if (n != want.count or abs(mean - want.mean) > 1e-12 or abs(m2 - want.m2) > 1e-9
                or pn != want.count or abs(pmean - want.mean) > 1e-4 * abs(want.mean)
                or abs(pm2 - want.m2) > 0.05 * want.m2):
            raise RuntimeError(f"moment reductions {r} against the host merge {want}")
    print(f"[moments] 4 ranks: allgather_moments equals the host Chan merge (n {want.count}, "
          f"mean to 1e-12, m2 to 1e-9); psum_moments in float32 on the card: mean to 1e-4 "
          f"relative, m2 {pm2:.4f} against {want.m2:.4f}")

    # the one-rank run on the host-gathered loop the mesh runs take
    ref = hutchinson(op, cfg, hier=hier, mesh=make_mesh((1,), device=device), verbose=False)
    print(f"[G302 one rank, host-gathered loop] trace {complex(ref['trace'])} nr_ests "
          f"{ref['nr_ests']} function_iters {ref['function_iters']} sampling "
          f"{ref['timer'].totals['sampling']:.4f} s")
    del hier
    counts = {}
    for label, devices, xs in (("G302 2 ranks", 2, 1), ("G302 4 ranks x2", 4, 2)):
        counts[label] = run_g302_ranks(label, devices, xs, cfg, ref)["counts"]
    return dict(kernels=padded, counts=counts)


# ---- phase 13: the complex64 policies on the 16^2 operator --------------------

# the 3-level 16^2 hierarchy of the JAX package's bias, refinement and stall tests
POLICY_LEVELS = dict(matrix=SMALL_MATRIX, mass=SMALL_MASS, latt_dims=(16, 16),
                     max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4), accuracy_mg_eigvs="low",
                     test_vectors_type="RSVs", use_permuted=False)
BIAS_PROBES = 32
BIAS_BOUNDS = ((1e-12, 1e-3), (5e-4, 5e-3))   # (function_tol, bound on |bias| / |tr|)
REFINE_CUT = 0.1                              # error after 2 refinement steps / before


def check_complex64_policies(device, exact16: complex) -> dict:
    """Phase 13: the estimator policies that guard the trace against bias,
    in complex64 on SMALL_MATRIX (a complex64 operator) through K1 and K2.

    * Stall: with a crippled solver (4 Arnoldi steps, one cycle, against
      function_tol 1e-13, which complex64 clips to its floor) hutchinson and
      mlmc must raise the stall error under the default max_stalled_frac,
      and with max_stalled_frac 1.0 report stalled_rows > 0.
    * Bias: 32 matched Rademacher probes solved in complex64 at the floor
      and at 5e-4 and in complex128 at 1e-13; |mean difference| / |tr| must
      stay below 1e-3 and 5e-3 (tr: ``exact16``, the dense trace).
    * Refinement: hutchinson_deflation in complex64 (k = 16, function_tol
      1e-4) with 0 and 2 float64 refinement steps, each tr1 against
      tr(U^H A^-1 U) from the complex128 inverse of the complex64-rounded
      operator; 2 steps must cut the error at least tenfold.
    Returns the kernel launches of the phase."""
    import numpy as np
    import torch

    from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig, TraceConfig
    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, setup_hierarchy
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk
    from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson, mlmc
    from deflatedmlmc_schwinger_tpu_torch.trace.deflation import hutchinson_deflation

    label = "c64 policies"
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    ops = {dt: load_operator(SMALL_MATRIX, SMALL_MASS, dtype=dt, device=device)[0]
           for dt in (torch.complex64, torch.complex128)}
    op = ops[torch.complex64]

    crippled = TraceConfig(dtype=torch.complex64, trace_tol=10.0, nr_deflat_vctrs=0,
                           mlmc_deflat_vctrs=(0, 0), mlmc_levels_to_skip=(), probe_batch=8,
                           max_nr_ests=16, function_tol=1e-13, chebyshev_degree=8,
                           subspace_iters=1, solver=SolverConfig(restart=4, max_restarts=1),
                           **POLICY_LEVELS)
    solver = MGSolver(setup_hierarchy(op, crippled), crippled.solver)
    for name, estimator in (("hutchinson", hutchinson), ("mlmc", mlmc)):
        try:
            estimator(op, crippled, solver=solver, verbose=False)
        except RuntimeError as err:
            if "stalled" not in str(err):
                raise
            raised = str(err).split(":")[0]
        else:
            raise RuntimeError(f"{label}: the crippled {name} run raised no stall error")
        relaxed = estimator(op, crippled.replace(max_stalled_frac=1.0), solver=solver,
                            verbose=False)
        print(f"[{label}] stall {name}: default policy raised in '{raised}'; with "
              f"max_stalled_frac 1.0 stalled_rows {relaxed['stalled_rows']}, trace "
              f"{complex(relaxed['trace'])}")
        if relaxed["stalled_rows"] <= 0:
            raise RuntimeError(f"{label}: the relaxed crippled {name} run stalled no row")

    bias_cfg = TraceConfig(dtype=torch.complex64, chebyshev_degree=50, subspace_iters=4,
                           **POLICY_LEVELS)
    rng = np.random.default_rng(4242)
    X = torch.from_numpy(rng.choice([-1.0, 1.0], size=(BIAS_PROBES, op.n))).to(
        device=device, dtype=torch.complex128)

    def estimates(dt, tol):
        cfg = bias_cfg.replace(dtype=dt)
        res = MGSolver(setup_hierarchy(ops[dt], cfg), cfg.solver).solve(X.to(dt), tol)
        relres = float((res.resnorm / res.bnorm).max())
        return (X.conj() * res.x.to(torch.complex128)).sum(-1), relres

    oracle, relres = estimates(torch.complex128, 1e-13)
    print(f"[{label}] bias: complex128 oracle of {BIAS_PROBES} probes at 1e-13, max relative "
          f"residual {relres:.3e}")
    if relres > 1e-10:
        raise RuntimeError(f"{label}: the complex128 oracle solves reached only {relres:.3e}")
    for tol, bound in BIAS_BOUNDS:
        e32, relres = estimates(torch.complex64, tol)
        rel_bias = float((e32 - oracle).mean().abs()) / abs(exact16)
        print(f"[{label}] bias: complex64 at function_tol {tol:g} (effective "
              f"{bias_cfg.solver.effective_tol(tol, torch.complex64):g}, max relative residual "
              f"{relres:.3e}): |mean(e64 - e128)| / |tr| = {rel_bias:.3e} (bound {bound:g})")
        if not rel_bias < bound:
            raise RuntimeError(f"{label}: complex64 bias {rel_bias:.3e} at {tol:g} is not "
                               f"below {bound:g}")

    refine_cfg = TraceConfig(dtype=torch.complex64, chebyshev_degree=40, subspace_iters=3,
                             probe_batch=16, nr_deflat_vctrs=16, defl_buffer=16,
                             defl_subspace_rounds=2, defl_eigvs_tol_Hutch=1e-3,
                             function_tol=1e-4, **POLICY_LEVELS)
    solver = MGSolver(setup_hierarchy(op, refine_cfg), refine_cfg.solver)
    eye = torch.eye(op.n, dtype=torch.complex128, device=device)
    D64 = sk.stencil_matvec_plain(op.coeffs.to(torch.complex128), eye, op.nx, op.nt).T
    Ainv = torch.linalg.inv(D64)
    errs = {}
    for steps in (0, 2):
        d = hutchinson_deflation(op, solver, refine_cfg.replace(defl_refine_steps=steps))
        U = d.U.to(torch.complex128)
        oracle_tr1 = complex((U.conj() * (Ainv @ U)).sum().item())
        errs[steps] = abs(d.tr1 - oracle_tr1)
        print(f"[{label}] refinement: {steps} steps, tr1 {d.tr1:.10f}, oracle "
              f"{oracle_tr1:.10f}, error {errs[steps]:.3e} "
              f"({errs[steps] / abs(oracle_tr1):.3e} relative)")
    if not errs[2] <= REFINE_CUT * errs[0]:
        raise RuntimeError(f"{label}: refinement cut the tr1 error from {errs[0]:.3e} to "
                           f"{errs[2]:.3e}, less than tenfold")

    counts = sk.launch_counts()
    print(f"[{label}] kernel launches {counts}; phase {time.perf_counter() - t0:.2f} s")
    missing = [k for k in ("stencil_matvec", "stencil_residual") if counts[k] <= 0]
    if missing:
        raise RuntimeError(f"{label} did not launch {missing}")
    _no_yardstick_launch(label, sk.yardstick_counts())
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

    from deflatedmlmc_schwinger_tpu_torch import gateway

    kernels = check_kernels(device)
    all_kernels = tuple(sk.launch_counts())
    counts = {}
    g301 = run_generated("G301", gateway.G301, gateway.set_params("schwinger256"),
                         REFERENCE_TRACE, device)
    counts["G301"] = g301["counts"]
    flagship = {}
    for label in ("G102", "G202"):
        result, counts[label], wall, stderr = run_profile(
            label, flagship_cfg(), label == "G202", device, all_kernels)
        flagship[label] = (complex(result["trace"]), stderr)
        del result
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exact = dense_displaced_trace(device)
    print(f"[oracle] dense tr(D^-1 Pi^T) = {exact} in {time.perf_counter() - t0:.3f} s "
          f"(complex128 LU on the card)")
    for label, (tr, stderr) in flagship.items():
        check_oracle(label, tr, stderr, exact)

    # the 16^2 profile: GMRES smoother, so K1 and K2 are its kernels
    exact16 = dense_trace_small(device)
    print(f"[oracle] dense tr(D^-1) of {SMALL_MATRIX} at mass {SMALL_MASS} = {exact16} "
          f"(complex128 inverse on the card)")
    for label in ("G101", "G201"):
        result, counts[label], wall, stderr = run_profile(
            label, small_cfg(), label == "G201", device,
            ("stencil_matvec", "stencil_residual"))
        if counts[label]["stencil_poly_smooth"]:
            raise RuntimeError(f"{label} launched K3, but its smoother is GMRES")
        check_oracle(label, complex(result["trace"]), stderr, exact16)
        del result

    g302 = run_generated("G302", gateway.G302, gateway.set_params("schwinger512"),
                         REFERENCE_TRACE_G302, device)
    counts["G302"] = g302["counts"]
    del g302
    torch.cuda.empty_cache()

    # the 256^2 profile on the device setup backend, beside G301's host one
    from deflatedmlmc_schwinger_tpu_torch.examples import EXAMPLE_001

    dev_cfg = gateway.set_params("schwinger256").replace(setup_backend="device")
    g301_dev = run_generated(
        "G301 device setup", lambda device: EXAMPLE_001(dev_cfg, device=device), dev_cfg,
        REFERENCE_TRACE, device)
    counts["G301 device setup"] = g301_dev["counts"]
    for name, run in (("host", g301), ("device", g301_dev)):
        r = run["result"]
        print(f"[setup backends] {name}: mg_setup {r['timer'].totals['mg_setup']:.4f} s, "
              f"{r['function_iters'] / r['nr_ests']:.3f} outer iterations per probe, "
              f"trace {complex(r['trace'])}")
    del g301, g301_dev
    torch.cuda.empty_cache()

    check_checkpoint_resume(device)
    time_fused_precond_matvec(device)
    torch.cuda.empty_cache()
    ranks = check_parallel(device)
    kernels.update(ranks["kernels"])
    counts.update(ranks["counts"])
    counts["c64 policies"] = check_complex64_policies(device, exact16)

    entries = []
    for name, replaces in REPLACES.items():
        key = name if name != "stencil_poly_smooth" else f"{name} depth 16"
        depth4_key = name if name != "stencil_poly_smooth" else f"{name} depth 4"
        k102 = kernels["G102"][key]
        # the other shapes a path gives this kernel (K3 is on no 16^2 path)
        others = {lbl: res[depth4_key] for lbl, res in kernels.items()
                  if lbl != "G102" and depth4_key in res}
        per_path = {p: c[name] for p, c in counts.items()}
        entry = dict(
            name=name, route="cuda", source=KERNEL_SOURCE, replaces=replaces,
            launches=sum(per_path.values()), launches_per_path=per_path,
            max_abs_err=k102["max_abs_err"], ms=k102["ms"], plain_ms=k102["plain_ms"],
            bound_ms=k102["bound_ms"], bound_by=k102["bound_by"],
            library_ms=k102.get("library_ms"), shapes="G102",
            other_shapes={lbl: {k: res.get(k) for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for lbl, res in others.items()})
        if name in ROW_KERNELS:
            row_fields = dict(per_site_kernel_ms="other_ms", device_ms="device_ms",
                              per_site_device_ms="other_device_ms", host_us="host_us",
                              per_site_host_us="other_host_us")
            entry.update({f: k102[src] for f, src in row_fields.items()})
            for lbl, res in others.items():
                entry["other_shapes"][lbl].update({f: res[src] for f, src in row_fields.items()})
        if name == "stencil_poly_smooth":
            # launches count the tiled kernel's launches, several roots each
            entry["per_root_kernel_ms"] = k102["other_ms"]
            for lbl, res in others.items():
                entry["other_shapes"][lbl]["per_root_kernel_ms"] = res["other_ms"]
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
