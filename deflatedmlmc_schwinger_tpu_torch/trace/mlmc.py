"""Deflated multigrid multilevel Monte Carlo trace estimator (counterpart of
deflatedmlmc_schwinger_tpu/trace/mlmc.py).

Telescoping sum over the MG hierarchy:
  tr(A_0^{-1}) = sum_l tr(A_l^{-1} - P_l A_{l+1}^{-1} R_l) + tr(A_coarsest^{-1}),
each difference level estimated stochastically against its share of the
tolerance budget (or computed exactly from dense float64 inverses when its
operators are at most ``mlmc_exact_dense_max_n`` wide), the coarsest level
exactly from the dense coarsest inverse. Skipping level 1 collapses levels 1
and 2 into one composite difference. With ``mlmc_fine_deflation`` the
level-0 difference probes reuse the Hutchinson gamma3 basis, and the
projected-out part is added back exactly with one batch of basis-vector
solves.

Displaced trace: probes go through Pi_l^T and the accumulated B-block
operator, and the coarsest term becomes tr(Pi_c^T A_c^{-1} B_c).

Sampling runs on the operator's device. The sequential schedule samples
each level with the device-resident loop of trace/stats.py sample_to_stop;
the adaptive schedule gathers each batch on the host, because its greedy
allocation needs the moments there, and so does every run with
``checkpoint_dir``, which saves the per-level state after each batch.

One deliberate deviation from the JAX package: the complexity model charges
each dense inverse once. The JAX package charges every dense-exact level
n_f^3 + n_c^3, although the fine inverse is shared with the coarse apply of
a finer level and the coarsest inverse is already charged on the coarsest
level. So ``results[l]["level_complexity"]`` of a dense-exact level l, and
``total_complexity``, are lower here than there (in the 128^2 MLMC profile
by 512^3 on level 2); every trace, deviation and count is the same.

With ``mesh`` every rank of the mesh makes the same call: each probe batch
is split over the samples axis, the level-0 solves run lattice-sharded when
the mesh has a lattice axis of more than one rank (coarse levels always run
replicated), and every batch is gathered on the host, identical on every
rank (trace/hutchinson.py).
"""

from __future__ import annotations

import os
import time
from math import sqrt
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from deflatedmlmc_schwinger_tpu_torch.config import (
    TraceConfig,
    pin_full_precision_matmuls,
    real_dtype,
)
from deflatedmlmc_schwinger_tpu_torch.mg.cycle import MGSolver
from deflatedmlmc_schwinger_tpu_torch.mg.diff_op import level_structure
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import Hierarchy
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import (
    shift_rows_down,
    shift_rows_up,
    stencil_matvec_host,
)
from deflatedmlmc_schwinger_tpu_torch.trace.deflation import (
    Deflation,
    deflate,
    hutchinson_deflation,
    mlmc_level_deflation,
    replicate_deflation,
    solve_refined_host,
)
from deflatedmlmc_schwinger_tpu_torch.trace.hutchinson import (
    gather_rows,
    hutchinson_step_batch,
    make_fine_solver,
    sample_rows,
)
from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source
from deflatedmlmc_schwinger_tpu_torch.trace.stats import (
    ConfirmedStop,
    RunningMoments,
    check_stalled,
    sample_to_stop,
    sample_to_stop_host,
)
from deflatedmlmc_schwinger_tpu_torch.utils.flops import flops_vcycle, level_nnz
from deflatedmlmc_schwinger_tpu_torch.utils.timer import PhaseTimer, span


def bblock_apply(hier: Hierarchy, level: int, v: torch.Tensor) -> torch.Tensor:
    """Apply the accumulated B-block operator B_l (lazy composition):
    B_0 = I;  B_l = R_{l-1} B_{l-1} Pi_{l-1}^H P_{l-1} Pi_l."""
    if level == 0:
        return v
    w = shift_rows_up(v, hier.levels[level].perm_shift)
    w = hier.levels[level - 1].P.apply(w)
    w = shift_rows_down(w, hier.levels[level - 1].perm_shift)
    w = bblock_apply(hier, level - 1, w)
    return hier.levels[level - 1].P.apply_adjoint(w)


def bblock_matrix(hier: Hierarchy, level: int) -> np.ndarray:
    """B_l as a host complex (n_l, n_l) matrix, through bblock_apply."""
    lev = hier.levels[level]
    eye = torch.eye(lev.n, dtype=lev.op.dtype, device=hier.coarsest_inv.device)
    return bblock_apply(hier, level, eye).cpu().numpy().T   # row j = B e_j


def bblock_matrix_host(hier: Hierarchy, level: int) -> np.ndarray:
    """B_l built on the host from sparse products (P is aggregate-block-
    diagonal, Pi a cyclic permutation), as a dense complex128 matrix."""
    def P_sparse(P) -> sp.csr_matrix:
        b = P.blocks.detach().cpu().numpy().astype(np.complex128)
        return sp.block_diag(list(b), format="csr")

    def Pi(n: int, d: int) -> sp.csr_matrix:
        rows = np.arange(n)
        return sp.csr_matrix((np.ones(n), (rows, (rows + d) % n)), shape=(n, n))

    B = sp.identity(hier.levels[0].n, format="csr", dtype=np.complex128)
    for l in range(1, level + 1):
        Pl = P_sparse(hier.levels[l - 1].P)
        Pi_prev = Pi(hier.levels[l - 1].n, hier.levels[l - 1].perm_shift)
        Pi_l = Pi(hier.levels[l].n, hier.levels[l].perm_shift)
        B = Pl.conj().T @ (B @ (Pi_prev.conj().T @ (Pl @ Pi_l)))
    return np.asarray(B.todense())


def dense_level_inverse(hier: Hierarchy, level: int) -> np.ndarray:
    """Host complex128 dense inverse of a level operator. The inversion is
    always float64: the coarse Galerkin operators are ill-conditioned, and
    an exact level's error is outside the stopping rule. A stencil level is
    materialized on the host in complex128."""
    op = hier.levels[level].op
    n = hier.levels[level].n
    if hasattr(op, "complex_matrix"):
        M = np.asarray(op.complex_matrix()).astype(np.complex128)
    elif hasattr(op, "coeffs") and hasattr(op, "nx"):
        C = op.host_coeffs().astype(np.complex128)
        M = stencil_matvec_host(C, np.eye(n, dtype=np.complex128), op.nx, op.nt).T
    else:
        eye = torch.eye(n, dtype=op.dtype, device=hier.coarsest_inv.device)
        M = op.matvec(eye).cpu().numpy().astype(np.complex128).T
    return np.linalg.inv(M)


def _coarse_level(level: int, skip_level: bool) -> int:
    return level + 2 if (skip_level and level == 0) else level + 1


def exact_difference_trace(hier: Hierarchy, level: int, skip_level: bool,
                           use_permuted: bool, *, Ac_inv: Optional[np.ndarray] = None,
                           Af_inv: Optional[np.ndarray] = None) -> complex:
    """tr((A_l^{-1} - P_l A_c^{-1} R_l) B_l Pi_l^T) on the host in float64;
    ``Ac_inv``/``Af_inv`` reuse precomputed dense inverses."""
    coarse = _coarse_level(level, skip_level)
    if Af_inv is None:
        Af_inv = dense_level_inverse(hier, level)
    P = hier.levels[level].P.to_dense()
    if skip_level and level == 0:
        P = P @ hier.levels[1].P.to_dense()
    if Ac_inv is None:
        Ac_inv = dense_level_inverse(hier, coarse)
    M = Af_inv - P @ Ac_inv @ P.conj().T
    if not use_permuted:
        return complex(np.trace(M))
    # tr(M N) = sum(M * N^T) with N = B_l Pi_l^T, a column roll of B_l
    N = np.roll(bblock_matrix_host(hier, level), -hier.levels[level].perm_shift, axis=1)
    return complex(np.sum(M * N.T))


def mlmc_step_batch(solver: MGSolver, cfg: TraceConfig, level: int,
                    defl: Deflation, probes: torch.Tensor, skip_level: bool,
                    fine_solver=None, gather: bool = True,
                    coarse_dense_inv: Optional[torch.Tensor] = None, mesh=None):
    """One batch of difference-level estimates for (B, n_l) probes. Returns
    (estimates (B,), fine iterations (B,), coarse iterations (B,),
    coarse_level, stalled (B,)), on the host or, with ``gather=False``, as
    device tensors. ``coarse_dense_inv``: a dense inverse of the coarse
    operator that replaces the iterative coarse solve by one matmul.

    ``fine_solver``: the lattice-sharded solver for the level-0 systems; it
    takes the whole batch, and the rest of such a step runs on the whole
    batch on every rank. ``mesh``: otherwise every rank takes its rows of
    the batch and the results are gathered (trace/hutchinson.py
    ``sample_rows``)."""
    with span("est.batch"):
        hier = solver.hier
        fine, coarse, restrict, prolong = level_structure(solver, level, skip_level)
        coarsest = hier.nr_levels - 1
        sharded_fine = fine_solver is not None and fine == 0
        rows_mesh = None
        if not sharded_fine:
            probes, rows_mesh = sample_rows(probes, mesh, cfg)
        pred_group = None if rows_mesh is None else rows_mesh.world
        x0 = probes
        with span("est.deflate"):
            if defl.U is not None and cfg.defl_type == "inexact_03":
                # oblique projector x - V (U^H A V)^{-1} U^H A x
                t = solver.matvec(level)(x0) @ defl.aux_V.conj()          # (B, k)
                x_def = x0 - (t @ defl.proj_B.T) @ defl.U.T
            else:
                x_def = deflate(x0, defl.U)
            if cfg.use_permuted:
                x_def = shift_rows_down(x_def, hier.levels[level].perm_shift)
                x_def = bblock_apply(hier, level, x_def)

        if sharded_fine:
            res_f = fine_solver.solve(x_def, cfg.function_tol)
        else:
            res_f = solver.solve(x_def, cfg.function_tol, level=fine, pred_group=pred_group)
        e1 = (x0.conj() * res_f.x).sum(-1)
        with span("est.coarse"):
            xc = restrict(x_def)
            ones = torch.ones(x0.shape[0], dtype=torch.int32, device=x0.device)
            if coarse == coarsest:
                y, iters2, stalled = solver.coarsest_solve(xc), ones, res_f.stalled
            elif coarse_dense_inv is not None:
                y, iters2, stalled = xc @ coarse_dense_inv.T, ones, res_f.stalled
            else:
                res_c = solver.solve(xc, cfg.function_tol, level=coarse,
                                     pred_group=pred_group)
                y, iters2, stalled = res_c.x, res_c.iters, res_f.stalled | res_c.stalled
            e = e1 - (x0.conj() * prolong(y)).sum(-1)
        if not gather:
            if rows_mesh is not None:
                raise ValueError("a batch split over a mesh is gathered on the host")
            return e, res_f.iters, iters2, coarse, stalled
        es, it1, it2, stall = gather_rows(rows_mesh, cfg, e, res_f.iters, iters2, stalled)
        return es, it1, it2, coarse, stall


def _adaptive_sampling(solver: MGSolver, cfg: TraceConfig, defls, rough_trace,
                       results, probe_source: str, skip_level: bool, log,
                       exact_set, dense_invs, state, save_level, fine_solver=None,
                       mesh=None) -> None:
    """Optimal-allocation MLMC sampling: batches go one at a time to the
    level with the largest drop of the aggregate variance sqrt(sum V_l/n_l)
    per second of batch time, until the aggregate standard error meets the
    whole budget |trace_tol * rough_trace| (times stop_safety). ``state``
    carries the levels' moments and next sample indices of a resumed run;
    ``save_level(i, moments, next_start)`` persists them after a batch."""
    hier = solver.hier
    B = int(cfg.probe_batch)
    device = hier.coarsest_inv.device
    eps_tot = cfg.stop_safety * abs(cfg.trace_tol * rough_trace)
    # dense-exact levels have no variance and take no samples
    active = [i for i in range(hier.nr_levels - 1)
              if not (skip_level and i == 1) and i not in exact_set]
    probes = {i: make_probe_source(probe_source, cfg.seed + i, device) for i in active}
    moments = {i: state.moments.get(f"level{i}", RunningMoments()) for i in active}
    starts = {i: state.next_index.get(f"level{i}", 0) for i in active}
    costs: Dict[int, list] = {i: [] for i in active}

    def run_batch(i: int) -> None:
        t0 = time.perf_counter()
        lev = hier.levels[i]
        X = probes[i](starts[i], B, lev.n, lev.op.dtype)
        es, it1, it2, coarse, stall = mlmc_step_batch(
            solver, cfg, i, defls[i], X, skip_level, fine_solver,
            coarse_dense_inv=dense_invs.get(_coarse_level(i, skip_level)), mesh=mesh)
        moments[i].update_batch(es)
        results[i]["function_iters"] += int(np.sum(it1))
        results[coarse]["function_iters"] += int(np.sum(it2))
        results[i]["stalled_rows"] += int(np.sum(stall))
        starts[i] += B
        check_stalled(results[i]["stalled_rows"], moments[i].count,
                      cfg.max_stalled_frac, f"mlmc level {i}")
        dt = time.perf_counter() - t0
        if mesh is not None:
            # every rank must send the next batch to the same level: all take
            # the slowest rank's time for this one
            from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import (
                all_gather_cat,
            )

            dt = float(all_gather_cat(
                torch.tensor([dt], dtype=torch.float64, device=mesh.device),
                mesh.world).max())
        c = costs[i]
        if len(c) == 1:
            c[0] = dt     # drop the first, warm-up-skewed measurement
        c.append(dt)
        save_level(i, moments[i], starts[i])

    def agg_var() -> float:
        return sum(moments[i].std_dev ** 2 / moments[i].count
                   for i in active if moments[i].count)

    def benefit(i: int) -> float:
        m = moments[i]
        v = m.std_dev ** 2
        gain = v / m.count - v / (m.count + B)
        cost = float(np.median(costs[i])) if costs[i] else 1.0
        return gain / max(cost, 1e-9)

    for i in active:          # warm-up: one batch per level gives (V_l, C_l)
        if moments[i].count == 0:
            run_batch(i)
    stopper = ConfirmedStop(cfg.stop_confirm)
    while any(starts[i] < cfg.max_nr_ests for i in active):
        done = all(moments[i].count >= cfg.min_nr_ests for i in active)
        total_n = sum(moments[i].count for i in active)
        if stopper(done and agg_var() < eps_tot * eps_tot, total_n):
            break
        run_batch(max((i for i in active if starts[i] < cfg.max_nr_ests), key=benefit))
    for i in active:
        results[i]["nr_ests"] += moments[i].count
        results[i]["ests_avg"] = moments[i].mean + defls[i].tr1
        results[i]["ests_dev"] = moments[i].std_dev
        log(f"level {i}: {moments[i].count} ests (adaptive), trace "
            f"{results[i]['ests_avg']:.6f}, dev {moments[i].std_dev:.4f}")


def _sequential_level(solver: MGSolver, cfg: TraceConfig, i: int, defl: Deflation,
                      level_trace_tol: float, results, probe_source: str,
                      skip_level: bool, coarse_dense_inv, log, state=None,
                      save_level=None, fine_solver=None, mesh=None) -> RunningMoments:
    """Sample difference level i to its own stopping rule; the coarse
    solves' iterations go to the coarse level. Without ``state`` the moments
    stay on the device (trace/stats.py sample_to_stop); with the
    EstimatorState of a checkpointed run, or of a run over a mesh, the level
    continues from its saved moments and sample index on the host loop, and
    ``save_level`` persists them after every batch."""
    lev = solver.hier.levels[i]
    device = solver.hier.coarsest_inv.device
    rdt = real_dtype(lev.op.dtype)
    B = int(cfg.probe_batch)
    probes = make_probe_source(probe_source, cfg.seed + i, device)
    if state is not None:
        moments = state.moments.get(f"level{i}", RunningMoments())
        start = state.next_index.get(f"level{i}", 0)
        if start:
            log(f"level {i}: resuming at sample {start} (n={moments.count})")

        def host_step(s: int):
            return mlmc_step_batch(
                solver, cfg, i, defl, probes(s, B, lev.n, lev.op.dtype), skip_level,
                fine_solver, coarse_dense_inv=coarse_dense_inv, mesh=mesh)

        def after_batch(batch, next_start: int) -> None:
            _, it1, it2, coarse, stall = batch
            results[i]["function_iters"] += int(np.sum(it1))
            results[coarse]["function_iters"] += int(np.sum(it2))
            results[i]["stalled_rows"] += int(np.sum(stall))
            check_stalled(results[i]["stalled_rows"], moments.count,
                          cfg.max_stalled_frac, f"mlmc level {i}")
            save_level(i, moments, next_start)

        sample_to_stop_host(host_step, cfg, level_trace_tol, moments, start,
                            after_batch, check_before_batch=True)
        return moments
    coarse_iters = [torch.zeros((), dtype=rdt, device=device)]

    def step(start: int):
        e, it1, it2, _, stall = mlmc_step_batch(
            solver, cfg, i, defl, probes(start, B, lev.n, lev.op.dtype), skip_level,
            fine_solver, gather=False, coarse_dense_inv=coarse_dense_inv)
        coarse_iters[0] = coarse_iters[0] + it2.sum().to(rdt)
        return e, it1, stall

    moments, iters, nstall = sample_to_stop(step, cfg, level_trace_tol,
                                            f"mlmc level {i}", rdt, device)
    results[i]["function_iters"] += iters
    results[i]["stalled_rows"] += nstall
    results[_coarse_level(i, skip_level)]["function_iters"] += int(coarse_iters[0].item())
    return moments


def _tolerance_fractions(nr_levels: int, skip_level: bool):
    """Per-level variance-budget split of the sequential schedule."""
    if nr_levels < 3:
        raise ValueError("MLMC needs at least three levels")
    f0, f1 = (0.8, 0.2) if nr_levels == 3 else (0.45, 0.45)
    if skip_level:
        f0 = f0 + f1
    return f0, f1


def _level_tol_factor(i: int, nr_levels: int, f0: float, f1: float,
                      skip_level: bool) -> float:
    """The share of the tolerance given to level i."""
    if i == 0:
        return sqrt(f0)
    if i == 1:
        return sqrt(f1)
    if skip_level:
        return sqrt(1.0 - f0) / sqrt(nr_levels - 3)
    return sqrt(1.0 - f0 - f1) / sqrt(nr_levels - 3)


def mlmc(
    op,
    cfg: TraceConfig,
    *,
    hier: Optional[Hierarchy] = None,
    solver: Optional[MGSolver] = None,
    probe_source: str = "torch",
    timer: Optional[PhaseTimer] = None,
    verbose: bool = True,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
) -> Dict:
    """Compute tr(A^{-1}) (or tr(A^{-1} Pi)) by deflated MG-MLMC on the
    device that holds ``op``.

    ``checkpoint_dir``: if set, the hierarchy is cached there
    (hierarchy.npz) and the sampling state of every difference level
    (moments, next sample index, iterations) is saved after each batch
    (mlmc_state.json); an interrupted run resumes each level on the same
    counter-keyed probe stream.

    ``mesh``: probe batches split over its samples axis, level-0 solves over
    its lattice axis if it has one. Only rank 0 logs and writes
    checkpoints."""
    # utils.checkpoint imports trace.stats, so it is imported here and not
    # at the top of this module
    from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import (
        EstimatorState,
        setup_or_load_hierarchy,
    )

    pin_full_precision_matmuls()
    timer = timer or PhaseTimer(op.device)
    lead = mesh is None or mesh.rank == 0
    log = print if (verbose and lead) else (lambda *a, **k: None)
    state_ckpt = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        state_ckpt = os.path.join(checkpoint_dir, "mlmc_state.json")

    skips = list(cfg.mlmc_levels_to_skip)
    if len(skips) > 1:
        raise ValueError("level skipping supports at most one skipped level")
    skip_level = len(skips) == 1
    if skip_level and skips[0] != 1:
        raise ValueError("only level 1 can be skipped (composite P0*P1 form)")
    if (cfg.mlmc_fine_deflation and len(cfg.mlmc_deflat_vctrs)
            and int(cfg.mlmc_deflat_vctrs[0]) > 0):
        raise ValueError("mlmc_fine_deflation replaces the level-0 difference-"
                         "operator deflation; set mlmc_deflat_vctrs[0] = 0")

    if solver is None:
        with timer.phase("mg_setup"):
            if hier is None and lead:
                hier = setup_or_load_hierarchy(op, cfg, checkpoint_dir, log)
            if mesh is not None:
                # rank 0's hierarchy, bit-identical on every rank
                from deflatedmlmc_schwinger_tpu_torch.parallel.mesh import replicate

                hier = replicate(hier, mesh)
            solver = MGSolver(hier, cfg.solver)
    else:
        hier = solver.hier
    nr_levels = hier.nr_levels
    if nr_levels < 3:
        raise ValueError("MLMC needs a hierarchy of at least three levels")
    log(f"MG hierarchy sizes: {hier.sizes()}")
    fine_solver = make_fine_solver(hier, mesh, cfg, log)

    def replicated(d: Deflation) -> Deflation:
        return d if mesh is None else replicate_deflation(d, mesh)
    coarsest = nr_levels - 1
    device = op.device

    # ---- dense-exact levels and dense coarse inverses ----
    cutoff = int(cfg.mlmc_exact_dense_max_n)
    exact_set = set()
    if cutoff:
        exact_set = {l for l in range(nr_levels - 1)
                     if not (skip_level and l == 1) and hier.levels[l].n <= cutoff}
    dense_inv_host: Dict[int, np.ndarray] = {}
    dense_invs: Dict[int, torch.Tensor] = {}
    if cutoff:
        with timer.phase("dense_setup"):
            for l in range(nr_levels - 1):
                if (skip_level and l == 1) or l in exact_set:
                    continue
                c = _coarse_level(l, skip_level)
                if c != coarsest and hier.levels[c].n <= cutoff:
                    if c not in dense_inv_host:
                        dense_inv_host[c] = dense_level_inverse(hier, c)
                    dense_invs[c] = torch.from_numpy(dense_inv_host[c]).to(
                        device=device, dtype=hier.levels[c].op.dtype)
        if exact_set:
            log(f"dense-exact difference levels: {sorted(exact_set)}")

    # ---- per-level deflation ----
    defls: List[Deflation] = []
    hutch_defl = None
    with timer.phase("defl_setup"):
        if cfg.mlmc_fine_deflation and 0 not in exact_set:
            hutch_defl = replicated(hutchinson_deflation(op, solver, cfg,
                                                         fine_solver=fine_solver))
        for i in range(nr_levels - 1):
            if (skip_level and i == 1) or i in exact_set:
                defls.append(Deflation(U=None, tr1=0.0 + 0.0j))
            elif i == 0 and hutch_defl is not None:
                defls.append(replicated(_fine_deflation_addback(
                    op, solver, cfg, hutch_defl, skip_level, dense_invs, fine_solver)))
            else:
                k = int(cfg.mlmc_deflat_vctrs[i]) if i < len(cfg.mlmc_deflat_vctrs) else 0
                defls.append(replicated(mlmc_level_deflation(solver, i, k, cfg,
                                                             skip_level)))

    # ---- rough trace ----
    with timer.phase("rough_trace"):
        if hutch_defl is not None:
            rough_defl = hutch_defl
        else:
            # the rough trace only sets the stopping target, so its basis may
            # be cheaper than the Hutchinson estimator's
            rough_cfg = cfg
            if cfg.rough_deflat_vctrs is not None:
                rough_cfg = cfg.replace(nr_deflat_vctrs=cfg.rough_deflat_vctrs)
            rough_defl = replicated(hutchinson_deflation(
                op, solver, rough_cfg, rounds=cfg.rough_defl_rounds,
                fine_solver=fine_solver))
        rough_probes = make_probe_source(probe_source, cfg.rough_seed, device)
        Br = max(int(cfg.nr_rough_iters), int(cfg.probe_batch))
        X = rough_probes(0, Br, op.n, op.dtype)
        es, _, stall = hutchinson_step_batch(op, solver, cfg, rough_defl, X, fine_solver,
                                             mesh=mesh)
        n_rough = Br if cfg.rough_batch_full else int(cfg.nr_rough_iters)
        rough_trace = complex(np.mean(es[:n_rough])) + rough_defl.tr1
    check_stalled(int(np.sum(stall)), Br, cfg.max_stalled_frac, "mlmc rough trace")
    log(f"rough trace: {rough_trace:.6f}")

    results = [dict(function_iters=0, nr_ests=0, ests_avg=0.0 + 0.0j, ests_dev=0.0,
                    level_complexity=0.0, stalled_rows=0)
               for _ in range(nr_levels)]
    for i in range(nr_levels):
        solver.coarsest_lev_iters[i] = 0
        if fine_solver is not None:
            fine_solver.coarsest_lev_iters[i] = 0

    # ---- dense-exact difference levels (no variance; host float64) ----
    if exact_set:
        with timer.phase("exact_levels"):
            for l in sorted(exact_set):
                t_l = exact_difference_trace(
                    hier, l, skip_level, cfg.use_permuted,
                    Ac_inv=dense_inv_host.get(_coarse_level(l, skip_level)),
                    Af_inv=dense_inv_host.get(l))
                results[l].update(nr_ests=1, ests_avg=t_l, ests_dev=0.0)
                log(f"level {l}: exact dense difference trace {t_l:.6f}")

    # ---- difference-level sampling ----
    state = EstimatorState.load_or_empty(state_ckpt)
    for j in range(nr_levels):
        results[j]["function_iters"] = int(state.iters.get(f"level{j}", 0))

    def save_level(i: int, moments: RunningMoments, next_start: int) -> None:
        if state_ckpt is None or not lead:
            return
        state.moments[f"level{i}"] = moments
        state.next_index[f"level{i}"] = next_start
        state.iters = {f"level{j}": results[j]["function_iters"]
                       for j in range(nr_levels)}
        state.save(state_ckpt)

    if cfg.mlmc_schedule == "adaptive":
        with timer.phase("sampling"):
            _adaptive_sampling(solver, cfg, defls, rough_trace, results,
                               probe_source, skip_level, log, exact_set, dense_invs,
                               state, save_level, fine_solver, mesh)
    elif cfg.mlmc_schedule != "sequential":
        raise ValueError(f"unknown mlmc_schedule {cfg.mlmc_schedule!r}")
    else:
        f0, f1 = _tolerance_fractions(nr_levels, skip_level)
        with timer.phase("sampling"):
            for i in range(nr_levels - 1):
                if (skip_level and i == 1) or i in exact_set:
                    continue
                tol_fctr = _level_tol_factor(i, nr_levels, f0, f1, skip_level)
                level_trace_tol = cfg.stop_safety * abs(cfg.trace_tol * rough_trace
                                                        * tol_fctr)
                moments = _sequential_level(
                    solver, cfg, i, defls[i], level_trace_tol, results, probe_source,
                    skip_level, dense_invs.get(_coarse_level(i, skip_level)), log,
                    state if (state_ckpt or mesh is not None) else None, save_level,
                    fine_solver, mesh)
                results[i]["nr_ests"] += moments.count
                results[i]["ests_avg"] = moments.mean + defls[i].tr1
                results[i]["ests_dev"] = moments.std_dev
                log(f"level {i}: {moments.count} ests, trace "
                    f"{results[i]['ests_avg']:.6f}, dev {moments.std_dev:.4f}")

    # ---- exact coarsest trace ----
    with timer.phase("coarsest"):
        if hier.levels[-1].n == 1:
            raise ValueError("coarsest-level operator is a scalar; refusing the "
                             "trivial exact trace")
        if not cfg.coarsest_level_directly:
            raise NotImplementedError("only the direct (dense-inverse) coarsest-"
                                      "level trace is implemented")
        results[-1]["nr_ests"] += 1
        M = hier.coarsest_inv.cpu().numpy()
        if cfg.use_permuted:
            M = M @ bblock_matrix_host(hier, coarsest)
            M = np.roll(M, hier.levels[-1].perm_shift, axis=0)    # Pi_c^T @ M
        results[-1]["ests_avg"] = complex(np.trace(M))
        results[-1]["ests_dev"] = 0.0
    log(f"coarsest exact trace: {results[-1]['ests_avg']:.6f}")

    # ---- complexity model and aggregation ----
    nnz = level_nnz(hier)
    charged = {coarsest}      # each dense inverse is charged once
    for i in range(nr_levels - 1):
        if i in exact_set:
            cost = 0.0
            for l in (i, _coarse_level(i, skip_level)):
                if l not in charged:
                    cost += float(hier.levels[l].n) ** 3
                    charged.add(l)
            results[i]["level_complexity"] = cost
            continue
        results[i]["level_complexity"] = results[i]["function_iters"] * flops_vcycle(
            nnz, solver.cfg.smooth_iters, i, i)
        results[i]["level_complexity"] += nnz[-1] * int(solver.coarsest_lev_iters[i])
        if fine_solver is not None:
            results[i]["level_complexity"] += nnz[-1] * int(
                fine_solver.coarsest_lev_iters[i])
    n_c = float(hier.levels[-1].n)
    results[-1]["level_complexity"] = n_c ** 3 + results[-1]["function_iters"] * n_c ** 2

    # the level estimates are independent: stderr(sum)^2 = sum dev_l^2 / n_l
    agg_stderr = sqrt(sum(r["ests_dev"] ** 2 / r["nr_ests"]
                          for r in results[:-1] if r["nr_ests"] > 0))
    return dict(
        nr_levels=nr_levels,
        results=results,
        rough_trace=rough_trace,
        std_dev=agg_stderr,
        trace=sum(r["ests_avg"] for r in results),
        total_complexity=sum(r["level_complexity"] for r in results),
        stalled_rows=sum(r["stalled_rows"] for r in results),
        # the fine-level (or rough-trace) gamma3 deflation, and the stalled
        # exact-correction solves of all deflations
        deflation=rough_defl,
        defl_stalled_rows=(sum(d.stalled_rows for d in defls)
                           + (0 if rough_defl is hutch_defl else rough_defl.stalled_rows)),
        timer=timer,
    )


def _fine_deflation_addback(op, solver: MGSolver, cfg: TraceConfig,
                            hutch_defl: Deflation, skip_level: bool,
                            dense_invs, fine_solver=None) -> Deflation:
    """Level-0 deflation that reuses the Hutchinson gamma3 basis U, with the
    projected-out subspace added back exactly by one batch of basis-vector
    probes: tr(M_0 U U^H) = sum_i <U_i, M_0 U_i>, M_0 the level-0 difference
    map. The fine solve takes the setup solver profile (or the
    lattice-sharded ``fine_solver``) and float64 host-residual refinement;
    the coarse term applies the dense inverse (safe for low-mode right-hand
    sides) or solves."""
    hier = solver.hier
    coarsest = hier.nr_levels - 1
    rows = hutch_defl.U.T                                  # (k, n)
    k = rows.shape[0]
    _, coarse0, restrict0, prolong0 = level_structure(solver, 0, skip_level)
    x1 = rows
    if cfg.use_permuted:
        x1 = bblock_apply(hier, 0, shift_rows_down(x1, hier.levels[0].perm_shift))
    Z, stalled = solve_refined_host(fine_solver or solver.derived(cfg.defl_solver), op, x1,
                                    cfg.function_tol, int(cfg.defl_refine_steps),
                                    int(cfg.probe_batch))
    check_stalled(int(np.sum(stalled)), k, cfg.max_stalled_frac,
                  "mlmc level-0 deflation correction")
    Uh = rows.cpu().numpy().astype(np.complex128)
    e1 = np.sum(np.conj(Uh) * Z, axis=1)
    xc = restrict0(x1)
    cdi0 = dense_invs.get(coarse0)
    if coarse0 == coarsest:
        y = solver.coarsest_solve(xc)
    elif cdi0 is not None:
        y = xc @ cdi0.T
    else:
        y = solver.solve(xc, cfg.function_tol, level=coarse0).x
    e2 = (rows.conj() * prolong0(y)).sum(-1).cpu().numpy().astype(np.complex128)
    return Deflation(U=hutch_defl.U, tr1=complex(np.sum(e1 - e2)),
                     stalled_rows=hutch_defl.stalled_rows + int(np.sum(stalled)))
