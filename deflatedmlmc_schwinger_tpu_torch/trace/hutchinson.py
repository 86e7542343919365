"""Deflated Hutchinson trace estimator (counterpart of
deflatedmlmc_schwinger_tpu/trace/hutchinson.py).

MG setup -> deflation precompute -> rough trace -> batched probe sampling
with the stderr stopping rule (trace/stats.py sample_to_stop) -> result
dict with the analytic complexity model. Probes are solved a batch at a
time by one MG-preconditioned FGMRES call. With ``checkpoint_dir`` the
hierarchy is cached and the sampling state saved after every batch, and the
moments are then kept on the host (trace/stats.py sample_to_stop_host).

With ``mesh`` (parallel/mesh.py; every rank of the mesh makes the same call)
each probe batch is split over the mesh's samples axis, and with a lattice
axis of more than one rank the fine-level solves run lattice-sharded
(parallel/sharded_solve.py). Rank 0 builds the hierarchy and the deflation,
every rank receives bit-identical copies, and every rank sees the same
gathered estimates, so all take the same stopping decision and return the
same result.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.config import (
    TraceConfig,
    pin_full_precision_matmuls,
    real_dtype,
)
from deflatedmlmc_schwinger_tpu_torch.mg.cycle import MGSolver
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import shift_rows_down
from deflatedmlmc_schwinger_tpu_torch.trace.deflation import (
    Deflation,
    deflate,
    hutchinson_deflation,
    replicate_deflation,
)
from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source
from deflatedmlmc_schwinger_tpu_torch.trace.stats import (
    RunningMoments,
    check_stalled,
    sample_to_stop,
    sample_to_stop_host,
)
from deflatedmlmc_schwinger_tpu_torch.utils.flops import flops_vcycle, level_nnz
from deflatedmlmc_schwinger_tpu_torch.utils.timer import PhaseTimer, span


def sample_rows(x: torch.Tensor, mesh, cfg: TraceConfig):
    """How a whole batch x (B, ...), identical on every rank, is solved by a
    replicated MGSolver under a mesh: (this rank's rows, the mesh) when the
    rows divide over the mesh's samples axis, and then the solves any-reduce
    their loop predicates over the whole mesh and the per-row results are
    gathered; else (x, None): every rank solves all rows with no
    communication. Without a mesh (x, None) too."""
    if mesh is None or x.shape[0] % mesh.shape[cfg.sample_axis]:
        return x, None
    from deflatedmlmc_schwinger_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(x, mesh, cfg.sample_axis), mesh


def gather_rows(mesh, cfg: TraceConfig, *tensors):
    """Host arrays of per-row tensors in global sample order: gathered over
    the samples axis when ``mesh`` (from ``sample_rows``) is set."""
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import global_values

    return tuple(global_values(t, mesh, cfg.sample_axis) for t in tensors)


def hutchinson_step_batch(op, solver: MGSolver, cfg: TraceConfig,
                          defl: Deflation, probes: torch.Tensor,
                          fine_solver=None, gather: bool = True, mesh=None):
    """One batch of deflated Hutchinson estimates for (B, n) probes.
    Returns host (estimates complex (B,), per-row iterations, per-row
    stalled flags), or the same three as device tensors with
    ``gather=False``.

    ``fine_solver``: the lattice-sharded ShardedMGSolver of a
    ('samples', 'x') mesh, which takes the whole batch and hands the whole
    solution back on every rank; default: the replicated MGSolver. ``mesh``:
    without a fine solver, every rank solves its rows of the batch, and the
    gathered results are the whole batch's on every rank."""
    with span("est.batch"):
        rows_mesh = None
        if fine_solver is None:
            probes, rows_mesh = sample_rows(probes, mesh, cfg)
        with span("est.deflate"):
            x_def = deflate(probes, defl.U)
            d = solver.hier.levels[0].perm_shift
            if cfg.use_permuted and d:
                x_def = shift_rows_down(x_def, d)
        if fine_solver is not None:
            res = fine_solver.solve(x_def, cfg.function_tol)
        else:
            res = solver.solve(x_def, cfg.function_tol,
                               pred_group=None if rows_mesh is None else rows_mesh.world)
        e = (probes.conj() * res.x).sum(-1)
        if not gather:
            if rows_mesh is not None:
                raise ValueError("a batch split over a mesh is gathered on the host")
            return e, res.iters, res.stalled
        return gather_rows(rows_mesh, cfg, e, res.iters, res.stalled)


def make_fine_solver(hier, mesh, cfg: TraceConfig, log):
    """The lattice-sharded solver for the fine-level systems when the mesh
    has a lattice axis of more than one rank, else None."""
    if (mesh is None or cfg.lattice_axis not in mesh.axis_names
            or mesh.shape[cfg.lattice_axis] <= 1):
        return None
    from deflatedmlmc_schwinger_tpu_torch.parallel.sharded_solve import ShardedMGSolver

    log(f"fine-level solves lattice-sharded over {mesh.shape[cfg.lattice_axis]} "
        f"'{cfg.lattice_axis}' shards")
    return ShardedMGSolver(hier, mesh, cfg.solver, x_axis=cfg.lattice_axis,
                           sample_axis=cfg.sample_axis)


def hutchinson(
    op,
    cfg: TraceConfig,
    *,
    hier=None,
    solver: Optional[MGSolver] = None,
    probe_source: str = "torch",
    timer: Optional[PhaseTimer] = None,
    verbose: bool = True,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
) -> Dict:
    """Compute tr(A^{-1}) (or tr(A^{-1} Pi)) by deflated Hutchinson on the
    device that holds ``op``.

    ``mesh``: each probe batch is split over its samples axis, and the
    fine-level solves over its lattice axis if it has one; the estimates do
    not depend on the mesh, because probes are counter-keyed and all rows
    of a batch step together. Only rank 0 logs and writes checkpoints.

    ``checkpoint_dir``: if set, the hierarchy is cached there
    (hierarchy.npz) and the sampling state (moments, next sample index,
    iterations) is saved after every batch (hutchinson_state.json); an
    interrupted run resumes on the same counter-keyed probe stream."""
    # utils.checkpoint imports trace.stats, so it is imported here and not
    # at the top of this module
    from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import (
        EstimatorState,
        setup_or_load_hierarchy,
    )

    pin_full_precision_matmuls()
    device = op.device
    timer = timer or PhaseTimer(device)
    lead = mesh is None or mesh.rank == 0
    log = print if (verbose and lead) else (lambda *a, **k: None)
    state_ckpt = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        state_ckpt = os.path.join(checkpoint_dir, "hutchinson_state.json")

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
    if hier.nr_levels < 3:
        raise ValueError("the estimator needs a hierarchy of at least three levels")
    log(f"MG hierarchy sizes: {hier.sizes()}")
    fine_solver = make_fine_solver(hier, mesh, cfg, log)

    with timer.phase("defl_setup"):
        defl = hutchinson_deflation(op, solver, cfg, fine_solver=fine_solver)
        if mesh is not None:
            defl = replicate_deflation(defl, mesh)
    if defl.values is not None:
        log(f"deflation |eigs|: {np.abs(defl.values)}  tr1={defl.tr1:.6f}")

    n = op.n
    dtype = op.dtype
    rough_probes = make_probe_source(probe_source, cfg.rough_seed, device)
    with timer.phase("rough_trace"):
        # the rough batch is padded to the sampling batch size; only the
        # first nr_rough_iters estimates enter unless rough_batch_full
        Br = max(int(cfg.nr_rough_iters), int(cfg.probe_batch))
        X = rough_probes(0, Br, n, dtype)
        es, _, stall = hutchinson_step_batch(op, solver, cfg, defl, X, fine_solver,
                                             mesh=mesh)
        n_rough = Br if cfg.rough_batch_full else int(cfg.nr_rough_iters)
        rough_trace = complex(np.mean(es[:n_rough])) + defl.tr1
    stalled_rows = int(np.sum(stall))
    check_stalled(stalled_rows, Br, cfg.max_stalled_frac, "hutchinson rough trace")
    rough_trace_tol = cfg.stop_safety * abs(cfg.trace_tol * rough_trace)
    log(f"rough trace: {rough_trace:.6f}  target stderr: {rough_trace_tol:.3e}")

    probes = make_probe_source(probe_source, cfg.seed, device)
    solver.coarsest_lev_iters[0] = 0
    if fine_solver is not None:
        fine_solver.coarsest_lev_iters[0] = 0
    B = int(cfg.probe_batch)
    if mesh is not None and B % mesh.shape[cfg.sample_axis]:
        raise ValueError(f"probe_batch {B} not divisible by mesh axis "
                         f"{mesh.shape[cfg.sample_axis]}")

    def step(start: int, gather: bool = False):
        return hutchinson_step_batch(op, solver, cfg, defl, probes(start, B, n, dtype),
                                     fine_solver, gather=gather, mesh=mesh)

    # the moments stay on the device on the one-process path without a
    # checkpoint; a checkpointed run and a run over a mesh need every batch's
    # estimates on the host, identical on every rank
    with timer.phase("sampling"):
        if state_ckpt is None and mesh is None:
            moments, function_iters, nstall = sample_to_stop(
                step, cfg, rough_trace_tol, "hutchinson sampling", real_dtype(dtype),
                device)
            stalled_rows += nstall
        else:
            state = EstimatorState.load_or_empty(state_ckpt)
            moments = state.moments.get("hutchinson", RunningMoments())
            resume_at = state.next_index.get("hutchinson", 0)
            if resume_at:
                log(f"resuming sampling at sample {resume_at} (n={moments.count})")
            function_iters = int(state.iters.get("hutchinson", 0))

            def after_batch(batch, next_start: int) -> None:
                nonlocal function_iters, stalled_rows
                function_iters += int(np.sum(batch[1]))
                stalled_rows += int(np.sum(batch[2]))
                check_stalled(stalled_rows, next_start - resume_at + Br,
                              cfg.max_stalled_frac, "hutchinson sampling")
                if state_ckpt is not None and lead:
                    EstimatorState(moments={"hutchinson": moments},
                                   next_index={"hutchinson": next_start},
                                   iters={"hutchinson": function_iters}).save(state_ckpt)

            sample_to_stop_host(lambda start: step(start, gather=True), cfg,
                                rough_trace_tol, moments, resume_at, after_batch)

    nnz = level_nnz(hier)
    result = dict(
        trace=moments.mean + defl.tr1,
        std_dev=moments.std_dev,
        nr_ests=moments.count,
        function_iters=function_iters,
        rough_trace=rough_trace,
        stalled_rows=stalled_rows,
        # the deflation (basis values and residuals) and its stalled
        # exact-correction solves, which stalled_rows does not count
        deflation=defl,
        defl_stalled_rows=defl.stalled_rows,
    )
    total = flops_vcycle(nnz, solver.cfg.smooth_iters, 0, 0) * function_iters
    total += nnz[-1] * int(solver.coarsest_lev_iters[0])
    if fine_solver is not None:
        total += nnz[-1] * int(fine_solver.coarsest_lev_iters[0])
    # the reference's deflation-work charge
    total += moments.count * (2.0 * n * int(cfg.nr_deflat_vctrs)) / 3.0
    result["total_complexity"] = total
    result["timer"] = timer
    return result
