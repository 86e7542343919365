"""Deflated Hutchinson trace estimator (counterpart of
deflatedmlmc_schwinger_tpu/trace/hutchinson.py).

MG setup -> deflation precompute -> rough trace -> batched probe sampling
with the stderr stopping rule (trace/stats.py sample_to_stop) -> result
dict with the analytic complexity model. Probes are solved a batch at a
time by one MG-preconditioned FGMRES call. With ``checkpoint_dir`` the
hierarchy is cached and the sampling state saved after every batch, and the
moments are then kept on the host (trace/stats.py sample_to_stop_host).

Not ported yet: the mesh and lattice-sharded branches (ROADMAP.md queue:
parallel).
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
)
from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source
from deflatedmlmc_schwinger_tpu_torch.trace.stats import (
    RunningMoments,
    check_stalled,
    sample_to_stop,
    sample_to_stop_host,
)
from deflatedmlmc_schwinger_tpu_torch.utils.flops import flops_vcycle, level_nnz
from deflatedmlmc_schwinger_tpu_torch.utils.timer import PhaseTimer


def hutchinson_step_batch(op, solver: MGSolver, cfg: TraceConfig,
                          defl: Deflation, probes: torch.Tensor,
                          gather: bool = True):
    """One batch of deflated Hutchinson estimates for (B, n) probes.
    Returns host (estimates complex (B,), per-row iterations, per-row
    stalled flags), or the same three as device tensors with
    ``gather=False``."""
    x_def = deflate(probes, defl.U)
    d = solver.hier.levels[0].perm_shift
    if cfg.use_permuted and d:
        x_def = shift_rows_down(x_def, d)
    res = solver.solve(x_def, cfg.function_tol)
    e = (probes.conj() * res.x).sum(-1)
    if not gather:
        return e, res.iters, res.stalled
    return e.cpu().numpy(), res.iters.cpu().numpy(), res.stalled.cpu().numpy()


def hutchinson(
    op,
    cfg: TraceConfig,
    *,
    hier=None,
    solver: Optional[MGSolver] = None,
    probe_source: str = "torch",
    timer: Optional[PhaseTimer] = None,
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
) -> Dict:
    """Compute tr(A^{-1}) (or tr(A^{-1} Pi)) by deflated Hutchinson on the
    device that holds ``op``.

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
    log = print if verbose else (lambda *a, **k: None)
    state_ckpt = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        state_ckpt = os.path.join(checkpoint_dir, "hutchinson_state.json")

    if solver is None:
        with timer.phase("mg_setup"):
            if hier is None:
                hier = setup_or_load_hierarchy(op, cfg, checkpoint_dir, log)
            solver = MGSolver(hier, cfg.solver)
    else:
        hier = solver.hier
    if hier.nr_levels < 3:
        raise ValueError("the estimator needs a hierarchy of at least three levels")
    log(f"MG hierarchy sizes: {hier.sizes()}")

    with timer.phase("defl_setup"):
        defl = hutchinson_deflation(op, solver, cfg)
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
        es, _, stall = hutchinson_step_batch(op, solver, cfg, defl, X)
        n_rough = Br if cfg.rough_batch_full else int(cfg.nr_rough_iters)
        rough_trace = complex(np.mean(es[:n_rough])) + defl.tr1
    stalled_rows = int(np.sum(stall))
    check_stalled(stalled_rows, Br, cfg.max_stalled_frac, "hutchinson rough trace")
    rough_trace_tol = cfg.stop_safety * abs(cfg.trace_tol * rough_trace)
    log(f"rough trace: {rough_trace:.6f}  target stderr: {rough_trace_tol:.3e}")

    probes = make_probe_source(probe_source, cfg.seed, device)
    solver.coarsest_lev_iters[0] = 0
    B = int(cfg.probe_batch)

    def step(start: int, gather: bool = False):
        return hutchinson_step_batch(op, solver, cfg, defl, probes(start, B, n, dtype),
                                     gather=gather)

    with timer.phase("sampling"):
        if state_ckpt is None:
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
    # the reference's deflation-work charge
    total += moments.count * (2.0 * n * int(cfg.nr_deflat_vctrs)) / 3.0
    result["total_complexity"] = total
    result["timer"] = timer
    return result
