"""Deflated Hutchinson sampling, as trace/hutchinson.py ``hutchinson``
runs it on one device without a checkpoint: the hierarchy and the gamma3
deflation basis are built anew, the rough-trace batch is solved, and the
window's step is ``hutchinson_step_batch(..., gather=False)`` on
counter-keyed probes."""

from __future__ import annotations

import numpy as np

from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls, real_dtype
from deflatedmlmc_schwinger_tpu_torch.mg.cycle import MGSolver
from deflatedmlmc_schwinger_tpu_torch.trace.deflation import hutchinson_deflation
from deflatedmlmc_schwinger_tpu_torch.trace.hutchinson import hutchinson_step_batch
from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source
from deflatedmlmc_schwinger_tpu_torch.trace.stats import check_stalled
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import setup_or_load_hierarchy


def _quiet(*args, **kw) -> None:
    pass


class HutchinsonSampling:
    where = "hutchinson sampling"

    def __init__(self, op, cfg, probe_seed: int, timer):
        pin_full_precision_matmuls()
        self.op, self.cfg = op, cfg
        self.n, self.B = op.n, int(cfg.probe_batch)
        self.rdtype = real_dtype(op.dtype)
        with timer.phase("mg_setup"):
            self.solver = MGSolver(setup_or_load_hierarchy(op, cfg, None, _quiet), cfg.solver)
        with timer.phase("defl_setup"):
            self.defl = hutchinson_deflation(op, self.solver, cfg)
        with timer.phase("rough_trace"):
            rough = make_probe_source("torch", cfg.rough_seed, op.device)
            Br = max(int(cfg.nr_rough_iters), self.B)
            es, _, stall = hutchinson_step_batch(op, self.solver, cfg, self.defl,
                                                 rough(0, Br, op.n, op.dtype))
            n_rough = Br if cfg.rough_batch_full else int(cfg.nr_rough_iters)
            self.rough_trace = complex(np.mean(es[:n_rough])) + self.defl.tr1
        check_stalled(int(np.sum(stall)), Br, cfg.max_stalled_frac, "hutchinson rough trace")
        self.solver.coarsest_lev_iters[0] = 0
        self.probes = make_probe_source("torch", probe_seed, op.device)

    def step(self, start: int):
        return hutchinson_step_batch(self.op, self.solver, self.cfg, self.defl,
                                     self.probes(start, self.B, self.n, self.op.dtype),
                                     gather=False)

    def trace_estimate(self, mean: complex) -> complex:
        return mean + self.defl.tr1

    def tol_factor(self) -> float:
        """The share of the trace tolerance that the sampled estimate gets."""
        return 1.0

    def reference_state(self) -> dict:
        """What the reference reads of the program's set-up to judge the
        window: the probe projector basis, the displacement and tr1."""
        U = self.defl.U
        return dict(U=None if U is None else U.cpu().numpy().astype(np.complex128),
                    shift=int(self.solver.hier.levels[0].perm_shift)
                    if self.cfg.use_permuted else 0,
                    tr1=complex(self.defl.tr1), coarse_P=None)


def setup(op, cfg, traffic: dict, probe_seed: int, timer):
    if int(traffic.get("level", 0)) != 0:
        raise ValueError("Hutchinson samples the fine level only")
    return HutchinsonSampling(op, cfg, probe_seed, timer)
