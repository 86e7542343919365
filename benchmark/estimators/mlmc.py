"""One difference level of deflated MG-MLMC, sampled as trace/mlmc.py
``mlmc`` samples it under the sequential schedule on one device without a
checkpoint: hierarchy, dense coarse inverses, the level's deflation (for
level 0 with ``mlmc_fine_deflation``: the Hutchinson gamma3 basis with its
exact add-back), the rough trace and the dense-exact levels are built anew;
the window's step is ``mlmc_step_batch(..., level, gather=False)``, the
coarse solves' iterations summed on the device as ``_sequential_level``
sums them."""

from __future__ import annotations

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls, real_dtype
from deflatedmlmc_schwinger_tpu_torch.mg.cycle import MGSolver
from deflatedmlmc_schwinger_tpu_torch.trace.deflation import (
    Deflation,
    hutchinson_deflation,
)
from deflatedmlmc_schwinger_tpu_torch.trace.hutchinson import hutchinson_step_batch
from deflatedmlmc_schwinger_tpu_torch.trace.mlmc import (
    _fine_deflation_addback,
    bblock_matrix_host,
    dense_level_inverse,
    exact_difference_trace,
    mlmc_step_batch,
)
from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source
from deflatedmlmc_schwinger_tpu_torch.trace.stats import check_stalled
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import setup_or_load_hierarchy

from stats import level_tol_factor, tolerance_fractions


def _quiet(*args, **kw) -> None:
    pass


class MlmcLevelSampling:
    def __init__(self, op, cfg, level: int, probe_seed: int, timer):
        pin_full_precision_matmuls()
        self.op, self.cfg, self.level = op, cfg, int(level)
        self.B = int(cfg.probe_batch)
        self.where = f"mlmc level {self.level}"
        skips = list(cfg.mlmc_levels_to_skip)
        self.skip = skips == [1]
        if skips not in ([], [1]):
            raise ValueError("only level 1 can be skipped")
        with timer.phase("mg_setup"):
            self.solver = MGSolver(setup_or_load_hierarchy(op, cfg, None, _quiet), cfg.solver)
        hier = self.solver.hier
        nl = hier.nr_levels
        self.nr_levels = nl
        coarse = self._coarse(self.level)
        cutoff = int(cfg.mlmc_exact_dense_max_n)
        exact = {l for l in range(nl - 1)
                 if cutoff and not (self.skip and l == 1) and hier.levels[l].n <= cutoff}
        if self.level in exact or (self.skip and self.level == 1):
            raise ValueError(f"level {self.level} is not sampled in this configuration")
        dense_host = {}
        self.coarse_inv = None
        with timer.phase("dense_setup"):
            for l in range(nl - 1):
                if (self.skip and l == 1) or l in exact:
                    continue
                c = self._coarse(l)
                if cutoff and c != nl - 1 and hier.levels[c].n <= cutoff and c not in dense_host:
                    dense_host[c] = dense_level_inverse(hier, c)
            if coarse in dense_host:
                self.coarse_inv = torch.from_numpy(dense_host[coarse]).to(
                    device=op.device, dtype=hier.levels[coarse].op.dtype)
        hutch_defl = None
        with timer.phase("defl_setup"):
            if cfg.mlmc_fine_deflation and 0 not in exact:
                hutch_defl = hutchinson_deflation(op, self.solver, cfg)
            if self.level == 0 and hutch_defl is not None:
                dinv = {coarse: self.coarse_inv} if self.coarse_inv is not None else {}
                self.defl = _fine_deflation_addback(op, self.solver, cfg, hutch_defl,
                                                    self.skip, dinv)
            elif self.level == 0 and cfg.mlmc_deflat_vctrs and cfg.mlmc_deflat_vctrs[0]:
                raise ValueError("the level-0 difference-operator deflation is not sampled here")
            else:
                self.defl = Deflation(U=None, tr1=0.0 + 0.0j)
        with timer.phase("rough_trace"):
            if hutch_defl is None:
                hutch_defl = hutchinson_deflation(op, self.solver, cfg)
            rough = make_probe_source("torch", cfg.rough_seed, op.device)
            Br = max(int(cfg.nr_rough_iters), self.B)
            es, _, stall = hutchinson_step_batch(op, self.solver, cfg, hutch_defl,
                                                 rough(0, Br, op.n, op.dtype))
            n_rough = Br if cfg.rough_batch_full else int(cfg.nr_rough_iters)
            self.rough_trace = complex(np.mean(es[:n_rough])) + hutch_defl.tr1
        check_stalled(int(np.sum(stall)), Br, cfg.max_stalled_frac, "mlmc rough trace")
        # the terms of the telescoping sum that this window does not sample:
        # the dense-exact levels and the coarsest level, as mlmc computes them
        with timer.phase("exact_levels"):
            self.exact_terms = complex(sum(
                exact_difference_trace(hier, l, self.skip, cfg.use_permuted,
                                       Ac_inv=dense_host.get(self._coarse(l)),
                                       Af_inv=dense_host.get(l))
                for l in sorted(exact)))
            M = hier.coarsest_inv.cpu().numpy()
            if cfg.use_permuted:
                M = np.roll(M @ bblock_matrix_host(hier, nl - 1),
                            hier.levels[-1].perm_shift, axis=0)
            self.exact_terms += complex(np.trace(M))
        for i in range(nl):
            self.solver.coarsest_lev_iters[i] = 0
        lev = hier.levels[self.level]
        self.n, self.dtype = lev.n, lev.op.dtype
        self.rdtype = real_dtype(self.dtype)
        self.coarse_iters = torch.zeros((), dtype=self.rdtype, device=op.device)
        self.probes = make_probe_source("torch", probe_seed, op.device)

    def _coarse(self, level: int) -> int:
        return level + 2 if (self.skip and level == 0) else level + 1

    def step(self, start: int):
        e, it1, it2, _, stall = mlmc_step_batch(
            self.solver, self.cfg, self.level, self.defl,
            self.probes(start, self.B, self.n, self.dtype), self.skip,
            gather=False, coarse_dense_inv=self.coarse_inv)
        self.coarse_iters = self.coarse_iters + it2.sum().to(self.rdtype)
        return e, it1, stall

    def trace_estimate(self, mean: complex) -> complex:
        return mean + self.defl.tr1 + self.exact_terms

    def tol_factor(self) -> float:
        f0, f1 = tolerance_fractions(self.nr_levels, self.skip)
        return level_tol_factor(self.level, self.nr_levels, f0, f1, self.skip)

    def reference_state(self) -> dict:
        """The probe projector basis, the displacement, the level's tr1 and
        the prolongator blocks of the coarse correction (fine level to the
        coarse level of this difference)."""
        if self.level != 0 or self.coarse_inv is None:
            raise ValueError("the reference judges level 0 with a dense coarse inverse")
        hier = self.solver.hier
        U = self.defl.U
        blocks = [hier.levels[l].P.blocks.detach().cpu().numpy().astype(np.complex128)
                  for l in range(self._coarse(0))]
        return dict(U=None if U is None else U.cpu().numpy().astype(np.complex128),
                    shift=int(hier.levels[0].perm_shift) if self.cfg.use_permuted else 0,
                    tr1=complex(self.defl.tr1), coarse_P=blocks)


def setup(op, cfg, traffic: dict, probe_seed: int, timer):
    return MlmcLevelSampling(op, cfg, int(traffic.get("level", 0)), probe_seed, timer)
