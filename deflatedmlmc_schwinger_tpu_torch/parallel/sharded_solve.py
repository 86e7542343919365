"""Lattice-sharded MG solve (counterpart of
deflatedmlmc_schwinger_tpu/parallel/sharded_solve.py): the V-cycle-
preconditioned batched FGMRES on a ('samples', 'x') mesh with the fine level
cut over the x axis, one rank per mesh position.

  * fine-level matvec and residual: the halo-exchange stencil
    (parallel/halo.py: kernels K1 and K2 on the padded block on a CUDA
    device), one boundary row per neighbour per apply;
  * fine-level smoothing: the polynomial smoother needs no inner products,
    so it is rank-local but for the halo rows, root by root over the halo
    matvec (the fused kernel K3 is not used here: its roots would need a
    halo as deep as the smoother); the 'gmres' smoother sums its dots over
    the x ranks;
  * P and R stay rank-local: aggregates are contiguous t-strips inside one
    (spin, x) row, so the prolongator blocks reshape to (2, X, T/L, L, dc)
    and are cut over X with the lattice. Restriction all-gathers the (small)
    coarse vector once, so coarse levels are replicated; prolongation
    slices this rank's X-range back out;
  * coarse levels: replicated compute, identical on every rank of a sample
    row, through the same V-cycle code as on one device (mg/cycle.py);
  * outer FGMRES: solvers/fgmres.py with ``group`` = this rank's x ranks
    (norms and Arnoldi dots sum their partial sums) and ``pred_group`` = the
    whole mesh (ranks that hold other sample rows must take the same number
    of steps, or the ring exchange never completes).

``solve`` takes the whole (B, n) batch, identical on every rank, and returns
the whole solution and per-row numbers on every rank.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig
from deflatedmlmc_schwinger_tpu_torch.mg.cycle import (
    GmresSmoother,
    MGSolver,
    PolySmoother,
    build_v_cycle,
    gmres_smoother,
    poly_smoother,
)
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import Hierarchy
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator
from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import all_gather_cat
from deflatedmlmc_schwinger_tpu_torch.parallel.halo import (
    gather_blocks,
    halo_apply,
    halo_residual,
    local_block,
    shard_coeffs,
)
from deflatedmlmc_schwinger_tpu_torch.solvers.fgmres import FGMRESResult, fgmres


class ShardedMGSolver:
    """Batched fine-level MG-FGMRES with the lattice cut over the mesh's x
    axis and the probes over its samples axis. Drop-in for MGSolver.solve at
    level 0; coarse-level solves stay on the replicated MGSolver."""

    def __init__(
        self,
        hier: Hierarchy,
        mesh,
        cfg: Optional[SolverConfig] = None,
        *,
        x_axis: str = "x",
        sample_axis: str = "samples",
    ):
        self.cfg = cfg or SolverConfig()
        self.mesh = mesh
        self.x_axis = x_axis
        self.sample_axis = sample_axis
        op0 = hier.levels[0].op
        if not isinstance(op0, StencilOperator):
            raise TypeError("sharded solve needs a StencilOperator fine level")
        self.nx, self.nt = op0.nx, op0.nt
        self.n = op0.n
        self.dtype = op0.dtype
        self.device = op0.device
        self._sh = shard_coeffs(op0, mesh, x_axis)      # checks nx % nshards
        self.nshards = self._sh.nshards
        self._xgroup = self._sh.group

        P0 = hier.levels[0].P
        na, L, dc = P0.blocks.shape
        if self.nt % L or na != 2 * self.nx * (self.nt // L):
            raise ValueError(
                "aggregates must be contiguous t-strips inside one (spin, x) "
                f"row: n_aggr={na}, L={L}, lattice {self.nx}x{self.nt}"
            )
        tb = self.nt // L
        self.nc = na * dc
        # aggregate j = (s, x, t-block): this rank owns the blocks of its X-range
        xl, x0 = self._sh.nx_local, self._sh.x0
        self._p5 = P0.blocks.reshape(2, self.nx, tb, L, dc)[:, x0:x0 + xl].contiguous()
        self._coarse_levels = list(hier.levels)[1:]
        self._coarsest_inv = hier.coarsest_inv
        # same bookkeeping as MGSolver
        self.num_iters = 0
        self.coarsest_lev_iters = [0] * hier.nr_levels
        self.total_solve_calls = 0

        # smoothers: poly = no inner products; gmres = dots summed over the x
        # ranks on the fine level, plain dots on the replicated coarse ones
        m = self.cfg.smooth_iters
        if self.cfg.smoother == "poly":
            base = MGSolver(hier, self.cfg)
            roots = [base._roots_for(i) for i in range(hier.nr_levels - 1)]
            self._sm0 = lambda r: poly_smoother(self._mv0, r, roots[0])
            self._sm0_res = lambda b: poly_smoother(self._mv0, b, roots[0],
                                                    with_residual=True)
            coarse_sms = [PolySmoother(th) for th in roots[1:]]
        elif self.cfg.smoother == "gmres":
            self._sm0 = lambda r: gmres_smoother(self._mv0, r, m, self._xgroup)

            def sm0_res(b: torch.Tensor):
                x = self._sm0(b)
                return x, self._res0(b, x)

            self._sm0_res = sm0_res
            coarse_sms = [GmresSmoother(m)] * (hier.nr_levels - 2)
        else:
            raise ValueError(f"smoother must be 'gmres' or 'poly', got {self.cfg.smoother!r}")
        self._coarse_v = build_v_cycle(self._coarse_levels, self._coarsest_inv, coarse_sms,
                                       first_level=1)

    # -- this rank's pieces of the level-0 V-cycle, on (B/s, 2 * X/k * T) rows --
    def _grid(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(v.shape[0], 2, self._sh.nx_local, self.nt)

    def _mv0(self, v: torch.Tensor) -> torch.Tensor:
        return halo_apply(self._sh, self._grid(v)).reshape(v.shape)

    def _res0(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return halo_residual(self._sh, self._grid(b), self._grid(x)).reshape(b.shape)

    def _restrict0(self, v: torch.Tensor) -> torch.Tensor:
        """R0 v: rank-local block contraction, then the replicated coarse
        vector from one all-gather over x."""
        _, xl, tb, L, _ = self._p5.shape
        g = v.reshape(v.shape[0], 2, xl, tb, L)
        c = torch.einsum("sxtld,bsxtl->bsxtd", self._p5.conj(), g)
        return all_gather_cat(c, self._xgroup, dim=2).reshape(v.shape[0], self.nc)

    def _prolong0(self, y: torch.Tensor) -> torch.Tensor:
        """P0 y: this rank's X-range of the replicated coarse vector through
        its own blocks; no communication."""
        _, xl, tb, _, dc = self._p5.shape
        loc = y.reshape(y.shape[0], 2, self.nx, tb, dc)[:, :, self._sh.x0:self._sh.x0 + xl]
        out = torch.einsum("sxtld,bsxtd->bsxtl", self._p5, loc)
        return out.reshape(y.shape[0], -1)

    def _precond0(self, bv: torch.Tensor) -> torch.Tensor:
        # the level-0 V-cycle: smooth0, P0 (coarse V-cycle) R0, post-smooth0
        # (mg/cycle.py build_v_cycle)
        x, r = self._sm0_res(bv)
        x = x + self._prolong0(self._coarse_v(self._restrict0(r)))
        return x + self._sm0(self._res0(bv, x))

    def solve(self, b: Union[torch.Tensor, np.ndarray], tol: float, *,
              max_restarts: Optional[int] = None) -> FGMRESResult:
        """Solve A_0 x = b for the whole batch b (B, n), identical on every
        rank; each rank solves its sample rows on its X-range, and every
        rank gets the whole x, resnorm, bnorm, iters and stalled back."""
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.asarray(b)).to(device=self.device, dtype=self.dtype)
        tol_eff = self.cfg.effective_tol(tol, b.dtype)
        blk = local_block(b, self.mesh, self.nx, self.nt, x_axis=self.x_axis,
                          sample_axis=self.sample_axis)
        res = fgmres(
            self._mv0, blk.reshape(blk.shape[0], -1), tol=tol_eff,
            restart=self.cfg.restart,
            max_restarts=(max_restarts if max_restarts is not None
                          else self.cfg.max_restarts),
            precond=self._precond0,
            stall_ratio=self.cfg.stall_ratio, stall_cycles=self.cfg.stall_cycles,
            group=self._xgroup,
            # the whole mesh: ranks that hold other sample rows must agree on
            # the trip counts, or the halo ring never completes
            pred_group=self.mesh.world,
        )
        # the solution goes back whole: the estimator's <x, z> needs the full
        # row, and the per-row numbers are equal over x already
        x = gather_blocks(self._grid(res.x), self.mesh, x_axis=self.x_axis,
                          sample_axis=self.sample_axis)
        sgroup = self.mesh.groups.get(self.sample_axis)
        resnorm, bnorm, iters, stalled = (
            all_gather_cat(t, sgroup, dim=0)
            for t in (res.resnorm, res.bnorm, res.iters, res.stalled.to(torch.int32)))
        it = iters.max()
        self.num_iters = it
        self.total_solve_calls += 1
        self.coarsest_lev_iters[0] = self.coarsest_lev_iters[0] + it
        return FGMRESResult(x=x, resnorm=resnorm, bnorm=bnorm, iters=iters,
                            cycles=res.cycles, stalled=stalled.to(torch.bool))
