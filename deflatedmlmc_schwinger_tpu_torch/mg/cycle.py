"""The V-cycle and the multigrid-preconditioned FGMRES solver (counterpart
of deflatedmlmc_schwinger_tpu/mg/cycle.py).

V-cycle: pre-smooth from a zero guess with the smoothed residual, restrict;
dense precomputed inverse on the coarsest level; prolongate-correct,
residual, post-smooth on the way up. Solves may start from any level. On a
level-0 StencilOperator the polynomial smoother is kernel K3 and the
residual kernel K2; coarser levels run the plain recurrence on their
einsum/matmul matvecs.

Not ported yet (raise NotImplementedError): the adaptive GMRES smoother
(``smoother='gmres'``), ``gmres_poly_roots`` for hierarchies built without
precomputed roots, and the fused ``precond_matvec`` form.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import Hierarchy
from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator
from deflatedmlmc_schwinger_tpu_torch.solvers.fgmres import FGMRESResult, fgmres

_WAITS = "waits for its slice (ROADMAP.md, 'Modules to port': GmresSmoother / precond_matvec)"


def poly_smoother(matvec: Callable, r: torch.Tensor, roots: Sequence[complex],
                  with_residual: bool = False):
    """x = p(A) r with p the fixed GMRES residual-polynomial inverse:
    x += cur/theta_k; cur -= A cur/theta_k. With ``with_residual`` returns
    (x, r - A x) using m matvecs; otherwise x alone (m - 1 matvecs)."""
    x = None
    cur = r
    for k, th in enumerate(roots):
        step = cur * (1.0 / complex(th))
        x = step if x is None else x + step
        if k == len(roots) - 1 and not with_residual:
            break
        cur = cur - matvec(step)
    if with_residual:
        return x, cur
    return x


def residual(op, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r = b - A x; kernel K2 on the fine stencil level."""
    if isinstance(op, StencilOperator):
        return stencil_kernels.stencil_residual(
            op.coeffs, b.contiguous(), x.contiguous(), op.nx, op.nt)
    return b - op.matvec(x)


class PolySmoother:
    """GMRES-residual-polynomial smoother (zero inner products); kernel K3
    on the fine stencil level, the plain recurrence elsewhere."""

    def __init__(self, roots: Sequence[complex]):
        self.roots = tuple(complex(t) for t in roots)

    def smooth(self, op, r: torch.Tensor) -> torch.Tensor:
        if isinstance(op, StencilOperator):
            x, _ = stencil_kernels.stencil_poly_smooth(
                op.coeffs, r.contiguous(), self.roots, op.nx, op.nt,
                with_residual=False)
            return x
        return poly_smoother(op.matvec, r, self.roots)

    def smooth_residual(self, op, b: torch.Tensor):
        if isinstance(op, StencilOperator):
            return stencil_kernels.stencil_poly_smooth(
                op.coeffs, b.contiguous(), self.roots, op.nx, op.nt,
                with_residual=True)
        return poly_smoother(op.matvec, b, self.roots, with_residual=True)


def build_v_cycle(levels, coarsest_inv: torch.Tensor, smoothers) -> Callable:
    """V-cycle closure over an explicit level list; ``smoothers[i]`` pairs
    with ``levels[i]``."""

    def v_cycle(b: torch.Tensor) -> torch.Tensor:
        bs = [b]
        xs = []
        for lev, sm in zip(levels[:-1], smoothers):
            x, r = sm.smooth_residual(lev.op, bs[-1])
            xs.append(x)
            bs.append(lev.P.apply_adjoint(r))
        xc = bs[-1] @ coarsest_inv.T
        for lev, sm, x, bf in zip(levels[-2::-1], smoothers[::-1], xs[::-1],
                                  bs[-2::-1]):
            x = x + lev.P.apply(xc)
            r = residual(lev.op, bf, x)
            xc = x + sm.smooth(lev.op, r)
        return xc

    return v_cycle


class MGSolver:
    """Multigrid-preconditioned batched solver over a Hierarchy, with the
    reference's bookkeeping (outer iteration counts, coarsest-level
    applications)."""

    def __init__(self, hier: Hierarchy, cfg: Optional[SolverConfig] = None):
        self.hier = hier
        self.cfg = cfg or SolverConfig()
        self._preconds: Dict[int, Callable] = {}
        self._poly_roots: Dict[int, np.ndarray] = {}
        self._derived: Dict[SolverConfig, "MGSolver"] = {}
        # outer iterations per starting level (the reference charges one
        # coarsest-level application per outer iteration)
        self.coarsest_lev_iters = [0] * hier.nr_levels
        self.num_iters = 0
        self.total_solve_calls = 0

    def derived(self, cfg: Optional[SolverConfig]) -> "MGSolver":
        """A solver over the same hierarchy with another SolverConfig (the
        deflation setup's ``defl_solver``), cached per config so that every
        caller in a process shares its smoother roots and V-cycles."""
        if cfg is None or cfg == self.cfg:
            return self
        if cfg not in self._derived:
            self._derived[cfg] = MGSolver(self.hier, cfg)
        return self._derived[cfg]

    def _roots_for(self, level_index: int) -> np.ndarray:
        if level_index not in self._poly_roots:
            for pre in (self.hier.poly_roots, self.hier.poly_roots_extra):
                if (pre is not None and level_index < len(pre)
                        and len(pre[level_index]) == self.cfg.smooth_iters):
                    self._poly_roots[level_index] = np.asarray(pre[level_index])
                    break
            else:
                raise NotImplementedError(
                    f"no precomputed depth-{self.cfg.smooth_iters} smoother roots "
                    f"for level {level_index}; gmres_poly_roots {_WAITS}")
        return self._poly_roots[level_index]

    def _smoothers(self, level: int):
        if self.cfg.smoother != "poly":
            raise NotImplementedError(f"smoother {self.cfg.smoother!r} {_WAITS}")
        levels = self.hier.levels[level:]
        return [PolySmoother(self._roots_for(level + i))
                for i in range(len(levels) - 1)]

    def matvec(self, level: int = 0) -> Callable:
        return self.hier.levels[level].op.matvec

    def precond(self, level: int = 0) -> Callable:
        if level not in self._preconds:
            self._preconds[level] = build_v_cycle(
                list(self.hier.levels)[level:], self.hier.coarsest_inv,
                self._smoothers(level),
            )
        return self._preconds[level]

    def solve(
        self,
        b: Union[torch.Tensor, np.ndarray],
        tol: float,
        *,
        level: int = 0,
        precondition: bool = True,
        max_restarts: Optional[int] = None,
    ) -> FGMRESResult:
        """Solve A_level x = b for a batch b of shape (B, n_level); a numpy
        array is uploaded to the level's device and dtype first."""
        op = self.hier.levels[level].op
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.asarray(b)).to(device=self.hier.coarsest_inv.device,
                                                  dtype=op.dtype)
        tol_eff = self.cfg.effective_tol(tol, b.dtype)
        res = fgmres(
            self.matvec(level),
            b,
            tol=tol_eff,
            restart=self.cfg.restart,
            max_restarts=(max_restarts if max_restarts is not None
                          else self.cfg.max_restarts),
            precond=self.precond(level) if precondition else None,
            stall_ratio=self.cfg.stall_ratio,
            stall_cycles=self.cfg.stall_cycles,
        )
        # kept as device scalars: converting here would sync every solve.
        # One coarsest-level application is charged per outer iteration of
        # the slowest row (the reference's rule, up to batching).
        iters = res.iters.max()
        self.num_iters = iters
        self.total_solve_calls += 1
        self.coarsest_lev_iters[level] = self.coarsest_lev_iters[level] + iters
        return res

    def coarsest_solve(self, b: torch.Tensor) -> torch.Tensor:
        """Apply the precomputed dense coarsest inverse to (B, n_c) rows."""
        self.coarsest_lev_iters[self.hier.nr_levels - 1] += 1
        return b @ self.hier.coarsest_inv.T
