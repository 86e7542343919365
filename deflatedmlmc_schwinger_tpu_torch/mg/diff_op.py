"""MLMC difference-level operators over the MG hierarchy (counterpart of
deflatedmlmc_schwinger_tpu/mg/diff_op.py).

f_l(v) = (A_l^{-1} - P_l A_{l+1}^{-1} R_l) v, and its Hermitian form
f_l(gamma3 v) for the deflation eigensolves. With level 1 skipped the
level-0 difference uses the composite P0 P1 / R1 R0 and level 2 as its
coarse operator.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from deflatedmlmc_schwinger_tpu_torch.mg.cycle import MGSolver
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import gamma3


def level_structure(solver: MGSolver, level: int, skip_level: bool) -> Tuple:
    """(fine_level, coarse_level, restrict, prolong) for difference level
    ``level``, with the composite skip-level-1 case."""
    hier = solver.hier
    if skip_level and level == 0:
        P0 = hier.levels[0].P
        P1 = hier.levels[1].P
        return (0, 2, lambda v: P1.apply_adjoint(P0.apply_adjoint(v)),
                lambda v: P0.apply(P1.apply(v)))
    P = hier.levels[level].P
    return level, level + 1, P.apply_adjoint, P.apply


def make_diff_op(solver: MGSolver, level: int, tol: float,
                 skip_level: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """The difference operator f_l on (B, n_l) batches."""
    fine, coarse, restrict, prolong = level_structure(solver, level, skip_level)
    coarsest = solver.hier.nr_levels - 1

    def f(v: torch.Tensor) -> torch.Tensor:
        vc = restrict(v)
        t1 = solver.solve(v, tol, level=fine).x
        if coarse == coarsest:
            t2 = solver.coarsest_solve(vc)
        else:
            t2 = solver.solve(vc, tol, level=coarse).x
        return t1 - prolong(t2)

    return f


def make_diff_op_Q(solver: MGSolver, level: int, tol: float,
                   skip_level: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """Hermitian form f_l(gamma3 v)."""
    f = make_diff_op(solver, level, tol, skip_level)
    return lambda v: f(gamma3(v))
