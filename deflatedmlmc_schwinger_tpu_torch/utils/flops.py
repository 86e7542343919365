"""Analytic V-cycle FLOP-complexity model (counterpart of
deflatedmlmc_schwinger_tpu/utils/flops.py, the reference's charging rule:
(2*smooth_iters + 2)*nnz(A_l) on the level a solve starts from and
(2*smooth_iters + 1)*nnz(A_l) below it, over levels above the coarsest)."""

from __future__ import annotations

from typing import List, Sequence

import torch

from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import (
    BlockStencilOperator,
    DenseOperator,
    Hierarchy,
)
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator


def level_nnz(hier: Hierarchy) -> List[int]:
    """Structural nonzero count of each level operator."""
    out = []
    for lev in hier.levels:
        op = lev.op
        if isinstance(op, StencilOperator):
            t = op.coeffs
        elif isinstance(op, BlockStencilOperator):
            t = op.blocks
        elif isinstance(op, DenseOperator):
            t = op.mat
        else:
            raise TypeError(f"unknown level operator {type(op)!r}")
        out.append(int(torch.count_nonzero(t).item()))
    return out


def flops_vcycle(nnz: Sequence[int], smooth_iters: int, bare_level: int,
                 level_id: int) -> float:
    last_charged = len(nnz) - 2
    coeff = (2 * smooth_iters + 2) if level_id == bare_level else (2 * smooth_iters + 1)
    total = coeff * nnz[level_id]
    if level_id < last_charged:
        total += flops_vcycle(nnz, smooth_iters, bare_level, level_id + 1)
    return float(total)
