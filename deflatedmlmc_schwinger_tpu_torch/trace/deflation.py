"""Deflation for deflated Hutchinson (subset of
deflatedmlmc_schwinger_tpu/trace/deflation.py).

Only the undeflated case (``nr_deflat_vctrs == 0``) is ported: the basis
eigensolver (inverse subspace iteration through MG solves) waits for the
G102 slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig


@dataclasses.dataclass
class Deflation:
    """Deflation data for one estimator: U is the (n, k) probe projector
    basis on the device, tr1 the exact low-rank trace term."""

    U: Optional[torch.Tensor]
    tr1: complex


def deflate(x: torch.Tensor, U: Optional[torch.Tensor]) -> torch.Tensor:
    """x - U (U^H x) on (B, n) batches of row vectors."""
    if U is None:
        return x
    c = x @ U.conj()          # (B, k)
    return x - c @ U.T


def hutchinson_deflation(op, solver, cfg: TraceConfig) -> Deflation:
    """Deflation basis and exact correction for deflated Hutchinson."""
    if int(cfg.nr_deflat_vctrs) == 0:
        return Deflation(U=None, tr1=0.0 + 0.0j)
    raise NotImplementedError(
        "deflation with nr_deflat_vctrs > 0 waits for the G102 slice (ROADMAP.md, "
        "'Modules to port': deflation with k>0 and G102)")
