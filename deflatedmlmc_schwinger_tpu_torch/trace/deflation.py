"""Deflation pre-computations for both estimators (counterpart of
deflatedmlmc_schwinger_tpu/trace/deflation.py).

  * Hutchinson: eigenpairs (theta, V) of the Hermitian Q = gamma3 D nearest
    zero, from inverse subspace iteration through MG solves; the probe
    projector basis is U = Pi gamma3 V sign(theta), and the exact low-rank
    term tr1 either by k extra MG solves, sum_i <U_i, D^{-1} Pi^T U_i>
    (``correction_mode='solve'``, exact for any basis quality), or by the
    reference's eigen-formula sum_i <U_i, V_i> / |theta_i| (``'eig'``).
  * MLMC level l: top eigenpairs (theta, W) of the Hermitian difference
    operator f_l o gamma3 by block power iteration; the probe projector
    basis is gamma3 W, and tr1 follows ``defl_type`` ('exact', 'inexact_01',
    'inexact_03'; 'inexact_02' is unfinished in the reference and raises).

Bases live on the operator's device as (n, k) tensors; only k x k data, the
eigenvalues and tr1 reach the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig
from deflatedmlmc_schwinger_tpu_torch.mg.cycle import MGSolver
from deflatedmlmc_schwinger_tpu_torch.mg.diff_op import make_diff_op, make_diff_op_Q
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import (
    gamma3,
    shift_rows_down,
    shift_rows_up,
    stencil_matvec_host,
)
from deflatedmlmc_schwinger_tpu_torch.solvers.eigs import (
    _apply_cols,
    inverse_iteration_smallest_device,
    subspace_iteration_largest,
)


@dataclasses.dataclass
class Deflation:
    """Deflation data for one estimator or level: U is the (n, k) probe
    projector basis on the device, tr1 the exact low-rank trace term."""

    U: Optional[torch.Tensor]
    tr1: complex
    values: Optional[np.ndarray] = None
    resnorms: Optional[np.ndarray] = None
    aux_V: Optional[torch.Tensor] = None   # MLMC: the reference's Ux (inexact_03)
    proj_B: Optional[torch.Tensor] = None  # inexact_03: (U^H A V)^{-1}
    stalled_rows: int = 0                  # stalled exact-correction solves

    @classmethod
    def from_numpy(cls, U: Optional[np.ndarray], tr1: complex, *, device,
                   dtype: torch.dtype, values: Optional[np.ndarray] = None,
                   resnorms: Optional[np.ndarray] = None,
                   aux_V: Optional[np.ndarray] = None,
                   proj_B: Optional[np.ndarray] = None) -> "Deflation":
        """From host complex arrays, e.g. the JAX package's Deflation with
        its (re, im) pairs joined into numpy complex arrays."""
        def up(a):
            if a is None:
                return None
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        return cls(U=up(U), tr1=complex(tr1), values=values, resnorms=resnorms,
                   aux_V=up(aux_V), proj_B=up(proj_B))


def deflate(x: torch.Tensor, U: Optional[torch.Tensor]) -> torch.Tensor:
    """x - U (U^H x) on (B, n) batches of row vectors."""
    if U is None:
        return x
    c = x @ U.conj()          # (B, k)
    return x - c @ U.T


def solve_refined_host(basis_solver: MGSolver, op, rhs: torch.Tensor, tol: float,
                       steps: int, pad_to: int):
    """Solve D Z = rhs for k rows with ``steps`` rounds of float64 host-residual
    iterative refinement; returns (Z complex128 host (k, n), stalled bool
    (k,) of the first pass).

    After each device solve the residual of the accumulated float64
    solution is recomputed exactly on the host (stencil_matvec_host) and one
    more device solve adds the correction: solution error O(tol^2/sigma_min)
    instead of O(tol/sigma_min), which matters for the low-mode right-hand
    sides of the deflation corrections. Rows are cyclically padded to
    ``pad_to`` so every solve has the sampling batch's shape. An operator
    without stencil coefficients gets no refinement. A lattice-sharded
    ``basis_solver`` hands the whole solution to every rank, so refinement
    runs under a mesh as it does on one device."""
    k = rhs.shape[0]

    def pad(x: torch.Tensor) -> torch.Tensor:
        if k < pad_to:
            return x[torch.arange(pad_to, device=x.device) % k]
        return x

    res = basis_solver.solve(pad(rhs), tol)
    stalled = res.stalled[:k].cpu().numpy()
    Z = res.x[:k].cpu().numpy().astype(np.complex128)
    if not hasattr(op, "coeffs"):
        steps = 0
    if steps:
        C = op.host_coeffs().astype(np.complex128)
        bh = rhs.cpu().numpy().astype(np.complex128)
        for _ in range(int(steps)):
            r = bh - stencil_matvec_host(C, Z, op.nx, op.nt)
            rd = torch.from_numpy(r).to(device=rhs.device, dtype=rhs.dtype)
            dres = basis_solver.solve(pad(rd), tol)
            Z = Z + dres.x[:k].cpu().numpy().astype(np.complex128)
    return Z, stalled


def hutchinson_deflation(
    op,
    solver: MGSolver,
    cfg: TraceConfig,
    *,
    correction_mode: str = "solve",
    rounds: Optional[int] = None,
    fine_solver=None,
) -> Deflation:
    """Deflation basis and exact correction for deflated Hutchinson on the
    fine StencilOperator ``op``.

    ``fine_solver``: the lattice-sharded ShardedMGSolver; the basis solves
    then run domain-decomposed with the basis rows split over the samples
    axis. The replicated solver is kept when the basis size does not divide
    over that axis."""
    if rounds is None:
        rounds = int(cfg.defl_subspace_rounds)
    k = int(cfg.nr_deflat_vctrs)
    if k == 0:
        return Deflation(U=None, tr1=0.0 + 0.0j)
    dtype = op.dtype
    solve_tol = cfg.solver.effective_tol(cfg.defl_eigvs_tol_Hutch, dtype)
    m = (int(cfg.defl_buffer) if cfg.defl_buffer is not None
         else max(k + 2, int(round(1.25 * k))))
    m = max(m, k)
    # the setup solver profile (config defl_solver): these near-kernel
    # solves are stall-cutoff-bound, so a shallow smoother pays
    basis_solver = solver.derived(cfg.defl_solver)
    if fine_solver is not None:
        nsh = fine_solver.mesh.shape[fine_solver.sample_axis]
        if k % nsh == 0:
            # pad m to a multiple of the sample shards: equal slices per rank
            m = ((m + nsh - 1) // nsh) * nsh
            basis_solver = fine_solver

    def Q(v: torch.Tensor) -> torch.Tensor:
        return gamma3(op.matvec(v))

    def apply_Qinv(v: torch.Tensor) -> torch.Tensor:   # Q^{-1} v = D^{-1} gamma3 v
        return basis_solver.solve(gamma3(v), solve_tol).x

    eig = inverse_iteration_smallest_device(
        Q, apply_Qinv, op.n, k, dtype=dtype, device=op.device,
        seed=cfg.seed + 101, rounds=rounds, tol=cfg.defl_eigvs_tol_Hutch,
        buffer=m, warm_filter_degree=int(cfg.defl_warm_filter_degree),
    )
    theta = eig.values
    Vr = eig.vectors                                   # (k, n) rows
    sgn = torch.from_numpy(np.sign(theta)).to(device=Vr.device, dtype=Vr.real.dtype)
    Ur = gamma3(Vr) * sgn[:, None]                     # U = Pi gamma3 V sign
    d = solver.hier.levels[0].perm_shift
    if cfg.use_permuted and d:
        Ur = shift_rows_up(Ur, d)

    nstalled = 0
    if correction_mode == "eig":
        diag = (Ur.conj() * Vr).sum(-1).cpu().numpy()
        tr1 = complex(np.sum(diag / np.abs(theta)))
    elif correction_mode == "solve":
        # tr(D^{-1} Pi^T U U^H) = sum_i <U_i, D^{-1} Pi^T U_i>, exact for any
        # basis; the rows pad to the sampling batch size
        rhs = shift_rows_down(Ur, d) if (cfg.use_permuted and d) else Ur
        Z, stalled = solve_refined_host(basis_solver, op, rhs, cfg.function_tol,
                                        int(cfg.defl_refine_steps), int(cfg.probe_batch))
        Uh = Ur.cpu().numpy().astype(np.complex128)
        tr1 = complex(np.sum(np.conj(Uh) * Z))
        nstalled = int(np.sum(stalled))
    else:
        raise ValueError(correction_mode)
    return Deflation(U=Ur.T, tr1=tr1, values=theta, resnorms=eig.resnorms,
                     stalled_rows=nstalled)


def replicate_deflation(defl: Deflation, mesh) -> Deflation:
    """Rank 0's deflation (basis, tr1, eigenvalues) on every rank of the
    mesh: the basis is computed once and every rank projects its probes
    against bit-identical copies."""
    from deflatedmlmc_schwinger_tpu_torch.parallel.mesh import replicate

    return replicate(defl, mesh)


def mlmc_level_deflation(solver: MGSolver, level: int, k: int, cfg: TraceConfig,
                         skip_level: bool, *, rounds: int = 10) -> Deflation:
    """Per-difference-level deflation for MLMC; each operator application
    costs two MG solves at ``diff_lev_op_tol``."""
    if k == 0:
        return Deflation(U=None, tr1=0.0 + 0.0j)
    lev = solver.hier.levels[level]
    n, dtype = lev.n, lev.op.dtype
    device = solver.hier.coarsest_inv.device
    qd = make_diff_op_Q(solver, level, cfg.diff_lev_op_tol, skip_level)
    eig = subspace_iteration_largest(
        qd, n, k, dtype=dtype, device=device, seed=cfg.seed + 202 + level,
        rounds=rounds, tol=cfg.defl_eigvs_tol_MLMC,
    )
    theta = eig.values
    W = eig.vectors                          # host (n, k)
    Uref = W * np.sign(theta)[None, :]       # the reference's Ux
    half = n // 2
    V = np.concatenate([W[:half], -W[half:]], axis=0)   # gamma3 W

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    proj_B = None
    if cfg.defl_type == "exact":
        small = (Uref.conj().T @ V) * np.abs(theta)[None, :]
        tr1 = complex(np.trace(small))
    elif cfg.defl_type == "inexact_01":
        f = make_diff_op(solver, level, cfg.diff_lev_op_tol, skip_level)
        tr1 = complex(np.trace(V.conj().T @ _apply_cols(f, V, dtype, device)))
    elif cfg.defl_type == "inexact_02":
        raise NotImplementedError("deflation type inexact_02 under construction")
    elif cfg.defl_type == "inexact_03":
        # oblique projector x - V (U^H A V)^{-1} U^H A x: the k x k inverse
        # is fixed per level, so it is computed once here
        tr1 = 0.0 + 0.0j
        AV = _apply_cols(solver.matvec(level), V, dtype, device)
        proj_B = up(np.linalg.inv(Uref.conj().T @ AV))
    else:
        raise ValueError(f"unknown deflation type {cfg.defl_type!r}")
    return Deflation(U=up(V), tr1=tr1, values=theta, resnorms=eig.resnorms,
                     aux_V=up(Uref), proj_B=proj_B)
