"""The V-cycle and the multigrid-preconditioned FGMRES solver (counterpart
of deflatedmlmc_schwinger_tpu/mg/cycle.py).

V-cycle: pre-smooth from a zero guess with the smoothed residual, restrict;
dense precomputed inverse on the coarsest level; prolongate-correct,
residual, post-smooth on the way up. Solves may start from any level. On a
level-0 StencilOperator the polynomial smoother is kernel K3, the residual
kernel K2 and every other application of D kernel K1; coarser levels run on
their einsum/matmul matvecs.

Two smoothers share one interface (``smooth``, ``smooth_residual``):
``PolySmoother`` (fixed GMRES residual polynomial, no inner products) and
``GmresSmoother`` (k-step GMRES from zero, the default of SolverConfig).
``MGSolver.precond_matvec`` is the fused (z, A z) form of the V-cycle; it is
tested equal to the precond + matvec pair and not used by ``solve``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import Hierarchy
from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator
from deflatedmlmc_schwinger_tpu_torch.solvers.eigs import _apply_cols
from deflatedmlmc_schwinger_tpu_torch.solvers.fgmres import (
    FGMRESResult,
    _dot,
    _norm,
    fgmres,
)
from deflatedmlmc_schwinger_tpu_torch.utils.timer import span


def _solve_hpd_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the batch of m x m Hermitian positive-definite systems
    A y = b (A (B, m, m), b (B, m)) by a Cholesky factorization written out
    over the m columns, m being the smoother depth. Each pivot is clamped,
    d_j = sqrt(max(., 1e-30)), so a singular system (a batch row whose
    right-hand side is zero) gives y = 0 where ``torch.linalg.cholesky``
    would raise or return NaN."""
    m = A.shape[-1]
    L = torch.zeros_like(A)
    d = torch.zeros(A.shape[:-1], dtype=A.real.dtype, device=A.device)
    for j in range(m):
        Lj = L[:, j, :j]
        acc = A[:, j, j].real - (Lj.real ** 2 + Lj.imag ** 2).sum(-1)
        d[:, j] = torch.sqrt(torch.clamp(acc, min=1e-30))
        if j + 1 < m:
            s = A[:, j + 1:, j] - (L[:, j + 1:, :j] * Lj.conj()[:, None, :]).sum(-1)
            L[:, j + 1:, j] = s / d[:, j, None]
    z = torch.zeros_like(b)
    for i in range(m):                      # forward: L z = b
        z[:, i] = (b[:, i] - (L[:, i, :i] * z[:, :i]).sum(-1)) / d[:, i]
    y = torch.zeros_like(b)
    for i in reversed(range(m)):            # backward: L^H y = z
        y[:, i] = (z[:, i] - (L[:, i + 1:, i].conj() * y[:, i + 1:]).sum(-1)) / d[:, i]
    return y


def gmres_smoother(matvec: Callable, r: torch.Tensor, iters: int,
                   group=None) -> torch.Tensor:
    """k-step GMRES from a zero initial guess on a batch r (B, n): modified
    Gram-Schmidt Arnoldi, then the normal equations (H^H H) y = H^H (beta e1)
    by ``_solve_hpd_small``. The iteration count is fixed; beta and the
    subdiagonal norms are guarded by the dtype's smallest normal number, so
    a row whose residual is already zero yields zeros. ``group``: the ranks
    over which the inner products are summed when r is this rank's part of
    lattice-sharded vectors (parallel/sharded_solve.py)."""
    B = r.shape[0]
    m = int(iters)
    tiny = torch.finfo(r.real.dtype).tiny
    beta = _norm(r, group)
    Vs = [r / torch.clamp(beta, min=tiny)[:, None]]
    H = torch.zeros((B, m + 1, m), dtype=r.dtype, device=r.device)
    for j in range(m):
        w = matvec(Vs[j])
        for i in range(j + 1):
            hij = _dot(Vs[i], w, group)
            H[:, i, j] = hij
            w = w - hij[:, None] * Vs[i]
        hn = _norm(w, group)
        H[:, j + 1, j] = hn
        Vs.append(w / torch.clamp(hn, min=tiny)[:, None])
    y = _solve_hpd_small(H.mH @ H, H[:, 0, :].conj() * beta[:, None])
    out = torch.zeros_like(r)
    for j in range(m):
        out = out + y[:, j, None] * Vs[j]
    return out


def arnoldi_leja_roots(apply: Callable[[np.ndarray], np.ndarray], n: int, m: int,
                       seed: int = 29) -> np.ndarray:
    """Roots of the m-step GMRES residual polynomial of a host operator
    (``apply``: complex (n,) -> (n,)): harmonic Ritz values of a short
    Arnoldi run from a seeded Gaussian start vector, in Leja order (which
    keeps the product prod_k (I - A/theta_k) numerically stable)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    V = np.zeros((n, m + 1), dtype=complex)
    H = np.zeros((m + 1, m), dtype=complex)
    V[:, 0] = v / np.linalg.norm(v)
    for j in range(m):
        w = apply(V[:, j])
        for i in range(j + 1):
            H[i, j] = np.vdot(V[:, i], w)
            w = w - H[i, j] * V[:, i]
        H[j + 1, j] = np.linalg.norm(w)
        V[:, j + 1] = w / max(H[j + 1, j].real, 1e-300)
    Hm = H[:m, :m]
    f = np.linalg.solve(Hm.conj().T, np.eye(m)[:, -1])
    theta = np.linalg.eigvals(Hm + (abs(H[m, m - 1]) ** 2) * np.outer(f, np.eye(m)[-1]))
    order = [int(np.argmax(np.abs(theta)))]
    for _ in range(m - 1):
        rest = [i for i in range(m) if i not in order]
        prod = [np.prod([abs(theta[i] - theta[o]) for o in order]) for i in rest]
        order.append(rest[int(np.argmax(prod))])
    return theta[order]


def gmres_poly_roots(matvec: Callable, n: int, dtype: torch.dtype, device, m: int,
                     seed: int = 29) -> np.ndarray:
    """The polynomial smoother's roots for a level operator on the device
    (``matvec`` on (B, n) rows): m matvecs, once per level and depth. Used
    where a hierarchy carries no precomputed roots of the asked depth."""
    return arnoldi_leja_roots(
        lambda v: _apply_cols(matvec, v[:, None], dtype, device)[:, 0], n, m, seed)


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


class GmresSmoother:
    """Fixed-step GMRES smoothing (``gmres_smoother``) with the interface of
    PolySmoother. On the fine stencil level D is applied by kernel K1 and
    the smoothed residual comes from kernel K2. ``group`` as in
    ``gmres_smoother``."""

    def __init__(self, iters: int, group=None):
        self.iters = int(iters)
        self.group = group

    def smooth(self, op, r: torch.Tensor) -> torch.Tensor:
        return gmres_smoother(op.matvec, r, self.iters, self.group)

    def smooth_residual(self, op, b: torch.Tensor):
        x = self.smooth(op, b)
        return x, residual(op, b, x)


def build_v_cycle(levels, coarsest_inv: torch.Tensor, smoothers,
                  with_residual: bool = False, first_level: int = 0) -> Callable:
    """V-cycle closure over an explicit level list; ``smoothers[i]`` pairs
    with ``levels[i]``. With ``with_residual`` the cycle returns
    (x, b - A x): the top level's post-smoother emits its own final residual
    (free from the polynomial recurrence), so the caller's next operator
    application is b minus that residual (MGSolver.precond_matvec).

    Spans (utils/timer.py): ``vcycle`` around one application, and per level
    l of the hierarchy (``first_level`` is the index of ``levels[0]``)
    ``vcycle.l{l}.down`` (pre-smoothing and restriction), ``vcycle.l{l}.up``
    (prolongation, residual and post-smoothing), and ``vcycle.coarsest``."""
    n_up = len(levels) - 1
    down = [f"vcycle.l{first_level + i}.down" for i in range(n_up)]
    up = [f"vcycle.l{first_level + i}.up" for i in range(n_up)][::-1]

    def v_cycle(b: torch.Tensor):
        with span("vcycle"):
            bs = [b]
            xs = []
            for name, lev, sm in zip(down, levels[:-1], smoothers):
                with span(name):
                    x, r = sm.smooth_residual(lev.op, bs[-1])
                    xs.append(x)
                    bs.append(lev.P.apply_adjoint(r))
            with span("vcycle.coarsest"):
                xc = bs[-1] @ coarsest_inv.T
            out_res = None
            for idx, (name, lev, sm, x, bf) in enumerate(zip(
                    up, levels[-2::-1], smoothers[::-1], xs[::-1], bs[-2::-1])):
                with span(name):
                    x = x + lev.P.apply(xc)
                    r = residual(lev.op, bf, x)
                    if with_residual and idx == n_up - 1:
                        dx, out_res = sm.smooth_residual(lev.op, r)
                        xc = x + dx
                    else:
                        xc = x + sm.smooth(lev.op, r)
            if with_residual:
                return xc, out_res
            return xc

    return v_cycle


class MGSolver:
    """Multigrid-preconditioned batched solver over a Hierarchy, with the
    reference's bookkeeping (outer iteration counts, coarsest-level
    applications)."""

    def __init__(self, hier: Hierarchy, cfg: Optional[SolverConfig] = None):
        self.hier = hier
        self.cfg = cfg or SolverConfig()
        self._preconds: Dict[object, Callable] = {}
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
                # a hierarchy without precomputed roots of this depth (the
                # device setup backend stores none): m matvecs on the device
                lev = self.hier.levels[level_index]
                self._poly_roots[level_index] = gmres_poly_roots(
                    lev.op.matvec, lev.n, lev.op.dtype,
                    self.hier.coarsest_inv.device, self.cfg.smooth_iters)
        return self._poly_roots[level_index]

    def _smoothers(self, level: int):
        n_smooth = len(self.hier.levels) - level - 1
        if self.cfg.smoother == "poly":
            return [PolySmoother(self._roots_for(level + i)) for i in range(n_smooth)]
        if self.cfg.smoother == "gmres":
            return [GmresSmoother(self.cfg.smooth_iters)] * n_smooth
        raise ValueError(f"smoother must be 'gmres' or 'poly', got {self.cfg.smoother!r}")

    def matvec(self, level: int = 0) -> Callable:
        return self.hier.levels[level].op.matvec

    def precond(self, level: int = 0) -> Callable:
        if level not in self._preconds:
            self._preconds[level] = build_v_cycle(
                list(self.hier.levels)[level:], self.hier.coarsest_inv,
                self._smoothers(level), first_level=level,
            )
        return self._preconds[level]

    def precond_matvec(self, level: int = 0) -> Callable:
        """v -> (z, A z) with z the V-cycle of v, in one pass: the V-cycle
        emits its own final residual r = v - A z, so A z is the subtraction
        v - r and the outer Arnoldi step needs no operator application
        (solvers/fgmres.py ``matvec_precond``). Algebraically equal to the
        precond + matvec pair; ``solve`` does not use it."""
        key = ("pm", level)
        if key not in self._preconds:
            vc = build_v_cycle(list(self.hier.levels)[level:], self.hier.coarsest_inv,
                               self._smoothers(level), with_residual=True,
                               first_level=level)

            def pm(v: torch.Tensor):
                z, r = vc(v)
                return z, v - r

            self._preconds[key] = pm
        return self._preconds[key]

    def solve(
        self,
        b: Union[torch.Tensor, np.ndarray],
        tol: float,
        *,
        level: int = 0,
        precondition: bool = True,
        max_restarts: Optional[int] = None,
        pred_group=None,
    ) -> FGMRESResult:
        """Solve A_level x = b for a batch b of shape (B, n_level); a numpy
        array is uploaded to the level's device and dtype first.
        ``pred_group``: when b holds this rank's rows of a batch that is
        split over several ranks, the ranks over which the loop predicates
        are any-reduced, so that every row takes the steps it takes when one
        rank solves the whole batch (solvers/fgmres.py)."""
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
            pred_group=pred_group,
        )
        # kept as device scalars: converting here would sync every solve.
        # One coarsest-level application is charged per outer iteration of
        # the slowest row (the reference's rule, up to batching).
        iters = res.iters.max()
        if pred_group is not None:
            # the slowest row of the whole batch, as on one rank
            from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import all_gather_cat

            iters = all_gather_cat(iters[None], pred_group).max()
        self.num_iters = iters
        self.total_solve_calls += 1
        self.coarsest_lev_iters[level] = self.coarsest_lev_iters[level] + iters
        return res

    def coarsest_solve(self, b: torch.Tensor) -> torch.Tensor:
        """Apply the precomputed dense coarsest inverse to (B, n_c) rows."""
        self.coarsest_lev_iters[self.hier.nr_levels - 1] += 1
        return b @ self.hier.coarsest_inv.T
