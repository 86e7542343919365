"""Batched flexible GMRES with fixed Krylov buffers (counterpart of
deflatedmlmc_schwinger_tpu/solvers/fgmres.py).

Solves a batch of right-hand sides (B, n) at once with modified
Gram-Schmidt Arnoldi, complex Givens rotations and per-row active masks:
every row steps until the slowest converges, and ``iters`` counts the steps
in which a row was still active. Restart cycles end on the TRUE residual
(one extra matvec per cycle), never on the Givens estimate, and a stall
cutoff ends the solve after ``stall_cycles`` consecutive cycles in which no
active row improved by more than (1 - stall_ratio). The loops are Python
loops; each Arnoldi step reads one bool (any row still active) on the host.

Inside a lattice-sharded solve (parallel/sharded_solve.py) the vector axis
holds this rank's part of the lattice: ``group`` then sums every norm and
inner product over the ranks that share the rows, and ``pred_group``
any-reduces every bool that steers a loop, so that all ranks take the same
number of steps. Without them no collective is made.

Spans (utils/timer.py): ``fgmres.solve`` around a solve, ``fgmres.cycle``
around a restart cycle, ``fgmres.step`` around an Arnoldi step, and
``fgmres.mgs`` and ``fgmres.givens`` around a step's Gram-Schmidt and Givens
loops. The host reads of the loop predicates count under the sites
``fgmres.cycle``, ``fgmres.step`` and ``fgmres.stall``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from deflatedmlmc_schwinger_tpu_torch.utils.timer import host_read, span


class FGMRESResult(NamedTuple):
    x: torch.Tensor          # (B, n) solution
    resnorm: torch.Tensor    # (B,) final true residual norms
    bnorm: torch.Tensor      # (B,) rhs norms
    iters: torch.Tensor      # (B,) int32 Arnoldi steps per row
    cycles: int              # restart cycles used
    stalled: torch.Tensor    # (B,) bool: final residual above tol


def _psum(s: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partial sums over ``group`` (None: no ranks to sum
    over, and no collective)."""
    if group is None:
        return s
    # imported here: parallel/ imports the solvers
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import all_sum

    return all_sum(s, group)


def _gany(flag: torch.Tensor, group, site: str) -> bool:
    """The host bool of ``flag``, true on every rank of ``group`` when it is
    true on any: ranks that share a collective inside a loop must agree on
    its trip count, or the next collective never completes. On one rank the
    read counts under ``site``."""
    if group is None:
        return host_read(site, bool, flag)
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import all_any

    return all_any(flag, group)


def _norm(x: torch.Tensor, group=None) -> torch.Tensor:
    return torch.sqrt(_psum((x.real ** 2 + x.imag ** 2).sum(-1), group))


def _dot(x: torch.Tensor, y: torch.Tensor, group=None) -> torch.Tensor:
    """<x, y> = sum conj(x) y along the last axis."""
    return _psum((x.conj() * y).sum(-1), group)


def _givens(a: torch.Tensor, b: torch.Tensor, tiny: float):
    """Complex Givens rotation: c real, s complex with
    [c, s; -conj(s), c] @ [a, b]^T = [r, 0]^T."""
    na = a.abs()
    nb = b.abs()
    t = torch.sqrt(na * na + nb * nb)
    t_safe = torch.clamp(t, min=tiny)
    na_safe = torch.clamp(na, min=tiny)
    c = na / t_safe
    s = (a / na_safe) * b.conj() / t_safe
    s_a0 = b.conj() / torch.clamp(nb, min=tiny)
    s = torch.where(na > 0, s, s_a0)
    c = torch.where(na > 0, c, torch.zeros_like(c))
    c = torch.where(t > 0, c, torch.ones_like(c))
    s = torch.where(t > 0, s, torch.zeros_like(s))
    return c, s, c * a + s * b


def _fgmres_impl(matvec: Callable, precond: Callable, b: torch.Tensor,
                 x0: torch.Tensor, tol_abs: torch.Tensor, restart: int,
                 max_restarts: int, stall_ratio: Optional[float],
                 stall_cycles: int, matvec_precond: Optional[Callable] = None,
                 group=None, pred_group=None):
    B, n = b.shape
    m = restart
    cdtype = b.dtype
    tiny = torch.finfo(tol_abs.dtype).tiny
    dev = b.device
    # Krylov buffers allocated once per solve, reused by every restart
    V = torch.empty((m + 1, B, n), dtype=cdtype, device=dev)
    Z = torch.empty((m, B, n), dtype=cdtype, device=dev)

    x = x0
    resnorm = _norm(b - matvec(x0), group)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    cycles = 0
    stalls = 0
    while (cycles < max_restarts and stalls < stall_cycles
           and _gany((resnorm > tol_abs).any(), pred_group, "fgmres.cycle")):
        with span("fgmres.cycle"):
            r = b - matvec(x)
            beta = _norm(r, group)
            V[0] = r / torch.clamp(beta, min=tiny)[:, None]
            H = torch.zeros((B, m + 1, m), dtype=cdtype, device=dev)
            g = torch.zeros((B, m + 1), dtype=cdtype, device=dev)
            g[:, 0] = beta
            cs = torch.zeros((m, B), dtype=beta.dtype, device=dev)
            sn = torch.zeros((m, B), dtype=cdtype, device=dev)
            res = beta
            j = 0
            while j < m and _gany((res > tol_abs).any(), pred_group, "fgmres.step"):
                with span("fgmres.step"):
                    active = res > tol_abs
                    iters += active.to(torch.int32)
                    if matvec_precond is not None:
                        # the V-cycle's own final residual gives A z = v - r,
                        # which saves this step's operator application
                        z, w = matvec_precond(V[j])
                    else:
                        z = precond(V[j])
                        w = matvec(z)
                    Z[j] = z
                    hcol = torch.zeros((B, m + 1), dtype=cdtype, device=dev)
                    with span("fgmres.mgs"):
                        for i in range(j + 1):           # modified Gram-Schmidt
                            hi = _dot(V[i], w, group)
                            w = w - hi[:, None] * V[i]
                            hcol[:, i] = hi
                        hnorm = _norm(w, group)
                        hcol[:, j + 1] = hnorm
                        V[j + 1] = w / torch.clamp(hnorm, min=tiny)[:, None]
                    with span("fgmres.givens"):
                        for i in range(j):
                            hi, hip1 = hcol[:, i], hcol[:, i + 1]
                            new_i = cs[i] * hi + sn[i] * hip1
                            new_ip1 = cs[i] * hip1 - sn[i].conj() * hi
                            hcol[:, i] = new_i
                            hcol[:, i + 1] = new_ip1
                        c_new, s_new, r_new = _givens(hcol[:, j], hcol[:, j + 1], tiny)
                        hcol[:, j] = r_new
                        hcol[:, j + 1] = 0
                        cs[j] = c_new
                        sn[j] = s_new
                        gj = g[:, j].clone()
                        g[:, j] = c_new * gj
                        g[:, j + 1] = -s_new.conj() * gj
                        H[:, :, j] = hcol
                        res = torch.where(active, g[:, j + 1].abs(), res)
                j += 1

            # back substitution on the rotated upper-triangular system;
            # unused columns (>= j) carry identity diagonal and zero rhs -> y = 0
            used = torch.arange(m, device=dev) < j
            R = H[:, :m, :m].clone()
            diag = torch.arange(m, device=dev)
            R[:, diag, diag] = torch.where(used[None, :], R[:, diag, diag],
                                           torch.ones_like(R[:, diag, diag]))
            rhs = torch.where(used[None, :], g[:, :m], torch.zeros_like(g[:, :m]))
            y = torch.zeros((B, m), dtype=cdtype, device=dev)
            for jj in range(m - 1, -1, -1):
                s = rhs[:, jj] - (R[:, jj, :] * y).sum(-1)
                d = R[:, jj, jj]
                y[:, jj] = s * d.conj() / torch.clamp(d.real ** 2 + d.imag ** 2, min=tiny)
            x = x + torch.einsum("jbn,bj->bn", Z[:j], y[:, :j])
            true_res = _norm(b - matvec(x), group)
            if stall_ratio is not None:
                # progress on the still-active rows only
                active_prev = torch.where(resnorm > tol_abs, resnorm,
                                          torch.zeros_like(resnorm))
                progressing = _gany((true_res < stall_ratio * active_prev).any(),
                                    pred_group, "fgmres.stall")
                stalls = 0 if progressing else stalls + 1
            resnorm = true_res
        cycles += 1
    return x, resnorm, iters, cycles


def fgmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    tol: float,
    restart: int = 20,
    max_restarts: int = 10,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    matvec_precond: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    stall_ratio: Optional[float] = 0.9,
    stall_cycles: int = 2,
    group=None,
    pred_group=None,
) -> FGMRESResult:
    """Solve A x = b for a batch of complex right-hand sides b (B, n).
    ``stall_ratio=None`` disables the stall cutoff. ``matvec_precond``: an
    optional fused v -> (z, A z) with z = M v; when given it replaces the
    precond + matvec pair of every Arnoldi step (the true residuals at the
    restart boundaries still use ``matvec``).

    ``group``: set when the vector axis holds this rank's part of a
    lattice-sharded vector; all norms and inner products then sum their
    partial sums over it (a parallel/distributed.py Group).

    ``pred_group``: the ranks over which the loop predicates are any-reduced.
    It must cover every rank that runs collectives inside this solve or
    inside ``matvec``/``precond``, also ranks that hold other rows: rows that
    converge early ride on until the slowest row of the whole batch ends, as
    they do on one device, at the cost of one scalar reduction per step."""
    with span("fgmres.solve"):
        if x0 is None:
            x0 = torch.zeros_like(b)
        if precond is None:
            precond = _identity
        bnorm = _norm(b, group)
        tol_abs = tol * bnorm
        x, res, iters, cycles = _fgmres_impl(
            matvec, precond, b, x0, tol_abs, int(restart), int(max_restarts),
            None if stall_ratio is None else float(stall_ratio), int(stall_cycles),
            matvec_precond, group, pred_group,
        )
        return FGMRESResult(x=x, resnorm=res, bnorm=bnorm, iters=iters,
                            cycles=cycles, stalled=res > tol_abs)


def _identity(v: torch.Tensor) -> torch.Tensor:
    return v
