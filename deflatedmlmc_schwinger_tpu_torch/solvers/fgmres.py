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

Each step's tail (Gram-Schmidt, rotations, residual estimates) is
ops/krylov_kernels.py ``step_tail``: on a CUDA device one launch of the
tail kernel, on the CPU its plain version. A solve over a ``group`` runs the
plain version's per-term loop on any device, since its inner products are
collectives between the terms.

Spans (utils/timer.py): ``fgmres.solve`` around a solve, ``fgmres.cycle``
around a restart cycle, ``fgmres.step`` around an Arnoldi step, and, on the
plain tail only, ``fgmres.mgs`` and ``fgmres.givens`` around a step's
Gram-Schmidt and Givens loops. The host reads of the loop predicates count
under the sites ``fgmres.cycle``, ``fgmres.step`` and ``fgmres.stall``, and
each solve, cycle and step tail under the solve's shape in
``krylov_counts``.

A solve runs over a ``KrylovWorkspace``, the buffers of its shape, which
solves of that shape reuse. Each cycle's head (residual, V[0], zeroed
columns), each step's preconditioner and operator, the cycle's true
residual and the host reads run eagerly; FGMRES's own work, each step's
tail (Gram-Schmidt, rotations, residual estimates) and each cycle's end
(back substitution, x update), reads and writes only the workspace and, on
a CUDA device, replays as CUDA graphs keyed by shape and step index
(utils/graphs.py ``GraphCache``), with the same kernels on the same shapes
as the eager calls. Solves return copies of the workspace's x and
iteration counts.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import partial
from typing import Callable, Dict, NamedTuple, Optional

import torch

from deflatedmlmc_schwinger_tpu_torch.ops.krylov_kernels import (  # noqa: F401 (_dot, _givens: re-exported)
    _dot,
    _givens,
    _norm,
    step_tail,
    step_tail_plain,
)
from deflatedmlmc_schwinger_tpu_torch.utils.graphs import GraphCache, GraphPool
from deflatedmlmc_schwinger_tpu_torch.utils.timer import host_read, krylov_counts, span


class FGMRESResult(NamedTuple):
    x: torch.Tensor          # (B, n) solution
    resnorm: torch.Tensor    # (B,) final true residual norms
    bnorm: torch.Tensor      # (B,) rhs norms
    iters: torch.Tensor      # (B,) int32 Arnoldi steps per row
    cycles: int              # restart cycles used
    stalled: torch.Tensor    # (B,) bool: final residual above tol


def _gany(flag: torch.Tensor, group, site: str) -> bool:
    """The host bool of ``flag``, true on every rank of ``group`` when it is
    true on any: ranks that share a collective inside a loop must agree on
    its trip count, or the next collective never completes. On one rank the
    read counts under ``site``."""
    if group is None:
        return host_read(site, bool, flag)
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import all_any

    return all_any(flag, group)


class KrylovWorkspace:
    """The buffers of one solve shape (device, dtype, B, n, m): the Krylov
    bases V (m + 1, B, n) and Z (m, B, n), the Hessenberg columns H, the
    rotated right-hand side g, the rotations cs and sn, the Givens residual
    estimates ``res``, the per-row step counts ``iters``, the absolute
    tolerances ``tol_abs``, the step tail's input ``w`` (A z of the step) and
    the iterate ``x``. They hold no operator data, so every solver of the
    shape in the process shares one (``_workspace``).

    On a CUDA device (``graphable``) FGMRES's own work, each step tail and
    each cycle end (``step_tail``, ``_cycle_end``: they read and write only
    these buffers), replays as one captured ``torch.cuda.CUDAGraph`` per
    key ("step", j) or ("end", j) (``graphs``, a utils/graphs.py
    ``GraphCache`` with this workspace's own side stream and memory pool:
    first call eager, second captured, later ones replayed). Counted under
    ``fgmres.graph`` in utils/timer.py ``graph_calls``. A replay is one
    ``fgmres.step.graph`` or ``fgmres.end.graph`` span; the plain tail's
    ``fgmres.mgs`` and ``fgmres.givens`` appear on eager calls only."""

    def __init__(self, B: int, n: int, m: int, cdtype: torch.dtype, rdtype: torch.dtype,
                 device, graphable: bool):
        def buf(shape, dtype=cdtype):
            return torch.empty(shape, dtype=dtype, device=device)

        self.V, self.Z = buf((m + 1, B, n)), buf((m, B, n))
        self.H, self.g = buf((B, m + 1, m)), buf((B, m + 1))
        self.cs, self.sn = buf((m, B), rdtype), buf((m, B))
        self.res, self.tol_abs = buf((B,), rdtype), buf((B,), rdtype)
        self.iters = buf((B,), torch.int32)
        self.w, self.x = buf((B, n)), buf((B, n))
        self.graphable = graphable
        self.busy = False
        # keys are bounded by the restart length
        self.graphs = GraphCache("fgmres.graph", GraphPool(device), max_keys=None)

    def run(self, key: tuple, name: str, fn: Callable[[], None]) -> None:
        """Apply ``fn`` (a step tail or a cycle end over these buffers) once,
        through ``graphs`` where this workspace is graphable, else eagerly."""
        self.graphs.run(key if self.graphable else None, fn, name)


# the workspaces held for reuse, one per solve shape, at most MAX_WORKSPACES
MAX_WORKSPACES = 4
_workspaces: Dict[tuple, KrylovWorkspace] = {}


@contextmanager
def _workspace(b: torch.Tensor, m: int, rdtype: torch.dtype, group):
    """The held workspace of b's solve shape, made at the shape's first
    solve. A solve over a ``group`` of ranks (its inner products are
    collectives), a shape past ``MAX_WORKSPACES`` held ones, and a solve
    that starts while another of its shape runs get fresh buffers, and run
    eagerly."""
    B, n = b.shape
    key = (b.device, b.dtype, B, n, m)
    ws = _workspaces.get(key) if group is None else None
    if ws is None and group is None and len(_workspaces) < MAX_WORKSPACES:
        ws = _workspaces[key] = KrylovWorkspace(B, n, m, b.dtype, rdtype, b.device,
                                                graphable=b.is_cuda)
    if ws is None or ws.busy:
        ws = KrylovWorkspace(B, n, m, b.dtype, rdtype, b.device, graphable=False)
    ws.busy = True
    try:
        yield ws
    finally:
        ws.busy = False


def _cycle_end(ws: KrylovWorkspace, j: int, tiny: float) -> None:
    """The end of a cycle that took j steps: back substitution on the
    rotated upper-triangular system, then x += Z[:j] y."""
    B, m = ws.H.shape[0], ws.H.shape[2]
    dev = ws.H.device
    # unused columns (>= j) carry identity diagonal and zero rhs -> y = 0
    used = torch.arange(m, device=dev) < j
    R = ws.H[:, :m, :m].clone()
    diag = torch.arange(m, device=dev)
    R[:, diag, diag] = torch.where(used[None, :], R[:, diag, diag],
                                   torch.ones_like(R[:, diag, diag]))
    rhs = torch.where(used[None, :], ws.g[:, :m], torch.zeros_like(ws.g[:, :m]))
    y = torch.zeros((B, m), dtype=ws.H.dtype, device=dev)
    for jj in range(m - 1, -1, -1):
        s = rhs[:, jj] - (R[:, jj, :] * y).sum(-1)
        d = R[:, jj, jj]
        y[:, jj] = s * d.conj() / torch.clamp(d.real ** 2 + d.imag ** 2, min=tiny)
    ws.x.add_(torch.einsum("jbn,bj->bn", ws.Z[:j], y[:, :j]))


def _fgmres_impl(matvec: Callable, precond: Callable, b: torch.Tensor,
                 x0: torch.Tensor, tol_abs: torch.Tensor, restart: int,
                 max_restarts: int, stall_ratio: Optional[float],
                 stall_cycles: int, group=None, pred_group=None):
    m = restart
    tiny = torch.finfo(tol_abs.dtype).tiny
    # the kernel on a card; a group's inner products are collectives between
    # the terms, which no kernel can hold
    tail = step_tail if group is None else partial(step_tail_plain, group=group)
    counts = krylov_counts[(*b.shape, b.element_size())]
    counts["solves"] += 1
    with _workspace(b, m, tol_abs.dtype, group) as ws:
        V, Z = ws.V, ws.Z
        ws.tol_abs.copy_(tol_abs)
        ws.iters.zero_()
        ws.x.copy_(x0)
        resnorm = _norm(b - matvec(ws.x), group)
        cycles = 0
        stalls = 0
        while (cycles < max_restarts and stalls < stall_cycles
               and _gany((resnorm > tol_abs).any(), pred_group, "fgmres.cycle")):
            counts["cycles"] += 1
            with span("fgmres.cycle"):
                r = b - matvec(ws.x)
                beta = _norm(r, group)
                V[0] = r / torch.clamp(beta, min=tiny)[:, None]
                ws.H.zero_()
                ws.g.zero_()
                ws.g[:, 0] = beta
                ws.cs.zero_()
                ws.sn.zero_()
                ws.res.copy_(beta)
                j = 0
                while j < m and _gany((ws.res > ws.tol_abs).any(), pred_group,
                                      "fgmres.step"):
                    with span("fgmres.step"):
                        z = precond(V[j])
                        w = matvec(z)
                        Z[j] = z
                        ws.w.copy_(w)
                        ws.run(("step", j), "fgmres.step.graph",
                               partial(tail, ws, j, tiny))
                    counts["tails"] += 1
                    counts["j_sum"] += j
                    j += 1
                ws.run(("end", j), "fgmres.end.graph", partial(_cycle_end, ws, j, tiny))
                true_res = _norm(b - matvec(ws.x), group)
                if stall_ratio is not None:
                    # progress on the still-active rows only
                    active_prev = torch.where(resnorm > tol_abs, resnorm,
                                              torch.zeros_like(resnorm))
                    progressing = _gany((true_res < stall_ratio * active_prev).any(),
                                        pred_group, "fgmres.stall")
                    stalls = 0 if progressing else stalls + 1
                resnorm = true_res
            cycles += 1
        # copies: the next solve of this shape reuses the workspace
        return ws.x.clone(), resnorm, ws.iters.clone(), cycles


def fgmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    tol: float,
    restart: int = 20,
    max_restarts: int = 10,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    x0: Optional[torch.Tensor] = None,
    stall_ratio: Optional[float] = 0.9,
    stall_cycles: int = 2,
    group=None,
    pred_group=None,
) -> FGMRESResult:
    """Solve A x = b for a batch of complex right-hand sides b (B, n).
    ``stall_ratio=None`` disables the stall cutoff.

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
            group, pred_group,
        )
        return FGMRESResult(x=x, resnorm=res, bnorm=bnorm, iters=iters,
                            cycles=cycles, stalled=res > tol_abs)


def _identity(v: torch.Tensor) -> torch.Tensor:
    return v
