"""The tail of an Arnoldi step of FGMRES (CUDA C++, ``csrc/krylov.cu
krylov_tail_reduce_kernel``), its plain PyTorch version, the inner products
and norms FGMRES shares with it, the launch plan and a launch counter.

Step j's tail, after the step's preconditioner and operator have set Z[j]
and w = A z, over a solve's buffers (solvers/fgmres.py ``KrylovWorkspace``:
V, H, g, cs, sn, res, tol_abs, iters, w): the active rows' step counts,
modified Gram-Schmidt of w against V[0..j] into V[j+1], the earlier Givens
rotations and a new one on the Hessenberg column, the rotated right-hand
side and the active rows' residual estimates.

  * ``step_tail``: a CUDA workspace launches the kernel, once a step (or
    raises); a CPU workspace takes ``step_tail_plain``.
  * ``step_tail_plain``: the per-term loop in plain PyTorch. With ``group``
    (a lattice-sharded solve, parallel/sharded_solve.py) each inner product
    and norm is a collective over the ranks that share the rows, between
    the terms, so such a solve runs it on any device.

The kernel reads V[0..j] and w once and writes V[j+1] once: a probe is one
thread-block cluster whose CTAs hold slices of w in registers while V's
slices stream through shared memory (the design in the source). Its sums
take another order than PyTorch's, so on the card it agrees with the plain
version to rounding, and with itself bit for bit. The kernel is built into
the same library as K1-K4 (``stencil_kernels.load_library``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk
from deflatedmlmc_schwinger_tpu_torch.utils.timer import span

THREADS = 256                    # kTailThreads in csrc/krylov.cu
MAX_CLUSTERS = 8                 # kTailMaxClusters: the portable cluster size
MAX_STAGES = 8                   # kTailMaxStages
BAR_BYTES = 8 * (MAX_STAGES + 2)  # kTailBarBytes: the ring's and the exchange's
MAX_PER_THREAD = 16              # kTailMaxPerThread: elements of w a thread holds on chip
# What launch_plan aims at: the fewest CTAs a probe whose slices are at most
# SLICE_BYTES, and STAGES ring slots (bench_torch/krylov_sweep.py, PERF.md).
SLICE_BYTES = 32768
STAGES = 3
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


# ---- inner products and norms (FGMRES shares them) ----------------------------

def _psum(s: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partial sums over ``group`` (None: no ranks to sum
    over, and no collective)."""
    if group is None:
        return s
    # imported here: parallel/ imports the solvers
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import all_sum

    return all_sum(s, group)


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


# ---- plain PyTorch version ------------------------------------------------------

def step_tail_plain(ws, j: int, tiny: float, group=None) -> None:
    """Arnoldi step j after its preconditioner and operator (Z[j] and w
    set): the active rows' step counts, modified Gram-Schmidt of w against
    V[0..j] into V[j+1], the earlier rotations and a new one on the column,
    the rotated right-hand side and the active rows' residual estimates."""
    B, m = ws.H.shape[0], ws.H.shape[2]
    V, H, g, cs, sn, res = ws.V, ws.H, ws.g, ws.cs, ws.sn, ws.res
    active = res > ws.tol_abs
    ws.iters += active.to(torch.int32)
    w = ws.w
    hcol = torch.zeros((B, m + 1), dtype=V.dtype, device=V.device)
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
        res.copy_(torch.where(active, g[:, j + 1].abs(), res))


# ---- launches ------------------------------------------------------------------

class TailPlan(NamedTuple):
    """A launch: ``clusters`` CTAs a probe, ``per_thread`` elements of a
    probe's slice a thread, and ``stages`` ring slots; stages 0 is the
    device-memory form (w updated in place in device memory)."""
    clusters: int
    per_thread: int
    stages: int

    @property
    def on_chip(self) -> bool:
        return self.stages > 0


def smem_bytes(plan: TailPlan, m: int, itemsize: int) -> int:
    """Dynamic shared memory of a launch (csrc/krylov.cu tail_smem_bytes):
    the ring, the mbarriers, the two sets of cluster-exchange slots, the
    warp sums, the column and the earlier rotations."""
    ring = plan.stages * plan.per_thread * THREADS * itemsize if plan.on_chip else 0
    return (ring + BAR_BYTES + (2 * MAX_CLUSTERS + THREADS // 32 + (m + 1) + m) * itemsize
            + m * itemsize // 2)


def launch_plan(n: int, m: int, itemsize: int, clusters: Optional[int] = None,
                stages: Optional[int] = None) -> TailPlan:
    """The plan for probes of n elements and restart length m: the fewest
    CTAs a probe (1, 2, 4 or 8) whose slices fit SLICE_BYTES, unless
    ``clusters`` is given, and the fewest elements a thread that cover a
    slice; the on-chip form where those are at most MAX_PER_THREAD, whole
    slices are 16-byte aligned and the ring of ``stages`` (default STAGES)
    slots fits a block's shared memory, else the device-memory form."""
    if n <= 0:
        raise ValueError(f"no Arnoldi step tail for probes of {n} elements")
    per = lambda c: -(-n // (c * THREADS))  # noqa: E731
    if clusters is None:
        clusters = next((c for c in (1, 2, 4, 8) if per(c) * THREADS * itemsize <= SLICE_BYTES),
                        MAX_CLUSTERS)
    if clusters not in (1, 2, 4, 8):
        raise ValueError(f"clusters must be 1, 2, 4 or 8, got {clusters}")
    stages = STAGES if stages is None else stages
    if not 2 <= stages <= MAX_STAGES:
        raise ValueError(f"stages must be within [2, {MAX_STAGES}], got {stages}")
    k = per(clusters)
    plan = TailPlan(clusters, k, stages)
    if ((n * itemsize) % 16 == 0 and k <= MAX_PER_THREAD
            and smem_bytes(plan, m, itemsize) <= sk.MAX_SMEM):
        return plan
    return TailPlan(clusters, k, 0)


def check_operands(ws, j: int):
    """Validate a workspace for step j's launch (any device: the tests call
    it on the CPU); returns (dtype suffix, B, n, m)."""
    V = ws.V
    if V.dtype not in _REAL:
        raise TypeError(f"the step tail takes complex64/complex128, got {V.dtype}")
    if V.dim() != 3:
        raise ValueError(f"V must be (m + 1, B, n), got {tuple(V.shape)}")
    m, B, n = V.shape[0] - 1, V.shape[1], V.shape[2]
    rdt = _REAL[V.dtype]
    want = {"V": ((m + 1, B, n), V.dtype), "H": ((B, m + 1, m), V.dtype),
            "g": ((B, m + 1), V.dtype), "cs": ((m, B), rdt), "sn": ((m, B), V.dtype),
            "res": ((B,), rdt), "tol_abs": ((B,), rdt), "iters": ((B,), torch.int32),
            "w": ((B, n), V.dtype)}
    for name, (shape, dtype) in want.items():
        t = getattr(ws, name)
        if t.device != V.device:
            raise ValueError(f"{name} is on {t.device}, V on {V.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= j < m:
        raise ValueError(f"step {j} outside the restart length {m}")
    return sk._SUFFIX[V.dtype], B, n, m


_fns: dict = {}                  # dtype suffix -> ctypes function
_plans: dict = {}                # (n, m, itemsize) -> launch_plan


def _fn(sfx: str):
    fn = _fns.get(sfx)
    if fn is None:
        P = ctypes.c_void_p
        fn = getattr(sk.load_library(), f"dmlmc_krylov_tail_{sfx}")
        fn.argtypes = [P] * 10 + [ctypes.c_double, P]
        fn.restype = ctypes.c_int
        _fns[sfx] = fn
    return fn


def step_tail(ws, j: int, tiny: float, plan: Optional[TailPlan] = None) -> None:
    """Step j's tail over the workspace ``ws``: on a CUDA device one launch
    of the kernel, with ``plan`` or the cached ``launch_plan`` of the shape
    (the device-memory form leaves ws.w overwritten); on the CPU
    ``step_tail_plain``. ``.launches`` counts launches (a replayed CUDA
    graph bypasses it)."""
    if not sk._dispatch(ws.w):
        step_tail_plain(ws, j, tiny)
        return
    sfx, B, n, m = check_operands(ws, j)
    if not B:
        return
    itemsize = ws.V.element_size()
    if plan is None:
        key = (n, m, itemsize)
        plan = _plans.get(key)
        if plan is None:
            plan = _plans[key] = launch_plan(n, m, itemsize)
    dev = ws.V.device.index
    cfg = (ctypes.c_longlong * 8)(n, B, m, j, plan.clusters, plan.per_thread, plan.stages,
                                  dev)
    sk._check(_fn(sfx)(ws.V.data_ptr(), ws.H.data_ptr(), ws.g.data_ptr(), ws.cs.data_ptr(),
                       ws.sn.data_ptr(), ws.res.data_ptr(), ws.tol_abs.data_ptr(),
                       ws.iters.data_ptr(), ws.w.data_ptr(), cfg, float(tiny),
                       sk._raw_stream(dev)), "krylov step tail")
    step_tail.launches += 1


step_tail.launches = 0
