"""FGMRES split into eager parts and a graphable step tail and cycle end over
a workspace held per solve shape (solvers/fgmres.py ``KrylovWorkspace``,
``_workspace``; the ``fgmres.graph`` counter of ``graph_calls`` in
utils/timer.py). The graph cache itself and the counters are held in
tests/test_torch_graphs.py.

On the CPU, port only (no JAX): the restructured solve gives the bits of a
frozen copy of the one loop it replaced (``_frozen_fgmres`` below), in
complex128 and complex64, over one cycle and over restarts, from a nonzero
x0, on the stall path (a crippled preconditioner) and through
``MGSolver.solve``; a second solve of a shape leaves the first's results
alone; a solve nested in another of its shape runs on fresh buffers with
the same result; which workspace a solve gets (CPU, a ``group`` of ranks,
past ``MAX_WORKSPACES``) and that a workspace that cannot graph runs every
call eagerly.

On the card (marked ``card``, skipped without one; this file imports no JAX,
so run it without the JAX package's conftest:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fgmres_graph.py``),
on the 128^2 hierarchy of the sampling cells (batches of 128, complex64): a
graphed ``MGSolver.solve`` against the eager one bit for bit, replays on new
probes with an earlier solve's results held, and the counter over a shape's
first, second and third solves.
"""

import importlib
from typing import Callable, Optional

import pytest

torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.solvers.fgmres import (  # noqa: E402
    KrylovWorkspace,
    _dot,
    _gany,
    _givens,
    _norm,
    fgmres,
)
from deflatedmlmc_schwinger_tpu_torch.utils import timer  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import setup_or_load_hierarchy  # noqa: E402

# the package's solvers/__init__ exports the function fgmres under the module's name
fgmres_mod = importlib.import_module("deflatedmlmc_schwinger_tpu_torch.solvers.fgmres")

N = 48          # dense test operator
B_CARD = 128    # the cells' probe batch


# ---- the loop as it was before the split, frozen ------------------------------

def _frozen_impl(matvec: Callable, precond: Callable, b: torch.Tensor,
                 x0: torch.Tensor, tol_abs: torch.Tensor, restart: int,
                 max_restarts: int, stall_ratio: Optional[float],
                 stall_cycles: int, group=None, pred_group=None):
    B, n = b.shape
    m = restart
    cdtype = b.dtype
    tiny = torch.finfo(tol_abs.dtype).tiny
    dev = b.device
    V = torch.empty((m + 1, B, n), dtype=cdtype, device=dev)
    Z = torch.empty((m, B, n), dtype=cdtype, device=dev)

    x = x0
    resnorm = _norm(b - matvec(x0), group)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    cycles = 0
    stalls = 0
    while (cycles < max_restarts and stalls < stall_cycles
           and _gany((resnorm > tol_abs).any(), pred_group, "fgmres.cycle")):
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
            active = res > tol_abs
            iters += active.to(torch.int32)
            z = precond(V[j])
            w = matvec(z)
            Z[j] = z
            hcol = torch.zeros((B, m + 1), dtype=cdtype, device=dev)
            for i in range(j + 1):
                hi = _dot(V[i], w, group)
                w = w - hi[:, None] * V[i]
                hcol[:, i] = hi
            hnorm = _norm(w, group)
            hcol[:, j + 1] = hnorm
            V[j + 1] = w / torch.clamp(hnorm, min=tiny)[:, None]
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
            active_prev = torch.where(resnorm > tol_abs, resnorm,
                                      torch.zeros_like(resnorm))
            progressing = _gany((true_res < stall_ratio * active_prev).any(),
                                pred_group, "fgmres.stall")
            stalls = 0 if progressing else stalls + 1
        resnorm = true_res
        cycles += 1
    return x, resnorm, iters, cycles


def _frozen_fgmres(matvec, b, *, tol, restart=20, max_restarts=10, precond=None,
                   x0=None, stall_ratio=0.9, stall_cycles=2):
    """``fgmres`` as it was, around the frozen loop."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    bnorm = _norm(b)
    tol_abs = tol * bnorm
    x, res, iters, cycles = _frozen_impl(
        matvec, precond or (lambda v: v), b, x0, tol_abs, restart, max_restarts,
        stall_ratio, stall_cycles)
    return fgmres_mod.FGMRESResult(x=x, resnorm=res, bnorm=bnorm, iters=iters,
                                   cycles=cycles, stalled=res > tol_abs)


# ---- helpers and fixtures -------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No workspace held from another test, and the counter at zero."""
    monkeypatch.setattr(fgmres_mod, "_workspaces", {})
    timer.reset_graph_calls()
    yield
    timer.reset_graph_calls()


def _randc(shape, seed, dtype, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(shape, generator=g, dtype=torch.float64) \
        + 1j * torch.randn(shape, generator=g, dtype=torch.float64)
    return v.to(dtype=dtype, device=device)


def _dense(dtype, seed=3):
    """A well-conditioned dense operator and a rough preconditioner (the
    inverse of a perturbed copy), both on rows: v -> v @ M^T."""
    A = torch.eye(N, dtype=torch.complex128) + 0.3 * _randc((N, N), seed, torch.complex128) / N ** 0.5
    Minv = torch.linalg.inv(A + 0.2 * _randc((N, N), seed + 1, torch.complex128) / N ** 0.5)
    A, Minv = A.to(dtype), Minv.to(dtype)
    return (lambda v: v @ A.T), (lambda v: v @ Minv.T)


def _crippled(v: torch.Tensor) -> torch.Tensor:
    """A preconditioner that drops a third of every vector: the solve
    cannot reduce the residual there and stalls."""
    z = v.clone()
    z[:, : N // 3] = 0
    return z


def _equal(got, want):
    assert got.cycles == want.cycles
    for name in ("x", "resnorm", "bnorm", "iters", "stalled"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name


CASES = {
    # name: (dtype, tol, keyword arguments of the solve)
    "c128_one_cycle": (torch.complex128, 1e-10, dict(restart=40)),
    "c64_one_cycle": (torch.complex64, 1e-5, dict(restart=40)),
    "c128_restarts": (torch.complex128, 1e-10, dict(restart=4, max_restarts=20,
                                                     stall_ratio=None)),
    "c64_restarts": (torch.complex64, 1e-5, dict(restart=3, max_restarts=20)),
    "c128_stall": (torch.complex128, 1e-10, dict(restart=5, max_restarts=10,
                                                  stall_ratio=0.9, stall_cycles=2)),
    "c64_stall": (torch.complex64, 1e-5, dict(restart=5, max_restarts=10,
                                               stall_ratio=0.9, stall_cycles=2)),
    "c128_x0": (torch.complex128, 1e-10, dict(restart=6, max_restarts=10)),
}


# ---- on the CPU -------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_equals_the_frozen_loop(case):
    """Bit for bit: x, resnorm, bnorm, iters, stalled and cycles."""
    dtype, tol, kw = CASES[case]
    matvec, precond = _dense(dtype)
    if case.endswith("stall"):
        precond = _crippled
    b = _randc((5, N), 11, dtype)
    kw = dict(kw, precond=precond)
    if case.endswith("x0"):
        kw["x0"] = _randc((5, N), 12, dtype)
    want = _frozen_fgmres(matvec, b, tol=tol, **kw)
    got = fgmres(matvec, b, tol=tol, **kw)
    _equal(got, want)
    if case.endswith("restarts"):
        assert got.cycles > 1 and not bool(got.stalled.any())
    if case.endswith("stall"):
        assert got.cycles < kw["max_restarts"] and bool(got.stalled.all())
    calls = timer.graph_calls["fgmres.graph"]
    steps = calls["eager"] - got.cycles                       # one cycle end a cycle
    assert steps >= int(got.iters.max())
    assert calls["captures"] == calls["replays"] == 0


@pytest.fixture(scope="module")
def small():
    """The schwinger128 profile on a 32^2 lattice (levels of 2048, 512, 128
    and 32 unknowns)."""
    return _hierarchy(32, "cpu")


def _hierarchy(n: int, device):
    cfg = set_params("schwinger128").replace(
        matrix=f"generated:{n}x{n}:beta=5.0:seed=11", mass=-0.17, latt_dims=(n, n))
    op = generate_operator(n, n, cfg.mass, beta=5.0, seed=11, dtype=cfg.dtype, device=device)
    return cfg, op, setup_or_load_hierarchy(op, cfg, None, lambda *a, **k: None)


@pytest.mark.parametrize("level", [0, 1])
def test_mg_solve_equals_the_frozen_loop(small, level):
    """Through MGSolver.solve (V-cycle preconditioner, complex64) on levels
    0 and 1, twice on one held workspace."""
    cfg, _, hier = small
    solver = MGSolver(hier, cfg.solver)
    b = _randc((6, hier.sizes()[level]), 2 + level, cfg.dtype)
    tol = cfg.solver.effective_tol(cfg.function_tol, b.dtype)
    want = _frozen_fgmres(solver.matvec(level), b, tol=tol, restart=cfg.solver.restart,
                          max_restarts=cfg.solver.max_restarts,
                          precond=solver.precond(level),
                          stall_ratio=cfg.solver.stall_ratio,
                          stall_cycles=cfg.solver.stall_cycles)
    for _ in range(2):
        _equal(solver.solve(b, cfg.function_tol, level=level), want)
    assert len(fgmres_mod._workspaces) == 1


def test_a_second_solve_leaves_the_first_results_alone():
    matvec, precond = _dense(torch.complex128)
    kw = dict(tol=1e-10, restart=40, precond=precond)
    b1, b2 = _randc((5, N), 21, torch.complex128), _randc((5, N), 22, torch.complex128)
    r1 = fgmres(matvec, b1, **kw)
    held = [t.clone() for t in (r1.x, r1.resnorm, r1.iters, r1.stalled)]
    r2 = fgmres(matvec, b2, **kw)
    assert len(fgmres_mod._workspaces) == 1
    for t, h in zip((r1.x, r1.resnorm, r1.iters, r1.stalled), held):
        assert torch.equal(t, h)
    ws = next(iter(fgmres_mod._workspaces.values()))
    assert r1.x.data_ptr() != ws.x.data_ptr() and r2.iters.data_ptr() != ws.iters.data_ptr()
    _equal(r2, _frozen_fgmres(matvec, b2, **kw))


def test_a_nested_solve_of_the_same_shape_runs_on_fresh_buffers():
    """A preconditioner that solves a system of the outer solve's shape on
    its first call: the inner solve runs while the held workspace is busy,
    on buffers of its own, and both results equal the frozen loop's."""
    matvec, precond = _dense(torch.complex128)
    kw = dict(tol=1e-10, restart=40)
    b_in = _randc((5, N), 31, torch.complex128)
    inner = []

    def nesting(v):
        if not inner:
            ws = next(iter(fgmres_mod._workspaces.values()))
            assert ws.busy
            inner.append(fgmres(matvec, b_in, precond=precond, **kw))
            assert ws.busy and len(fgmres_mod._workspaces) == 1
        return precond(v)

    b = _randc((5, N), 32, torch.complex128)
    got = fgmres(matvec, b, precond=nesting, **kw)
    _equal(inner[0], _frozen_fgmres(matvec, b_in, precond=precond, **kw))
    _equal(got, _frozen_fgmres(matvec, b, precond=precond, **kw))
    assert not next(iter(fgmres_mod._workspaces.values())).busy


def test_routes():
    """CPU solves run on the held workspace, which cannot graph: every call
    of a key is eager; a solve over a group of ranks and a shape past
    MAX_WORKSPACES held ones get fresh buffers, which cannot graph either."""
    cdt, rdt = torch.complex64, torch.float32
    b = torch.zeros((4, 8), dtype=cdt)
    with fgmres_mod._workspace(b, 5, rdt, None) as ws:
        assert fgmres_mod._workspaces[(b.device, cdt, 4, 8, 5)] is ws
        assert not ws.graphable
        assert ws.V.shape == (6, 4, 8) and ws.Z.shape == (5, 4, 8)
        assert ws.H.shape == (4, 6, 5) and ws.cs.dtype == rdt and ws.iters.dtype == torch.int32
        ran = []
        for _ in range(3):
            ws.run(("step", 0), "fgmres.step.graph", lambda: ran.append(1))
        assert len(ran) == 3
        assert timer.graph_calls["fgmres.graph"] == dict(captures=0, replays=0, eager=3)
    with fgmres_mod._workspace(b, 5, rdt, group=object()) as ws:
        assert ws not in fgmres_mod._workspaces.values() and not ws.graphable
    for n in range(9, 8 + fgmres_mod.MAX_WORKSPACES):
        with fgmres_mod._workspace(torch.zeros((4, n), dtype=cdt), 5, rdt, None):
            pass
    assert len(fgmres_mod._workspaces) == fgmres_mod.MAX_WORKSPACES
    with fgmres_mod._workspace(torch.zeros((4, 99), dtype=cdt), 5, rdt, None) as ws:
        assert ws not in fgmres_mod._workspaces.values() and not ws.graphable
    assert len(fgmres_mod._workspaces) == fgmres_mod.MAX_WORKSPACES
    assert KrylovWorkspace(2, 3, 4, cdt, rdt, "cpu", graphable=True).graphs.max_keys is None


# ---- on the card ------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: CUDA graphs are captured and replayed on the card only")
    from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels

    pin_full_precision_matmuls()
    stencil_kernels.load_library()
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def flagship(card):
    """The 128^2 hierarchy of the sampling cells, on the card."""
    return _hierarchy(128, card)


def _solve_equal(got, want) -> bool:
    return (torch.equal(got.x, want.x) and torch.equal(got.iters, want.iters)
            and torch.equal(got.stalled, want.stalled)
            and torch.equal(got.resnorm, want.resnorm))


@pytest.mark.card
def test_graphed_solve_equals_eager_solve_on_the_card(flagship, monkeypatch):
    """A batch of 128 probes on one solver whose V-cycle graph is already
    captured: the solve with FGMRES's graphs captured, and then replayed,
    equals the eager solve bit for bit."""
    cfg, op, hier = flagship
    b = _randc((B_CARD, op.n), 6, cfg.dtype, hier.coarsest_inv.device)
    solver = MGSolver(hier, cfg.solver)
    first = solver.solve(b, cfg.function_tol)            # every key's first call
    ws = fgmres_mod._workspaces[(b.device, b.dtype, B_CARD, op.n, cfg.solver.restart)]
    with monkeypatch.context() as m:
        m.setattr(ws, "graphable", False)
        ref = solver.solve(b, cfg.function_tol)
    captured = solver.solve(b, cfg.function_tol)
    replayed = solver.solve(b, cfg.function_tol)
    print(f"solve of {B_CARD} probes: iterations {int(ref.iters.max())} (max); bit-identical "
          f"to the eager solve: captured {_solve_equal(captured, ref)}, replayed "
          f"{_solve_equal(replayed, ref)}, first solve {_solve_equal(first, ref)}; "
          f"FGMRES graph calls {timer.graph_calls['fgmres.graph']}")
    for got in (captured, replayed):
        assert torch.equal(got.x, ref.x)
        assert torch.equal(got.iters, ref.iters)
        assert torch.equal(got.stalled, ref.stalled)
        assert torch.equal(got.resnorm, ref.resnorm)
        assert got.cycles == ref.cycles


@pytest.mark.card
def test_replays_on_new_probes_leave_earlier_results_alone(flagship):
    cfg, op, hier = flagship
    dev = hier.coarsest_inv.device
    b1, b2 = (_randc((B_CARD, op.n), s, cfg.dtype, dev) for s in (7, 8))
    solver = MGSolver(hier, cfg.solver)
    solver.solve(b1, cfg.function_tol), solver.solve(b1, cfg.function_tol)
    r1 = solver.solve(b1, cfg.function_tol)
    held = [t.clone() for t in (r1.x, r1.resnorm, r1.iters, r1.stalled)]
    timer.reset_graph_calls()
    r2 = solver.solve(b2, cfg.function_tol)
    for t, h in zip((r1.x, r1.resnorm, r1.iters, r1.stalled), held):
        assert torch.equal(t, h)
    assert float((r1.x - r2.x).abs().max()) > 0.1 * float(r1.x.abs().max())
    relres = _norm(b2 - op.matvec(r2.x)) / _norm(b2)
    assert float(relres.max()) <= 1.01 * cfg.function_tol
    assert timer.graph_calls["fgmres.graph"]["replays"] > 0


@pytest.mark.card
def test_counter_over_a_shapes_first_three_solves_on_the_card(flagship):
    """First solve: every call eager; second: every call captures; third:
    every call replays (same probes, so the same keys)."""
    cfg, op, hier = flagship
    b = _randc((B_CARD, op.n), 9, cfg.dtype, hier.coarsest_inv.device)
    solver = MGSolver(hier, cfg.solver)
    seen = []
    for _ in range(3):
        timer.reset_graph_calls()
        res = solver.solve(b, cfg.function_tol)
        seen.append(dict(timer.graph_calls["fgmres.graph"]))
    calls = int(res.iters.max()) + res.cycles        # steps and cycle ends
    print(f"FGMRES graph calls over three solves: {seen} ({calls} calls a solve)")
    assert seen[0] == dict(captures=0, replays=0, eager=calls)
    assert seen[1] == dict(captures=calls, replays=0, eager=0)
    assert seen[2] == dict(captures=0, replays=calls, eager=0)
