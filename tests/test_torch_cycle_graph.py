"""The V-cycle as an eager fine-level step around a coarse sub-cycle, and the
sub-cycle's CUDA graphs (mg/cycle.py ``build_v_cycle``, ``coarse_cycle``,
``CycleGraphs``; the ``vcycle.graph`` counter of ``graph_calls`` in
utils/timer.py). The graph cache itself and the counters are held in
tests/test_torch_graphs.py.

On the CPU, port only (no JAX): the split cycle gives the bits of the one
loop it replaced, for both smoothers, starting on levels 0 and 1, in
complex128 and complex64; CPU calls run eagerly and count as eager; which
cycles are graphed at all.

On the card (marked ``card``, skipped without one; this file imports no JAX,
so run it without the JAX package's conftest:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cycle_graph.py``),
at the shapes of the 128^2 sampling cells (schwinger128 profile, batches of
128, complex64): the capturing call's output (the side stream's warm-up)
and the replayed sub-cycle against the eager one, replays on different
inputs with an output held across the next replay, and a whole
``MGSolver.solve`` with graphs against one without.
"""

import pytest

torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, cycle  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils import timer  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.graphs import GraphCache  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import setup_or_load_hierarchy  # noqa: E402

L = 32          # CPU lattice: levels of 2048, 512, 128 and 32 unknowns
B_CARD = 128    # the cells' probe batch


def _quiet(*args, **kwargs):
    pass


def _hierarchy(n: int, device, dtype=torch.complex64):
    cfg = set_params("schwinger128").replace(
        matrix=f"generated:{n}x{n}:beta=5.0:seed=11", mass=-0.17, latt_dims=(n, n),
        dtype=dtype)
    op = generate_operator(n, n, cfg.mass, beta=5.0, seed=11, dtype=cfg.dtype, device=device)
    return cfg, op, setup_or_load_hierarchy(op, cfg, None, _quiet)


def _randc(shape, seed, dtype, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(shape, generator=g, dtype=torch.float64) \
        + 1j * torch.randn(shape, generator=g, dtype=torch.float64)
    return v.to(dtype=dtype, device=device)


def _monolithic(levels, coarsest_inv, smoothers):
    """The V-cycle as one loop over every level, as it was before the split."""

    def v_cycle(b):
        bs, xs = [b], []
        for lev, sm in zip(levels[:-1], smoothers):
            x, r = sm.smooth_residual(lev.op, bs[-1])
            xs.append(x)
            bs.append(lev.P.apply_adjoint(r))
        xc = bs[-1] @ coarsest_inv.T
        for lev, sm, x, bf in zip(levels[-2::-1], smoothers[::-1], xs[::-1], bs[-2::-1]):
            x = x + lev.P.apply(xc)
            r = cycle.residual(lev.op, bf, x)
            xc = x + sm.smooth(lev.op, r)
        return xc

    return v_cycle


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_counter():
    timer.reset_graph_calls()
    yield
    timer.reset_graph_calls()


@pytest.fixture(scope="module")
def small():
    return _hierarchy(L, "cpu")


@pytest.fixture(scope="module")
def small_c128():
    return _hierarchy(L, "cpu", torch.complex128)


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("smoother", ["poly", "gmres"])
def test_split_cycle_equals_the_monolithic_one(request, smoother, level, dtype):
    """Bit for bit on the CPU: the fine-level step around the sub-cycle (level
    0), or the sub-cycle whole (level 1), against the one loop."""
    cfg, _, hier = request.getfixturevalue("small_c128" if dtype == "complex128" else "small")
    assert hier.coarsest_inv.dtype == getattr(torch, dtype)
    solver = MGSolver(hier, SolverConfig(restart=40, smoother=smoother, smooth_iters=4
                                         if smoother == "gmres" else 16))
    levels, sms = list(hier.levels)[level:], solver._smoothers(level)
    b = _randc((3, hier.sizes()[level]), 5 + level, cfg.dtype)
    got = cycle.build_v_cycle(levels, hier.coarsest_inv, sms, first_level=level)(b)
    want = _monolithic(levels, hier.coarsest_inv, sms)(b)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(solver.precond(level)(b), want)


@pytest.mark.parametrize("level", [0, 1])
def test_cpu_calls_run_eagerly_and_count_as_eager(small, level):
    _, _, hier = small
    solver = MGSolver(hier, SolverConfig(restart=40))
    b = _randc((2, hier.sizes()[level]), 9, hier.coarsest_inv.dtype)
    outs = [solver.precond(level)(b) for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert timer.graph_calls["vcycle.graph"] == dict(captures=0, replays=0, eager=3)


@pytest.mark.parametrize("case", ["coarse", "with_fine", "coarsest_only", "group"])
def test_which_cycles_are_graphed(small, case):
    """A sub-cycle is graphed only where no level is the fine stencil (its
    K1-K3 calls stay eager and seen by their wrappers), it has more than the
    coarsest level, and no smoother sums over a group of ranks."""
    _, _, hier = small
    levels = list(hier.levels)
    sms = [cycle.GmresSmoother(4)] * (len(levels) - 1)
    if case == "coarse":
        levels, sms = levels[1:], sms[1:]
    elif case == "coarsest_only":
        levels, sms = levels[-1:], []
    elif case == "group":
        levels, sms = levels[1:], [cycle.GmresSmoother(4, group=object())] * (len(levels) - 2)
    got = cycle.coarse_cycle(levels, hier.coarsest_inv, sms, first_level=1)
    assert isinstance(got, cycle.CycleGraphs) == (case == "coarse")


# ---- on the card ------------------------------------------------------------

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


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _sub_cycle(hier):
    solver = MGSolver(hier, set_params("schwinger128").solver)
    levels, sms = list(hier.levels)[1:], solver._smoothers(1)
    return cycle.coarse_cycle(levels, hier.coarsest_inv, sms, first_level=1)


@pytest.mark.card
def test_replayed_sub_cycle_matches_eager_on_the_card(flagship):
    cfg, _, hier = flagship
    g = _sub_cycle(hier)
    assert isinstance(g, cycle.CycleGraphs)
    b = _randc((B_CARD, hier.sizes()[1]), 1, cfg.dtype, hier.coarsest_inv.device)
    eager = g.fn(b)
    outs = [g(b) for _ in range(4)]             # eager, capture, replay, replay
    assert timer.graph_calls["vcycle.graph"] == dict(captures=1, replays=2, eager=1)
    errs = [_rel(o, eager) for o in outs]
    print(f"eager, capturing and replayed calls vs the eager sub-cycle at ({B_CARD}, "
          f"{hier.sizes()[1]}) complex64: bit-identical {[torch.equal(o, eager) for o in outs]}, "
          f"max relative difference {errs}")
    # the capturing call returns its warm-up's output: the eager cycle's
    assert torch.equal(outs[0], eager) and torch.equal(outs[1], eager)
    assert max(errs) <= 1e-5


@pytest.mark.card
def test_replays_on_new_inputs_leave_held_outputs_alone(flagship):
    cfg, _, hier = flagship
    g = _sub_cycle(hier)
    dev = hier.coarsest_inv.device
    b1, b2, b3 = (_randc((B_CARD, hier.sizes()[1]), s, cfg.dtype, dev) for s in (2, 3, 4))
    g(b3), g(b3)                                 # eager, then captured
    y1 = g(b1)
    held = y1.clone()
    y2 = g(b2)                                   # the next replay
    assert torch.equal(y1, held)
    assert _rel(y1, g.fn(b1)) <= 1e-5 and _rel(y2, g.fn(b2)) <= 1e-5
    assert _rel(y1, y2) > 0.1
    assert timer.graph_calls["vcycle.graph"] == dict(captures=1, replays=2, eager=1)


@pytest.mark.card
def test_solve_with_graphs_equals_eager_solve_on_the_card(flagship, monkeypatch):
    """A batch of 128 probes: equal per-row iteration counts, x within 1e-6
    relative, and every V-cycle after the first two a replay."""
    cfg, op, hier = flagship
    b = _randc((B_CARD, op.n), 6, cfg.dtype, hier.coarsest_inv.device)
    tol = cfg.function_tol
    with monkeypatch.context() as m:
        m.setattr(GraphCache, "_route", lambda self, key: "eager")
        ref = MGSolver(hier, cfg.solver).solve(b, tol)
    assert timer.graph_calls["vcycle.graph"]["replays"] == 0
    timer.reset_graph_calls()
    solver = MGSolver(hier, cfg.solver)
    solver.solve(b, tol)
    got = solver.solve(b, tol)
    calls = timer.graph_calls["vcycle.graph"]
    print(f"solve of {B_CARD} probes: iterations {int(got.iters.max())} (max), x differs "
          f"by {_rel(got.x, ref.x):.3e} relative, bit-identical {torch.equal(got.x, ref.x)}; "
          f"graph calls over two solves {calls}")
    assert torch.equal(got.iters, ref.iters)
    assert _rel(got.x, ref.x) <= 1e-6
    # one V-cycle an Arnoldi step; a solve takes at least iters.max() steps,
    # and each call counts once: 1 eager, 1 capture, the rest replays
    assert calls["captures"] == 1 and calls["eager"] == 1
    assert calls["replays"] >= 2 * int(got.iters.max()) - 2
