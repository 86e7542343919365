"""The port's spans and host-read counters (utils/timer.py) on a G102-shaped
problem: the schwinger128 profile (4 levels, polynomial smoother, k > 0
gamma3 deflation, displaced trace, complex64) on a generated 32^2 lattice.

Spans are off by default and then cost one shared nullcontext; under
torch.profiler with spans on, the documented names nest as PERF.md's layer
table says, an Arnoldi step is one ``fgmres.step`` span, every host read
is counted at its site, and nothing the program computes changes."""

import dataclasses
import re
from collections import Counter
from contextlib import nullcontext

import pytest

torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg.cycle import MGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.deflation import hutchinson_deflation  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.hutchinson import hutchinson_step_batch  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.mlmc import (  # noqa: E402
    dense_level_inverse,
    mlmc_step_batch,
)
from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.stats import sample_to_stop  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils import timer  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import setup_or_load_hierarchy  # noqa: E402

L, B = 32, 8
PROGRAM = ("est.", "fgmres.", "vcycle", "host.read.", "transport.", "phase.")

# (span name, the program spans it may sit directly inside)
NESTING = [
    (r"est\.batch", {None, "phase.sampling"}),
    (r"est\.(deflate|coarse)", {"est.batch"}),
    (r"fgmres\.solve", {"est.batch", "est.coarse"}),
    (r"fgmres\.cycle", {"fgmres.solve"}),
    (r"fgmres\.step", {"fgmres.cycle"}),
    (r"fgmres\.(mgs|givens)", {"fgmres.step"}),
    (r"vcycle", {"fgmres.step"}),
    (r"vcycle\.(l\d\.(down|up)|coarsest)", {"vcycle"}),
    (r"host\.read\.fgmres\.cycle", {"fgmres.solve"}),
    (r"host\.read\.fgmres\.(step|stall)", {"fgmres.cycle"}),
    (r"host\.read\.sample\.(flags|end)", {None, "phase.sampling"}),
    (r"phase\.\w+", {None}),
]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _spans_off():
    yield
    timer.set_spans(False)


@pytest.fixture(scope="module")
def g102():
    cfg = set_params("schwinger128").replace(
        matrix=f"generated:{L}x{L}:beta=5.0:seed=11", mass=-0.17, latt_dims=(L, L),
        nr_deflat_vctrs=16, defl_buffer=16, probe_batch=B)
    op = generate_operator(L, L, cfg.mass, beta=5.0, seed=11, dtype=cfg.dtype, device="cpu")
    solver = MGSolver(setup_or_load_hierarchy(op, cfg, None, lambda *a, **k: None),
                      cfg.solver)
    defl = hutchinson_deflation(op, solver, cfg)
    assert solver.hier.nr_levels == 4 and defl.U is not None and defl.U.shape[1] == 16
    # level 0's coarse level is 2 (level 1 skipped); its dense inverse as the cells use it
    dinv = torch.from_numpy(dense_level_inverse(solver.hier, 2)).to(cfg.dtype)
    return op, cfg, solver, defl, dinv


def _probes(op, start=0, b=B):
    return make_probe_source("torch", 7, "cpu")(start, b, op.n, op.dtype)


def _hutch(g, start=0):
    op, cfg, solver, defl, _ = g
    return hutchinson_step_batch(op, solver, cfg, defl, _probes(op, start), gather=False)


def _mlmc(g, dense: bool, start=0):
    op, cfg, solver, defl, dinv = g
    e, it1, it2, _, stall = mlmc_step_batch(solver, cfg, 0, defl, _probes(op, start), True,
                                            gather=False,
                                            coarse_dense_inv=dinv if dense else None)
    return e, it1, it2, stall


def _profiled(fn):
    """fn() with spans on under the CPU profiler: (its result, the program
    spans as (event, its innermost enclosing program span or None))."""
    with timer.spans_on():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = fn()
    spans = []
    for e in prof.events():
        if e.name.startswith(PROGRAM):
            p = e.cpu_parent
            while p is not None and not p.name.startswith(PROGRAM):
                p = p.cpu_parent
            spans.append((e, p))
    return out, spans


def _under(e, parents, name):
    """Whether span ``e`` lies inside a span called ``name``."""
    p = parents.get(e.id)
    while p is not None:
        if p.name == name:
            return p
        p = parents.get(p.id)
    return None


def test_spans_off_by_default_are_one_shared_nullcontext():
    a, b = timer.span("est.batch"), timer.span("vcycle")
    assert a is b and isinstance(a, nullcontext)
    with timer.spans_on():
        assert isinstance(timer.span("vcycle"), torch.profiler.record_function)
        with timer.spans_on():
            pass
        assert isinstance(timer.span("vcycle"), torch.profiler.record_function)
    assert timer.span("vcycle") is a
    timer.set_spans(True)
    assert timer.span("vcycle") is not a
    timer.set_spans(False)
    assert timer.span("vcycle") is a


@pytest.mark.parametrize("estimator", ["hutchinson", "mlmc_dense", "mlmc_iterative"])
def test_span_names_nest_as_documented(g102, estimator):
    if estimator == "hutchinson":
        _, spans = _profiled(lambda: _hutch(g102))
    else:
        _, spans = _profiled(lambda: _mlmc(g102, estimator == "mlmc_dense"))
    names = Counter(e.name for e, _ in spans)
    for e, p in spans:
        allowed = next((ps for pat, ps in NESTING if re.fullmatch(pat, e.name)), None)
        assert allowed is not None, f"undocumented span {e.name}"
        assert (None if p is None else p.name) in allowed, (e.name, p and p.name)
    for lev in (0, 1, 2):
        assert names[f"vcycle.l{lev}.down"] == names[f"vcycle.l{lev}.up"] > 0
    assert names["vcycle.coarsest"] == names["vcycle"] == names["fgmres.step"]
    assert names["est.batch"] == names["est.deflate"] == 1
    assert names["est.coarse"] == (0 if estimator == "hutchinson" else 1)
    assert names["fgmres.solve"] == (2 if estimator == "mlmc_iterative" else 1)
    # a V-cycle's levels in order: down the hierarchy, the coarsest, up again
    kids = {}
    for e, p in spans:
        if p is not None and p.name == "vcycle":
            kids.setdefault(p.id, []).append(e)
    for group in kids.values():
        order = [k.name for k in sorted(group, key=lambda k: k.time_range.start)]
        lv = sorted({int(n[8]) for n in order if n.startswith("vcycle.l")})
        assert order == ([f"vcycle.l{i}.down" for i in lv] + ["vcycle.coarsest"]
                         + [f"vcycle.l{i}.up" for i in reversed(lv)])


@pytest.mark.parametrize("estimator", ["hutchinson", "mlmc_iterative"])
def test_step_spans_per_solve_equal_iters_max(g102, estimator):
    if estimator == "hutchinson":
        (e, iters, stall), spans = _profiled(lambda: _hutch(g102))
        want = [int(iters.max())]
    else:
        (e, it1, it2, stall), spans = _profiled(lambda: _mlmc(g102, False))
        want = [int(it1.max()), int(it2.max())]
    parents = {ev.id: p for ev, p in spans}
    solves = sorted((ev for ev, _ in spans if ev.name == "fgmres.solve"),
                    key=lambda ev: ev.time_range.start)
    steps = Counter(_under(ev, parents, "fgmres.solve").id
                    for ev, _ in spans if ev.name == "fgmres.step")
    assert [steps[s.id] for s in solves] == want
    assert not bool(stall.any()) and min(want) > 0


@pytest.mark.parametrize("restart", [40, 3])
def test_host_reads_per_site_follow_the_loops(g102, restart):
    """One read per loop predicate: a cycle's steps plus the false read
    that ends a cycle short of the restart length, one stall read per
    cycle, the cycles plus the read that ends a converged solve; and in
    the sampling loop the lagged flags of all but the last two batches and
    one read at the end. Each read is one ``host.read.<site>`` span."""
    op, cfg, solver, defl, _ = g102
    batches = 4
    scfg = cfg.replace(solver=dataclasses.replace(cfg.solver, restart=restart, max_restarts=20),
                       max_nr_ests=batches * B)
    ssolver = solver.derived(scfg.solver)

    def run():
        timer.reset_host_reads()
        return sample_to_stop(
            lambda s: hutchinson_step_batch(op, ssolver, scfg, defl, _probes(op, s),
                                            gather=False),
            scfg, 0.0, "spans test", torch.float32, "cpu")

    (_, _, nstall), spans = _profiled(run)
    got = {site: c[0] for site, c in timer.host_reads.items()}
    parents = {ev.id: p for ev, p in spans}
    cycles = Counter(_under(ev, parents, "fgmres.solve").id
                     for ev, _ in spans if ev.name == "fgmres.cycle")
    steps = Counter(_under(ev, parents, "fgmres.cycle").id
                    for ev, _ in spans if ev.name == "fgmres.step")
    n_cycles = sum(cycles.values())
    assert nstall == 0 and len(cycles) == batches
    assert all(c < 20 for c in cycles.values())
    assert (n_cycles > batches) == (restart == 3)
    assert got == {
        "fgmres.cycle": n_cycles + batches,
        "fgmres.step": sum(s + (s < restart) for s in steps.values()),
        "fgmres.stall": n_cycles,
        "sample.flags": batches - 2,
        "sample.end": 1,
    }
    assert Counter(ev.name[len("host.read."):] for ev, _ in spans
                   if ev.name.startswith("host.read.")) == got
    assert timer.host_read_totals()["reads"] == sum(got.values())
    assert all(c[1] > 0 for c in timer.host_reads.values())


def test_spans_change_no_number(g102):
    """Solutions, estimates and per-row iterations bit for bit with spans
    off and on, for both estimators' steps and the sampling loop."""
    op, cfg, solver, defl, _ = g102
    x_def = _probes(op, 16)

    def everything():
        res = solver.solve(x_def, cfg.function_tol)
        h = _hutch(g102, 8)
        m = _mlmc(g102, True, 8) + _mlmc(g102, False, 8)
        mom, its, nst = sample_to_stop(
            lambda s: _hutch(g102, s), cfg.replace(max_nr_ests=3 * B), 0.0, "spans test",
            torch.float32, "cpu")
        return [res.x, res.iters, res.resnorm, *h, *m, torch.tensor([mom.count, its, nst]),
                torch.tensor([mom.mean.real, mom.mean.imag, mom.m2], dtype=torch.float64)]

    off = everything()
    on, spans = _profiled(everything)
    assert len(spans) > 100
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_phases_are_spans_with_their_host_read_seconds(g102):
    t = timer.PhaseTimer()

    def run():
        with t.phase("sampling"):
            _hutch(g102)
        with t.phase("mg_setup"):
            pass

    _, spans = _profiled(run)
    names = Counter(e.name for e, _ in spans)
    assert names["phase.sampling"] == names["phase.mg_setup"] == 1
    assert [p.name for e, p in spans if e.name == "est.batch"] == ["phase.sampling"]
    assert 0 < t.host_read["sampling"] < t.totals["sampling"]
    assert t.host_read["mg_setup"] == 0
    lines = str(t).splitlines()
    assert any(ln.startswith(" -- sampling : ") and ln.endswith(" s in host reads")
               for ln in lines)
    assert any(ln.startswith(" -- mg_setup : ") and ln.endswith("(1 calls)") for ln in lines)
