"""The port's one CUDA-graph cache (utils/graphs.py ``GraphCache``) and its
counters (utils/timer.py ``graph_calls``, ``PhaseTimer.graphs``), over the
keys of both owners: the V-cycle's input shapes (mg/cycle.py
``CycleGraphs``, at most ``MAX_SHAPES`` graphs) and FGMRES's ("step", j) /
("end", j) (solvers/fgmres.py ``KrylovWorkspace``, no bound).

On the CPU, port only (no JAX): the policy (a key's first call eager, its
second captured, later ones replayed, eager past ``max_keys``, eager
without a key); each call counted once, under its owner's counter, with a
stand-in for ``torch.cuda.CUDAGraph`` that replays by running the captured
function again; the counters reset and ``PhaseTimer`` keeps them per phase.
Captures on a card are held by the ``card`` tests of
tests/test_torch_cycle_graph.py and tests/test_torch_fgmres_graph.py.
"""

import pytest

torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu_torch.mg import cycle  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.solvers import fgmres  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils import timer  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.graphs import GraphCache, GraphPool  # noqa: E402

COUNTERS = ("vcycle.graph", "fgmres.graph")


@pytest.fixture(autouse=True)
def _fresh_counter():
    timer.reset_graph_calls()
    yield
    timer.reset_graph_calls()


def _other(counter: str) -> str:
    return next(c for c in COUNTERS if c != counter)


def _keys(owner):
    """(counter, max_keys, keys) of an owner's cache."""
    if owner == "vcycle shapes":
        n = cycle.CycleGraphs.MAX_SHAPES
        return "vcycle.graph", n, [("cuda:0", torch.complex64, (128, k)) for k in range(n + 2)]
    return "fgmres.graph", None, [(kind, j) for j in range(41) for kind in ("step", "end")]


@pytest.mark.parametrize("owner", ["vcycle shapes", "fgmres steps", "no key"])
def test_graph_cache_routes(owner):
    """The first call of a key is eager, the second captures, later ones
    replay; past max_keys graphs every new key stays eager; a call without
    a key is eager and marks nothing seen."""
    if owner == "no key":
        g = GraphCache("vcycle.graph", GraphPool("cpu"), 4)
        assert [g._route(None) for _ in range(3)] == ["eager"] * 3
        assert not g._seen and not g._graphs
        return
    counter, max_keys, keys = _keys(owner)
    g = GraphCache(counter, GraphPool("cpu"), max_keys)
    assert g.calls is timer.graph_calls[counter]
    graphed = keys if max_keys is None else keys[:max_keys]
    for k in graphed:
        assert g._route(k) == "eager"
        assert g._route(k) == "capture"
        g._graphs[k] = object()                 # what run() stores after a capture
        assert [g._route(k) for _ in range(2)] == ["replay"] * 2
    for k in keys[len(graphed):]:
        assert [g._route(k) for _ in range(3)] == ["eager"] * 3
    assert g._route(keys[0]) == "replay"
    assert len(g._graphs) == len(graphed)


class _StandInGraph:
    """Replays by running the captured function on the static inputs again
    and writing its output into the recorded one, as a graph would."""

    def __init__(self, fn, static, recorded):
        self.fn, self.static, self.recorded = fn, static, recorded

    def replay(self):
        out = self.fn(*self.static)
        if self.recorded is not None:
            self.recorded.copy_(out)


def _stand_in_capture(self, fn, inputs):
    static = tuple(t.clone() for t in inputs)
    out = fn(*static)                           # the call's one application
    recorded = None if out is None else torch.empty_like(out)
    return out, (_StandInGraph(fn, static, recorded), static, recorded)


@pytest.mark.parametrize("counter", COUNTERS)
def test_each_call_counts_once(counter, monkeypatch):
    """The V-cycle's form (a tensor in, a fresh tensor out) and FGMRES's (no
    input, work in place over held buffers): every call applies ``fn``
    once and adds 1 to one field of its own counter; a replay copies the
    new input in and returns a clone, which the next replay leaves alone."""
    monkeypatch.setattr(GraphCache, "_capture", _stand_in_capture)
    g = GraphCache(counter, GraphPool("cpu"), 4)
    other = timer.graph_calls[_other(counter)]
    held = torch.zeros(3)
    if counter == "vcycle.graph":
        def fn(b):
            return 2 * b
    else:
        def fn():
            held.add_(1)

    outs, routes = [], []
    for i in range(5):
        before = dict(g.calls)
        b = torch.full((3,), float(i))
        outs.append(g.run(("k",), fn, "name", b) if counter == "vcycle.graph"
                    else g.run(("k",), fn, "name"))
        routes.append(next(k for k in g.calls if g.calls[k] != before[k]))
        assert sum(g.calls.values()) == sum(before.values()) + 1
    assert routes == ["eager", "captures", "replays", "replays", "replays"]
    assert g.calls == dict(captures=1, replays=3, eager=1)
    assert other == dict(captures=0, replays=0, eager=0)
    if counter == "vcycle.graph":
        for i, out in enumerate(outs):              # clones, none overwritten
            assert torch.equal(out, torch.full((3,), 2.0 * i))
    else:
        assert outs == [None] * 5 and torch.equal(held, torch.full((3,), 5.0))


def _owner_eager_calls(counter) -> int:
    """CPU calls of the counter's owner, all eager; returns their number."""
    if counter == "vcycle.graph":
        g = cycle.CycleGraphs(lambda b: b, 1, GraphPool("cpu"))
        for _ in range(3):
            g(torch.zeros((2, 4), dtype=torch.complex64))
        return 3
    gen = torch.Generator().manual_seed(41)
    A = torch.eye(16, dtype=torch.complex128) \
        + 0.1 * torch.randn((16, 16), generator=gen, dtype=torch.complex128)
    b = torch.randn((3, 16), generator=gen, dtype=torch.complex128)
    res = fgmres(lambda v: v @ A.T, b, tol=1e-10, restart=40)
    return int(res.iters.max()) + 1             # one cycle: its steps and its end


@pytest.mark.parametrize("counter", COUNTERS)
def test_graph_counter_resets_and_phase_timer_keeps_it_per_phase(counter):
    label = {"vcycle.graph": "V-cycle", "fgmres.graph": "FGMRES"}[counter]
    other = _other(counter)
    zero = dict(captures=0, replays=0, eager=0)
    t = timer.PhaseTimer()
    with t.phase("sampling"):
        for kind, n in (("captures", 12), ("replays", 120), ("eager", 1)):
            timer.graph_calls[counter][kind] += n
    with t.phase("rough_trace"):
        eager = _owner_eager_calls(counter)
    assert timer.graph_calls[counter] == dict(captures=12, replays=120, eager=1 + eager)
    assert timer.graph_calls[other] == zero
    assert t.graphs["sampling"] == {counter: dict(captures=12, replays=120, eager=1),
                                    other: zero}
    assert t.graphs["rough_trace"] == {counter: dict(zero, eager=eager), other: zero}
    lines = str(t).splitlines()
    assert any(ln.startswith(" -- sampling : ")
               and ln.endswith(f"(1 calls), {label} graphs 12 captured, 120 replayed, 1 eager")
               for ln in lines)
    # an eager-only phase prints no graph counts
    assert any(ln.startswith(" -- rough_trace : ") and "graphs" not in ln for ln in lines)
    timer.reset_graph_calls()
    assert timer.graph_calls == {name: zero for name in COUNTERS}
    t.reset()
    assert dict(t.graphs) == {}
