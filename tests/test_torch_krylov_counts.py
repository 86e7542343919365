"""FGMRES's work counters (utils/timer.py ``krylov_counts``) and the two
benchmark readers built on them (benchmark/krylov_roofline.py,
``krylov_tail_roofline`` and ``fgmres.cycles_per_solve``).

A CPU solve whose step count is fixed by its preconditioner gives exact
solves, cycles, step tails and the sum of the step indices; the readers'
arithmetic is checked on hand-made contexts against the byte counts of the
tail and PERF.md's 11-step complex64 bound of 0.8814 ms."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from deflatedmlmc_schwinger_tpu_torch.solvers.fgmres import fgmres
from deflatedmlmc_schwinger_tpu_torch.utils import timer

BENCH = Path(__file__).resolve().parents[1] / "benchmark"


def _bench(name: str):
    """A module of benchmark/ (its modules import each other by bare name)."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    if name in sys.modules:
        return sys.modules[name]
    return __import__(name)


def _reader(metric: str):
    _bench("krylov_roofline")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), BENCH / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _system(B: int, n: int, dtype):
    g = torch.Generator().manual_seed(5)
    A = (torch.randn(n, n, generator=g, dtype=dtype) / n ** 0.5
         + 1.5 * torch.eye(n, dtype=dtype))
    b = torch.randn(B, n, generator=g, dtype=dtype)
    return A, b


def _solve_in(steps_to_exact: int, restart: int, B=3, n=64, dtype=torch.complex128):
    """An FGMRES solve that converges at its ``steps_to_exact``-th step: the
    preconditioner is the identity, except that the step ending the solve
    returns A^{-1} of its cycle's first basis vector, so that the residual
    lies in A's image of the search space."""
    A, b = _system(B, n, dtype)
    calls = {"n": 0, "v0": None}

    def precond(v):
        calls["n"] += 1
        if (calls["n"] - 1) % restart == 0:
            calls["v0"] = v.clone()             # V[0] of a cycle
        if calls["n"] == steps_to_exact:
            return torch.linalg.solve(A, calls["v0"].T).T
        return v

    tol = 1e-10 if dtype == torch.complex128 else 1e-5
    res = fgmres(lambda x: x @ A.T, b, tol=tol, restart=restart, max_restarts=10,
                 precond=precond, stall_ratio=None)
    return res, (B, n, b.element_size())


@pytest.mark.parametrize("steps, restart, cycles, j_sum", [
    (10, 4, 3, 6 + 6 + 1),       # 4 + 4 + 2 steps
    (4, 4, 1, 6),                # one full cycle
    (5, 4, 2, 6 + 0),            # one step into the second cycle
    (3, 40, 1, 3),               # the cells' restart length, first cycle
])
def test_counts_of_a_solve_with_known_steps(steps, restart, cycles, j_sum):
    timer.reset_krylov_counts()
    res, key = _solve_in(steps, restart)
    assert int(res.iters.max()) == steps and res.cycles == cycles
    assert not bool(res.stalled.any())
    assert dict(timer.krylov_counts) == {
        key: dict(solves=1, cycles=cycles, tails=steps, j_sum=j_sum)}


def test_counts_add_up_per_solve_shape():
    timer.reset_krylov_counts()
    _solve_in(10, 4)
    _, key = _solve_in(10, 4)
    _, key64 = _solve_in(5, 4, dtype=torch.complex64)
    assert key64 != key and key64[2] == 8
    assert timer.krylov_counts[key] == dict(solves=2, cycles=6, tails=20, j_sum=26)
    assert timer.krylov_counts[key64] == dict(solves=1, cycles=2, tails=5, j_sum=6)
    timer.reset_krylov_counts()
    assert not timer.krylov_counts


@pytest.mark.parametrize("itemsize", [8, 16])
def test_tail_bytes_by_hand(itemsize):
    kr = _bench("krylov_roofline")
    B, n = 128, 32768
    block = B * n * itemsize                    # 33554432 B in complex64
    assert block == {8: 33554432, 16: 67108864}[itemsize]
    assert kr.tail_bytes(0, B, n, itemsize) == 3 * block
    assert kr.tail_bytes(39, B, n, itemsize) == 42 * block
    # one full 40-step cycle: sum_{j<40} (j + 3) = 900 blocks
    assert sum(kr.tail_bytes(j, B, n, itemsize) for j in range(40)) == 900 * block
    assert kr.tails_bound_s(40, sum(range(40)), B, n, itemsize) == pytest.approx(
        900 * block / 3.35e12, rel=1e-12)


def _ctx(outer_iters, kernel_s, B=128, batches=4):
    return dict(window=dict(samples=B * batches, batch_s=[0.05] * batches),
                trace=dict(outer_iters=outer_iters, batches=2, by_name={
                    "void (anonymous namespace)::krylov_tail_reduce_kernel<float2, true>(...)":
                        kernel_s,
                    "void (anonymous namespace)::poly_tiled_kernel<float2, 32, 32, 2>(...)": 1.0}))


def test_roofline_of_eleven_complex64_steps():
    """PR 18's step-tail row: j = 0..10 at B = 128, n = 32768, complex64 is
    88 blocks, 0.8814 ms at 3.35 TB/s; 1.3692 ms of kernel is 64.4%."""
    kr = _bench("krylov_roofline")
    key = (128, 32768, 8)
    assert kr.tails_bound_s(11, 55, *key) * 1e3 == pytest.approx(0.8814, abs=5e-5)
    counts = {key: dict(solves=1, cycles=1, tails=11, j_sum=55),
              (8, 32768, 8): dict(solves=9, cycles=9, tails=900, j_sum=9000),
              (128, 4096, 8): dict(solves=0, cycles=0, tails=0, j_sum=0)}
    # two batches of 11 steps each, the counters' mean 8 blocks a tail
    share = kr.share_pct(_ctx(22, 2 * 1.3692e-3), counts)
    assert share == pytest.approx(100 * 0.88139 / 1.3692, rel=1e-4)
    assert 64.3 < share < 64.5
    assert kr.sampling_counts(_ctx(22, 1.0)["window"], counts)[0] == key


def test_readers_on_a_context_and_without_counters(monkeypatch):
    key = (128, 32768, 16)
    counts = {key: dict(solves=4, cycles=10, tails=330, j_sum=6340)}
    monkeypatch.setattr(timer, "krylov_counts", counts)
    ctx = _ctx(82, 0.05)
    kr = _bench("krylov_roofline")
    mean_blocks = 3 + counts[key]["j_sum"] / counts[key]["tails"]
    want = 100 * 82 * mean_blocks * 128 * 32768 * 16 / 3.35e12 / 0.05
    assert _reader("krylov_tail_roofline").read(ctx) == pytest.approx(want, rel=1e-12)
    assert kr.share_pct(ctx) == pytest.approx(want, rel=1e-12)
    assert _reader("fgmres.cycles_per_solve").read(ctx) == 2.5
    # a stretch without the tail kernel, or without a trace
    assert _reader("krylov_tail_roofline").read(dict(ctx, trace=dict(
        outer_iters=82, batches=2, by_name={"poly_tiled_kernel": 1.0}))) is None
    assert _reader("krylov_tail_roofline").read(dict(ctx, trace=None)) is None
    # a program without the counters (the parent of this change) reads None
    monkeypatch.delattr(timer, "krylov_counts")
    assert _reader("krylov_tail_roofline").read(ctx) is None
    assert _reader("fgmres.cycles_per_solve").read(ctx) is None
