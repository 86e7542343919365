"""The Arnoldi step tail (ops/krylov_kernels.py ``step_tail``, the kernel
``krylov_tail_reduce_kernel`` in csrc/krylov.cu) and its routes.

On the CPU, port only (no JAX): a CPU workspace takes the plain tail, bit
for bit and without a launch; a solve over a ``group`` of ranks keeps the
plain tail's per-term loop (its inner products are collectives) and never
reaches the kernel's wrapper; a workspace on a device that is neither the
CPU nor CUDA raises; the wrapper's checks of dtype, shape, contiguity,
device and step; the launch plan at the shapes of the port's paths and its
refusals. The frozen-loop tests of tests/test_torch_fgmres_graph.py hold
the CPU solve to the loop before the split.

On the card (marked ``card``, skipped without one; this file imports no JAX,
so run it without the JAX package's conftest:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_krylov_kernel.py``):
the kernel against the plain tail on random workspaces for steps j in {0,
1, 5, 10, 39}, batches of 1, 3 and 128 and probes of 512 (complex128),
32768, 131072 and 524288 elements (complex64): V[j+1], the Hessenberg
column, g, cs, sn and res to 1e-5 relative in complex64 and 1e-12 in
complex128, the step counts equal; two launches bit-identical, in both
forms; the device-memory form against the on-chip one; and
``MGSolver.solve`` on the 128^2 hierarchy with per-row iterations within 1
of the plain tail's and the same stall flags.
"""

import importlib
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops import krylov_kernels as kk  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import setup_or_load_hierarchy  # noqa: E402

# the package's solvers/__init__ exports the function fgmres under the module's name
fgmres_mod = importlib.import_module("deflatedmlmc_schwinger_tpu_torch.solvers.fgmres")

FIELDS = ("V", "H", "g", "cs", "sn", "res", "tol_abs", "iters", "w")
REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}


def _workspace(B: int, n: int, m: int, dtype, device, seed: int) -> SimpleNamespace:
    """A workspace of random contents as a solve leaves it before a step
    tail: basis vectors of unit norm, rotations (cs, sn) on the unit
    circle, residual estimates of which about half lie above tol_abs."""
    rdt = REAL[dtype]
    gen = torch.Generator(device=device).manual_seed(seed)

    def randc(shape, scale=1.0):
        re = torch.randn(shape, generator=gen, dtype=rdt, device=device)
        im = torch.randn(shape, generator=gen, dtype=rdt, device=device)
        return torch.complex(re, im) * scale

    def rand(shape):
        return torch.rand(shape, generator=gen, dtype=rdt, device=device)

    theta, phi = rand((m, B)) * (math.pi / 2), rand((m, B)) * (2 * math.pi)
    V = torch.empty((m + 1, B, n), dtype=dtype, device=device)
    for i in range(m + 1):               # a vector at a time: V may be most of the card
        V[i] = randc((B, n), 1 / math.sqrt(2 * n))
    return SimpleNamespace(
        V=V, H=randc((B, m + 1, m)),
        g=randc((B, m + 1)), cs=torch.cos(theta),
        sn=torch.sin(theta) * torch.exp(1j * phi.to(torch.float64)).to(dtype),
        res=rand((B,)) + 0.5, tol_abs=rand((B,)) * 2,
        iters=torch.randint(0, 9, (B,), generator=gen, dtype=torch.int32, device=device),
        w=randc((B, n)))


def _copy(ws) -> SimpleNamespace:
    return SimpleNamespace(**{f: getattr(ws, f).clone() for f in FIELDS})


def _tiny(dtype) -> float:
    return torch.finfo(REAL[dtype]).tiny


def _bits_equal(a, b, fields=FIELDS) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)


# ---- on the CPU -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cpu_takes_the_plain_tail(dtype):
    ws = _workspace(3, 40, 6, dtype, "cpu", 1)
    ref = _copy(ws)
    before = kk.step_tail.launches
    gen = torch.Generator().manual_seed(4)
    for j in range(4):
        w = torch.randn((3, 40), generator=gen, dtype=dtype)   # a new A z each step
        ws.w.copy_(w)
        ref.w.copy_(w)
        kk.step_tail(ws, j, _tiny(dtype))
        kk.step_tail_plain(ref, j, _tiny(dtype))
    assert _bits_equal(ws, ref)
    assert kk.step_tail.launches == before
    # the tail did its work: V[1..4] orthonormal (V[0] is random, of no unit norm)
    Q = ws.V[:5].permute(1, 0, 2)
    gram = Q.conj() @ Q.transpose(1, 2)
    eye = torch.eye(5, dtype=dtype).expand_as(gram)
    assert float((gram[:, 1:, 1:] - eye[:, 1:, 1:]).abs().max()) < 100 * TOL[dtype]


def test_group_solve_keeps_the_per_term_loop(monkeypatch):
    """A solve over a group of ranks (here one rank whose sum is the
    identity) runs the plain tail with the group and never the wrapper; it
    gives the bits of the solve without a group."""
    from deflatedmlmc_schwinger_tpu_torch.parallel import distributed

    gen = torch.Generator().manual_seed(5)
    N = 32
    A = (torch.eye(N, dtype=torch.complex128)
         + 0.3 * torch.randn((N, N), generator=gen, dtype=torch.complex128) / N ** 0.5)
    b = torch.randn((4, N), generator=gen, dtype=torch.complex128)
    monkeypatch.setattr(fgmres_mod, "_workspaces", {})
    want = fgmres_mod.fgmres(lambda v: v @ A.T, b, tol=1e-10, restart=6)

    group = object()
    summed, tails = [], []
    monkeypatch.setattr(distributed, "all_sum", lambda s, g: summed.append(g) or s)
    plain = kk.step_tail_plain

    def counted(ws, j, tiny, group=None):
        tails.append(group)
        plain(ws, j, tiny, group=group)

    def refuse(*args, **kwargs):
        raise AssertionError("a group solve reached the kernel's wrapper")

    monkeypatch.setattr(fgmres_mod, "step_tail_plain", counted)
    monkeypatch.setattr(fgmres_mod, "step_tail", refuse)
    got = fgmres_mod.fgmres(lambda v: v @ A.T, b, tol=1e-10, restart=6, group=group)
    assert tails and all(g is group for g in tails)
    assert summed and all(g is group for g in summed)
    for name in ("x", "resnorm", "bnorm", "iters", "stalled"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.cycles == want.cycles


def test_other_devices_raise():
    ws = _workspace(2, 16, 4, torch.complex64, "cpu", 2)
    meta = SimpleNamespace(**{f: getattr(ws, f).to("meta") for f in FIELDS})
    with pytest.raises(RuntimeError, match="meta"):
        kk.step_tail(meta, 0, _tiny(torch.complex64))


def test_check_operands_accepts_a_workspace():
    for dtype in (torch.complex64, torch.complex128):
        ws = fgmres_mod.KrylovWorkspace(3, 20, 5, dtype, REAL[dtype], "cpu", graphable=False)
        assert kk.check_operands(ws, 4) == (
            {torch.complex64: "c64", torch.complex128: "c128"}[dtype], 3, 20, 5)


BAD = {
    # name: (field, how it is spoiled, exception, step)
    "complex32 basis": ("V", lambda t: t.to(torch.complex32), TypeError, 0),
    "float64 rotations with complex64": ("cs", lambda t: t.double(), TypeError, 0),
    "int64 counts": ("iters", lambda t: t.long(), TypeError, 0),
    "short column": ("H", lambda t: t[:, :-1].contiguous(), ValueError, 0),
    "w of another n": ("w", lambda t: t[:, :-1].contiguous(), ValueError, 0),
    "strided w": ("w", lambda t: torch.empty((t.shape[1], t.shape[0]),
                                             dtype=t.dtype).T, ValueError, 0),
    "res on meta": ("res", lambda t: t.to("meta"), ValueError, 0),
    "step past the restart": (None, None, ValueError, 5),
    "negative step": (None, None, ValueError, -1),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_check_operands_rejects(case):
    field, spoil, exc, j = BAD[case]
    ws = _workspace(3, 20, 5, torch.complex64, "cpu", 3)
    if field is not None:
        setattr(ws, field, spoil(getattr(ws, field)))
    with pytest.raises(exc):
        kk.check_operands(ws, j)


PLANS = {
    # name: (n, m, itemsize, clusters, stages, plan)
    "128^2 c64 (the cells)": (32768, 40, 8, None, None, (8, 16, 3)),
    "16^2 c128 (G101/G201)": (512, 20, 16, None, None, (1, 2, 3)),
    "64^2 c64": (8192, 40, 8, None, None, (2, 16, 3)),
    "256^2 c64 (G301)": (131072, 40, 8, None, None, (8, 64, 0)),
    "512^2 c64 (G302)": (524288, 40, 8, None, None, (8, 256, 0)),
    "128^2 c128": (32768, 40, 16, None, None, (8, 16, 3)),
    "odd n c64": (1001, 20, 8, None, None, (1, 4, 0)),
    "128^2 c64, 2 CTAs": (32768, 40, 8, 2, None, (2, 64, 0)),
    "128^2 c64, 4 CTAs": (32768, 40, 8, 4, None, (4, 32, 0)),
    "24^2 c64": (1152, 40, 8, None, None, (1, 5, 3)),
    "128^2 c64, 4 stages": (32768, 40, 8, None, 4, (8, 16, 4)),
    "128^2 c64, 4 CTAs, 4 stages": (32768, 40, 8, 4, 4, (4, 32, 0)),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_launch_plan(case):
    n, m, itemsize, clusters, stages, want = PLANS[case]
    plan = kk.launch_plan(n, m, itemsize, clusters=clusters, stages=stages)
    assert tuple(plan) == want
    assert plan.clusters * plan.per_thread * kk.THREADS >= n
    if plan.on_chip:
        assert kk.smem_bytes(plan, m, itemsize) <= 232448
        assert plan.per_thread <= kk.MAX_PER_THREAD


@pytest.mark.parametrize("kwargs", [dict(n=0), dict(clusters=3), dict(clusters=16),
                                    dict(stages=1), dict(stages=9)])
def test_launch_plan_refuses(kwargs):
    args = dict(n=32768, m=40, itemsize=8) | kwargs
    with pytest.raises(ValueError):
        kk.launch_plan(**args)


# ---- on the card ------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the step tail kernel runs on the card only")
    from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels

    pin_full_precision_matmuls()
    stencil_kernels.load_library()
    return torch.device("cuda:0")


def _rel(got, want) -> float:
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale > 0 else 1.0)


def _against_plain(ws, j: int, dtype, plan=None) -> dict:
    """Step j by the plain tail and by the kernel from the same state (V is
    shared: neither reads V[j+1], and V[0..j] are inputs); returns each
    output's relative error and asserts the counts equal."""
    tiny = _tiny(dtype)
    small = [f for f in FIELDS if f != "V"]
    start = {f: getattr(ws, f).clone() for f in small}
    kk.step_tail_plain(ws, j, tiny)
    ref = SimpleNamespace(**{f: getattr(ws, f).clone() for f in small},
                          Vj1=ws.V[j + 1].clone())
    for f in small:
        getattr(ws, f).copy_(start[f])
    kk.step_tail(ws, j, tiny, plan)
    torch.cuda.synchronize()
    assert torch.equal(ws.iters, ref.iters)
    errs = {"V[j+1]": _rel(ws.V[j + 1], ref.Vj1), "H": _rel(ws.H, ref.H),
            "g": _rel(ws.g, ref.g), "cs": _rel(ws.cs, ref.cs), "sn": _rel(ws.sn, ref.sn),
            "res": _rel(ws.res, ref.res)}
    for name, t in (("V[j+1]", ws.V[j + 1]), ("H", ws.H), ("g", ws.g), ("res", ws.res)):
        assert bool(torch.isfinite(t).all()), name
    return errs


SHAPES = {512: torch.complex128, 32768: torch.complex64, 131072: torch.complex64,
          524288: torch.complex64}


@pytest.mark.card
@pytest.mark.parametrize("n", sorted(SHAPES))
@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("j", [0, 1, 5, 10, 39])
def test_kernel_matches_plain_tail_on_the_card(card, j, B, n):
    dtype = SHAPES[n]
    ws = _workspace(B, n, j + 2, dtype, card, 100 * j + B)
    before = kk.step_tail.launches
    errs = _against_plain(ws, j, dtype)
    assert kk.step_tail.launches == before + 1
    print(f"j={j} B={B} n={n} {dtype} plan {kk.launch_plan(n, j + 2, ws.V.element_size())}: "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    for name, e in errs.items():
        assert e <= TOL[dtype], (name, e)
    del ws
    torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("form", ["on-chip", "device-memory"])
def test_two_launches_are_bit_identical_on_the_card(card, form):
    dtype, n, m, j = torch.complex64, 32768, 12, 10
    plan = None if form == "on-chip" else kk.TailPlan(8, 16, 0)
    start = _workspace(128, n, m, dtype, card, 77)
    runs = []
    for _ in range(2):
        ws = _copy(start)
        kk.step_tail(ws, j, _tiny(dtype), plan)
        runs.append(ws)
    torch.cuda.synchronize()
    assert _bits_equal(runs[0], runs[1])


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_device_memory_form_matches_the_on_chip_form_on_the_card(card, dtype):
    n, m, j = 32768, 12, 10
    start = _workspace(3, n, m, dtype, card, 55)
    on_chip, in_memory = _copy(start), _copy(start)
    plan = kk.launch_plan(n, m, start.V.element_size())
    assert plan.on_chip
    kk.step_tail(on_chip, j, _tiny(dtype))
    kk.step_tail(in_memory, j, _tiny(dtype), kk.TailPlan(plan.clusters, plan.per_thread, 0))
    torch.cuda.synchronize()
    for f in ("V", "H", "g", "cs", "sn", "res"):
        assert _rel(getattr(in_memory, f), getattr(on_chip, f)) <= TOL[dtype], f
    assert torch.equal(in_memory.iters, on_chip.iters)


@pytest.mark.card
def test_mg_solve_with_the_kernel_matches_the_plain_tail_on_the_card(card, monkeypatch):
    """128 probes on the 128^2 hierarchy of the sampling cells: the solve
    through the kernel and the solve through the plain tail take per-row
    iterations within 1 of each other and flag the same rows stalled."""
    n = 128
    cfg = set_params("schwinger128").replace(
        matrix=f"generated:{n}x{n}:beta=5.0:seed=11", mass=-0.17, latt_dims=(n, n))
    op = generate_operator(n, n, cfg.mass, beta=5.0, seed=11, dtype=cfg.dtype, device=card)
    hier = setup_or_load_hierarchy(op, cfg, None, lambda *a, **k: None)
    gen = torch.Generator(device=card).manual_seed(6)
    b = torch.complex(torch.randn((128, op.n), generator=gen, device=card),
                      torch.randn((128, op.n), generator=gen, device=card))
    monkeypatch.setattr(fgmres_mod, "_workspaces", {})
    before = kk.step_tail.launches
    got = MGSolver(hier, cfg.solver).solve(b, cfg.function_tol)
    assert kk.step_tail.launches > before
    with monkeypatch.context() as mp:
        mp.setattr(fgmres_mod, "_workspaces", {})
        mp.setattr(fgmres_mod, "step_tail",
                   lambda ws, j, tiny: kk.step_tail_plain(ws, j, tiny))
        want = MGSolver(hier, cfg.solver).solve(b, cfg.function_tol)
    diff = (got.iters - want.iters).abs()
    print(f"iterations kernel {got.iters.float().mean():.4f} (max {int(got.iters.max())}), "
          f"plain {want.iters.float().mean():.4f} (max {int(want.iters.max())}); rows that "
          f"differ {int((diff > 0).sum())}, stalled {int(got.stalled.sum())} / "
          f"{int(want.stalled.sum())}")
    assert int(diff.max()) <= 1
    assert torch.equal(got.stalled, want.stalled)
    relres = got.resnorm / got.bnorm
    assert float(relres.max()) <= cfg.function_tol * 1.01 or bool(got.stalled.any())
