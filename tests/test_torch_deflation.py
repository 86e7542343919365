"""The port's deflation layer vs the JAX package, complex128, on the
flagship-shaped 4-level hierarchy (generated non-square 32x64 lattice,
4096 -> 1024 -> 256 -> 64, aggregates (16, 4, 4), dof (2, 8, 8, 8), sampling
smoother depth 16 and deflation-setup depth 4 in one process):

  * solves that start at levels 1 and 2, under both solver profiles;
  * MGSolver.derived, coarsest_solve and the solve bookkeeping;
  * inverse_iteration_smallest_device from one start block V0 (loose and
    converged profiles): theta to 1e-9 relative, projectors to 1e-8;
  * solve_refined_host with 0 and 1 refinement steps;
  * hutchinson_deflation's tr1 in both correction modes, with and without
    the displaced trace, to 1e-8 relative;
  * hutchinson_step_batch on a basis carried over from the JAX package;
  * a full k = 16 displaced-trace Hutchinson run with the numpy probe stream.

JAX's eigensolver takes the shared V0 through a monkeypatched
``inverse_iteration_smallest_device`` (hutchinson_deflation imports it at
call time), the port's through the same name in its deflation module.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import deflatedmlmc_schwinger_tpu.solvers.eigs as jax_eigs  # noqa: E402
from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import MGSolver as JaxMGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy as jax_setup  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.dirac import (  # noqa: E402
    gamma3_matvec_ctx,
    gamma3_pair,
    pair_operator,
)
from deflatedmlmc_schwinger_tpu.trace import deflation as jax_defl  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace import hutchinson as jax_hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace.hutchinson import (  # noqa: E402
    hutchinson_step_batch as jax_step_batch,
)
from deflatedmlmc_schwinger_tpu.utils.checkpoint import (  # noqa: E402
    save_hierarchy as jax_save_hierarchy,
)
from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import gamma3  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.solvers import eigs  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import deflation, hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.hutchinson import hutchinson_step_batch  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import load_hierarchy  # noqa: E402

NT, NX = 32, 64
MASS, BETA, SEED = -0.15, 5.0, 11
K = 16
SMALL = dict(latt_dims=(NT, NX), aggrs=(16, 4, 4), mass=MASS, probe_batch=8,
             nr_deflat_vctrs=K, defl_buffer=K,
             matrix=f"generated:{NX}x{NT}:beta={BETA}:seed={SEED}")


def flagship_cfgs(**kw):
    """The schwinger128 profile of both packages, cut to the small lattice."""
    port = set_params("schwinger128").replace(dtype=torch.complex128, **SMALL, **kw)
    ref = jax_set_params("schwinger128").replace(dtype=jnp.complex128, **SMALL, **kw)
    return port, ref


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both packages on one hierarchy: JAX builds it, the port loads it."""
    cfg, jcfg = flagship_cfgs()
    jop = jax_gauge.generate_operator(NX, NT, MASS, beta=BETA, seed=SEED)
    op = generate_operator(NX, NT, MASS, beta=BETA, seed=SEED, device="cpu")
    jh = jax_setup(jop, jcfg)
    path = tmp_path_factory.mktemp("hier") / "hierarchy.npz"
    jax_save_hierarchy(jh, str(path))
    th = load_hierarchy(str(path), "cpu", torch.complex128)
    assert th.sizes() == (4096, 1024, 256, 64)
    return cfg, jcfg, jop, op, jh, th


@pytest.fixture(scope="module")
def solvers(built):
    """One solver per package for the module: the JAX package compiles its
    solve programs once per solver instance."""
    cfg, jcfg, _, _, jh, th = built
    return MGSolver(th, cfg.solver), JaxMGSolver(jh, jcfg.solver)


def start_block(n: int, m: int, seed: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))


def projector_apply(U: np.ndarray, X: np.ndarray) -> np.ndarray:
    """U U^H X for an (n, k) basis U: compares subspaces, not phases."""
    return U @ (U.conj().T @ X)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("profile", ["solver", "defl_solver"])
def test_level_solves_match_jax(built, level, profile):
    """Solves starting at level > 0 under the depth-16 and depth-4 profiles
    (4 levels, both profiles in one process): equal per-row iterations."""
    cfg, jcfg, _, _, jh, th = built
    rng = np.random.default_rng(20 + level)
    b = rng.standard_normal((3, th.sizes()[level])) + 1j * rng.standard_normal((3, th.sizes()[level]))
    ref = JaxMGSolver(jh, getattr(jcfg, profile)).solve(b, 1e-8, level=level)
    res = MGSolver(th, getattr(cfg, profile)).solve(b, 1e-8, level=level)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert rel(res.x.numpy(), cplx.to_complex(ref.x)) < 1e-9


def test_derived_and_coarsest_solve_match_jax(built):
    cfg, jcfg, _, _, jh, th = built
    solver = MGSolver(th, cfg.solver)
    jsolver = JaxMGSolver(jh, jcfg.solver)
    assert solver.derived(None) is solver and solver.derived(cfg.solver) is solver
    ds = solver.derived(cfg.defl_solver)
    assert ds is solver.derived(SolverConfig(restart=40, smoother="poly"))
    assert ds.hier is th and ds.cfg.smooth_iters == 4
    rng = np.random.default_rng(8)
    b = rng.standard_normal((2, th.sizes()[0])) + 1j * rng.standard_normal((2, th.sizes()[0]))
    ref = jsolver.derived(jcfg.defl_solver).precond(0)(cplx.from_complex(b))
    assert rel(ds.precond(0)(torch.from_numpy(b)).numpy(), cplx.to_complex(ref)) < 1e-10
    bc = b[:, :th.sizes()[-1]]
    yc = solver.coarsest_solve(torch.from_numpy(bc)).numpy()
    assert rel(yc, cplx.to_complex(jsolver.coarsest_solve(cplx.from_complex(bc)))) < 1e-12
    assert solver.coarsest_lev_iters[-1] == jsolver.coarsest_lev_iters[-1] == 1
    res = solver.solve(b[:, :th.sizes()[2]], 1e-6, level=2)
    jres = jsolver.solve(b[:, :th.sizes()[2]], 1e-6, level=2)
    assert int(solver.num_iters) == int(jsolver.num_iters) == int(res.iters.max())
    assert solver.total_solve_calls == jsolver.total_solve_calls == 1
    assert int(solver.coarsest_lev_iters[2]) == int(jsolver.coarsest_lev_iters[2])
    assert int(jres.iters.max()) == int(res.iters.max())


@pytest.mark.parametrize("profile", ["loose", "converged"])
def test_inverse_iteration_matches_jax(built, solvers, profile):
    """Same start block V0: theta to 1e-9 relative, U U^H to 1e-8."""
    cfg, jcfg, jop, op, jh, th = built
    k, m, rounds, tol = (K, K, 3, 1e-2) if profile == "loose" else (4, 8, 3, 1e-10)
    V0 = start_block(op.n, m)
    pop = pair_operator(jop)
    solver, jsolver = (s.derived(c.defl_solver) for s, c in zip(solvers, (cfg, jcfg)))
    ref = jax_eigs.inverse_iteration_smallest_device(
        gamma3_matvec_ctx, lambda v: jsolver.solve(gamma3_pair(v), tol).x, op.n, k,
        rdtype=jnp.float64, rounds=rounds, tol=tol, V0=V0, ctx=pop)
    res = eigs.inverse_iteration_smallest_device(
        lambda v: gamma3(op.matvec(v)), lambda v: solver.solve(gamma3(v), tol).x,
        op.n, k, dtype=torch.complex128, device="cpu", rounds=rounds, tol=tol, V0=V0)
    assert rel(res.values, ref.values) < 1e-9
    assert rel(res.resnorms, ref.resnorms) < 1e-6
    X = start_block(op.n, 3, seed=9)
    Ur = res.vectors.numpy().T
    Uj = cplx.to_complex(ref.vectors).T
    assert rel(projector_apply(Ur, X), projector_apply(Uj, X)) < 1e-8
    # the rows are orthonormal (final plain Rayleigh--Ritz on a whitened basis)
    assert rel(Ur.conj().T @ Ur, np.eye(k)) < 1e-10


def test_inverse_iteration_random_start_block_is_seeded():
    """Without V0 the start block comes from a generator seeded by ``seed``."""
    n, k = 64, 3
    rng = np.random.default_rng(1)
    d = np.linspace(-1.0, 2.0, n) + 0.05
    Q0, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    H = torch.from_numpy((Q0 * d) @ Q0.conj().T)
    Hinv = torch.linalg.inv(H)

    def run(seed):
        return eigs.inverse_iteration_smallest_device(
            lambda v: v @ H.T, lambda v: v @ Hinv.T, n, k, dtype=torch.complex128,
            device="cpu", seed=seed, rounds=10, buffer=16, warm_filter_degree=4)

    a, b = run(3), run(3)
    np.testing.assert_array_equal(a.values, b.values)
    want = np.sort(np.abs(d))[:k]
    assert rel(np.sort(np.abs(a.values)), want) < 1e-8


@pytest.mark.parametrize("steps", [0, 1])
def test_solve_refined_host_matches_jax(built, solvers, steps):
    """k = 5 rows padded to the batch of 8, loose device tolerance."""
    cfg, jcfg, jop, op, jh, th = built
    rng = np.random.default_rng(30 + steps)
    rhs = rng.standard_normal((5, op.n)) + 1j * rng.standard_normal((5, op.n))
    solver, jsolver = (s.derived(c.defl_solver) for s, c in zip(solvers, (cfg, jcfg)))
    Zj, sj = jax_defl.solve_refined_host(jsolver, pair_operator(jop), cplx.from_complex(rhs),
                                         1e-2, steps, 8)
    Z, s = deflation.solve_refined_host(solver, op, torch.from_numpy(rhs), 1e-2, steps, 8)
    assert Z.shape == (5, op.n) and Z.dtype == np.complex128
    np.testing.assert_array_equal(s, sj)
    assert rel(Z, Zj) < 1e-10


def _patched_v0(monkeypatch, n, m, seed=4):
    V0 = start_block(n, m, seed)
    monkeypatch.setattr(jax_eigs, "inverse_iteration_smallest_device",
                        functools.partial(jax_eigs.inverse_iteration_smallest_device, V0=V0))
    monkeypatch.setattr(deflation, "inverse_iteration_smallest_device",
                        functools.partial(eigs.inverse_iteration_smallest_device, V0=V0))


@pytest.mark.parametrize("use_permuted", [False, True])
@pytest.mark.parametrize("mode", ["solve", "eig"])
def test_hutchinson_deflation_tr1_matches_jax(built, solvers, monkeypatch, mode,
                                             use_permuted):
    cfg, jcfg, jop, op, jh, th = built
    cfg = cfg.replace(use_permuted=use_permuted)
    jcfg = jcfg.replace(use_permuted=use_permuted)
    _patched_v0(monkeypatch, op.n, K)
    ref = jax_defl.hutchinson_deflation(pair_operator(jop), solvers[1], jcfg,
                                        correction_mode=mode)
    got = deflation.hutchinson_deflation(op, solvers[0], cfg, correction_mode=mode)
    assert abs(got.tr1 - ref.tr1) <= 1e-8 * abs(ref.tr1)
    assert rel(got.values, ref.values) < 1e-9
    X = start_block(op.n, 2, seed=5)
    Uj = cplx.to_complex(ref.U)
    assert rel(projector_apply(got.U.numpy(), X), projector_apply(Uj, X)) < 1e-8


def test_hutchinson_step_batch_on_carried_basis(built, solvers):
    """The JAX package's Deflation carried over: same per-probe estimates."""
    cfg, jcfg, jop, op, jh, th = built
    rng = np.random.default_rng(12)
    U, _ = np.linalg.qr(rng.standard_normal((op.n, 6)) + 1j * rng.standard_normal((op.n, 6)))
    jd = jax_defl.Deflation(U=cplx.from_complex(U), tr1=0.25 - 1.0j)
    d = deflation.Deflation.from_numpy(cplx.to_complex(jd.U), jd.tr1, device="cpu",
                                       dtype=torch.complex128)
    assert d.U.shape == (op.n, 6) and d.tr1 == jd.tr1
    X = np.sign(rng.standard_normal((8, op.n))) + 0j
    es, it, st = hutchinson_step_batch(op, solvers[0], cfg, d, torch.from_numpy(X))
    jes, jit, jst = jax_step_batch(pair_operator(jop), solvers[1], jcfg, jd,
                                   cplx.from_complex(X))
    np.testing.assert_array_equal(it, np.asarray(jit))
    np.testing.assert_array_equal(st, np.asarray(jst))
    assert rel(es, np.asarray(jes)) < 1e-9


def test_hutchinson_k16_displaced_matches_jax(built, solvers, monkeypatch):
    """A full run: equal nr_ests, function_iters, stalled_rows; traces to
    1e-8 relative."""
    cfg, jcfg, jop, op, jh, th = built
    cfg, jcfg = (c.replace(max_nr_ests=24) for c in (cfg, jcfg))
    _patched_v0(monkeypatch, op.n, K)
    ref = jax_hutchinson(jop, jcfg, solver=solvers[1], probe_source="numpy", verbose=False)
    stencil_kernels.reset_launch_counts()
    res = hutchinson(op, cfg, solver=solvers[0], probe_source="numpy", verbose=False)
    assert sum(stencil_kernels.launch_counts().values()) == 0
    assert res["nr_ests"] == ref["nr_ests"]
    assert res["function_iters"] == ref["function_iters"]
    assert res["stalled_rows"] == ref["stalled_rows"] == 0
    assert abs(res["trace"] - ref["trace"]) <= 1e-8 * abs(ref["trace"])
    assert abs(res["rough_trace"] - ref["rough_trace"]) <= 1e-8 * abs(ref["rough_trace"])
    assert res["total_complexity"] == pytest.approx(ref["total_complexity"], rel=1e-12)
