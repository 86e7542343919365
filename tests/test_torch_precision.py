"""Complex64 and the float64 refinement of the deflation corrections, the
port against the JAX package (counterparts of tests/test_bias.py and
tests/test_refine.py, which need schwinger16.mat).

Every complex64 run here has a complex64 operator (``generate_operator(...,
dtype=complex64)`` in both packages): a complex128 operator solves in
complex128 whatever ``cfg.dtype`` says.

  * G301-shaped, k = 0: ``hutchinson`` on the generated 64 x 32 lattice;
  * G101-shaped: the schwinger16 profile on the generated 16^2 operator
    (``generated:16x16:beta=5.0:seed=1`` at mass -0.29) with one deflation
    basis carried into both estimators, since each package draws its own
    start block for the eigensolver. The basis is the k = 64 eigenvectors
    of gamma3 D nearest zero from a dense complex128 eigendecomposition,
    which the JAX eigensolver converges to, and tr1 comes from the dense
    inverse;
  * the bias of complex64 solves at the tolerance floor and at 5e-4 on
    matched probes against complex128 solves at 1e-13 (the JAX bias test's
    method and bounds);
  * ``hutchinson_deflation`` in complex64 with 0 and 2 refinement steps,
    held to the dense oracle tr(U^H A^-1 U) as the JAX refinement test does;
  * ``hutchinson`` and ``mlmc`` with ``defl_refine_steps=2`` in complex128
    at function_tol 1e-4 on a shared start block: equal counts, traces to
    1e-8.

Equal iteration counts hold where the solve target is well above the
float32 rounding of the true residual. At the complex64 floor (3e-7) a
row's exit iteration is decided by that rounding, which differs between the
port's native complex arithmetic and the JAX package's (re, im) pairs: rows
exit one or more iterations apart in either direction, so there the counts
are held within 3%.
"""

import functools
import importlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import deflatedmlmc_schwinger_tpu.solvers.eigs as jax_eigs  # noqa: E402
from deflatedmlmc_schwinger_tpu.config import TraceConfig as JaxTraceConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import MGSolver as JaxMGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy as jax_setup  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace import deflation as jax_deflation  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import csr_from_stencil, generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, setup_hierarchy  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.solvers import eigs  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import deflation  # noqa: E402

# each package's trace/__init__ exports the estimators under their modules' names
jax_hutch_mod = importlib.import_module("deflatedmlmc_schwinger_tpu.trace.hutchinson")
jax_mlmc = importlib.import_module("deflatedmlmc_schwinger_tpu.trace.mlmc").mlmc
hutch_mod = importlib.import_module("deflatedmlmc_schwinger_tpu_torch.trace.hutchinson")
mlmc = importlib.import_module("deflatedmlmc_schwinger_tpu_torch.trace.mlmc").mlmc

MASS16, BETA16, SEED16 = -0.29, 5.0, 1
GEN16 = dict(matrix=f"generated:16x16:beta={BETA16}:seed={SEED16}", mass=MASS16)
# the 3-level 16^2 hierarchy of the JAX bias and refinement tests
LEVELS16 = dict(GEN16, latt_dims=(16, 16), max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4),
                accuracy_mg_eigvs="low", test_vectors_type="RSVs", use_permuted=False)
NT, NX = 32, 64
G301_SMALL = dict(latt_dims=(NT, NX), aggrs=(16, 4), probe_batch=8, max_nr_ests=24,
                  matrix=f"generated:{NX}x{NT}:beta=5.0:seed=8")
B_BIAS = 32
# complex64 against complex64: the two packages round differently
TRACE_RTOL_C64 = 1e-5
ITERS_RTOL_AT_FLOOR = 0.03


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def ops16(np_dtype, dtype):
    return (jax_gauge.generate_operator(16, 16, MASS16, beta=BETA16, seed=SEED16, dtype=np_dtype),
            generate_operator(16, 16, MASS16, beta=BETA16, seed=SEED16, device="cpu",
                              dtype=dtype))


@pytest.fixture(scope="module")
def dense16():
    """(D, D64): the 16^2 operator assembled in complex128, and the same
    operator rounded to complex64 and assembled in complex128 (the exact
    operator of the complex64 pipeline)."""
    C = generate_operator(16, 16, MASS16, beta=BETA16, seed=SEED16, device="cpu").host_coeffs()
    return (csr_from_stencil(C).toarray(),
            csr_from_stencil(C.astype(np.complex64).astype(np.complex128)).toarray())


def _carry(monkeypatch, U: np.ndarray, tr1: complex):
    """Both estimators take the deflation (U, tr1) in place of their own
    eigensolve."""
    jd = jax_deflation.Deflation(U=cplx.from_complex(U), tr1=tr1)
    d = deflation.Deflation.from_numpy(U, tr1, device="cpu", dtype=torch.from_numpy(U).dtype)
    monkeypatch.setattr(jax_hutch_mod, "hutchinson_deflation", lambda *a, **k: jd)
    monkeypatch.setattr(hutch_mod, "hutchinson_deflation", lambda *a, **k: d)


def _compare(res, ref, equal_iters: bool):
    assert res["nr_ests"] == ref["nr_ests"] >= 6
    assert res["stalled_rows"] == ref["stalled_rows"] == 0
    if equal_iters:
        assert res["function_iters"] == ref["function_iters"]
    else:
        assert (abs(res["function_iters"] - ref["function_iters"])
                <= ITERS_RTOL_AT_FLOOR * ref["function_iters"])
    for key in ("trace", "rough_trace"):
        assert abs(res[key] - ref[key]) <= TRACE_RTOL_C64 * abs(ref[key]), key


def test_g301_shaped_complex64_matches_jax():
    """k = 0, poly smoother, function_tol 5e-4 (the profile's own): equal
    counts, trace to 1e-5 relative (measured 1.4e-7)."""
    cfg = set_params("schwinger256").replace(**G301_SMALL)
    jcfg = jax_set_params("schwinger256").replace(**G301_SMALL)
    assert cfg.dtype == torch.complex64 and jcfg.dtype == jnp.complex64
    jop = jax_gauge.generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8, dtype=np.complex64)
    op = generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8, device="cpu",
                           dtype=torch.complex64)
    ref = jax_hutch_mod.hutchinson(jop, jcfg, probe_source="numpy", verbose=False)
    res = hutch_mod.hutchinson(op, cfg, probe_source="numpy", verbose=False)
    assert res["nr_ests"] == cfg.max_nr_ests
    _compare(res, ref, equal_iters=True)


@pytest.fixture(scope="module")
def g101_c64(dense16):
    """The schwinger16 profile in complex64 on both packages' solvers, and
    the carried k = 64 basis: U = gamma3 V sign(theta) for the eigenpairs of
    the Hermitian gamma3 D nearest zero, rounded to complex64."""
    _, D64 = dense16
    cfg = set_params("schwinger16").replace(dtype=torch.complex64, **GEN16)
    jcfg = jax_set_params("schwinger16").replace(dtype=jnp.complex64, **GEN16)
    jop, op = ops16(np.complex64, torch.complex64)
    n, k = D64.shape[0], int(cfg.nr_deflat_vctrs)
    g3 = np.r_[np.ones(n // 2), -np.ones(n // 2)]
    Q = g3[:, None] * D64
    theta, V = np.linalg.eigh((Q + Q.conj().T) / 2)
    near = np.argsort(np.abs(theta))[:k]
    U = ((g3[:, None] * V[:, near]) * np.sign(theta[near])[None, :]).astype(np.complex64)
    Uc = U.astype(np.complex128)
    tr1 = complex(np.trace(Uc.conj().T @ np.linalg.solve(D64, Uc)))
    return (cfg, jcfg, op, jop, MGSolver(setup_hierarchy(op, cfg), cfg.solver),
            JaxMGSolver(jax_setup(jop, jcfg), jcfg.solver), U, tr1)


@pytest.mark.parametrize("function_tol, equal_iters", [(5e-4, True), (1e-12, False)])
def test_g101_shaped_complex64_matches_jax(g101_c64, monkeypatch, function_tol, equal_iters):
    """On the carried basis: equal samples and stalled rows, trace and
    rough trace to 1e-5 relative; iterations equal at 5e-4, within 3% at
    1e-12, which complex64 clips to the floor."""
    cfg, jcfg, op, jop, solver, jsolver, U, tr1 = g101_c64
    _carry(monkeypatch, U, tr1)
    ref = jax_hutch_mod.hutchinson(jop, jcfg.replace(function_tol=function_tol), solver=jsolver,
                                   probe_source="numpy", verbose=False)
    res = hutch_mod.hutchinson(op, cfg.replace(function_tol=function_tol), solver=solver,
                               probe_source="numpy", verbose=False)
    _compare(res, ref, equal_iters)


def _estimates(solver, X: np.ndarray, tol: float, dtype):
    """Per-probe <x, A^-1 x> of the probes X solved at ``tol`` (clipped by
    the dtype's floor) in either package, as complex128, with the rows'
    relative residuals."""
    if isinstance(solver, JaxMGSolver):
        res = solver.solve(cplx.from_complex(X.astype(dtype)), tol)
        x = cplx.to_complex(res.x)
    else:
        res = solver.solve(torch.from_numpy(X.astype(dtype)), tol)
        x = res.x.numpy()
    relres = np.asarray(res.resnorm) / np.asarray(res.bnorm)
    return np.sum(np.conj(X) * x.astype(np.complex128), axis=-1), relres


@pytest.fixture(scope="module")
def bias16(dense16):
    """The matched probes, the complex128 oracle estimates at 1e-13 (held to
    the dense per-probe values), the dense trace, and each package's
    complex64 solver."""
    D, _ = dense16
    cfg = TraceConfig(dtype=torch.complex64, chebyshev_degree=50, subspace_iters=4, **LEVELS16)
    jcfg = JaxTraceConfig(dtype=jnp.complex64, chebyshev_degree=50, subspace_iters=4, **LEVELS16)
    rng = np.random.default_rng(4242)
    X = rng.choice([-1.0, 1.0], size=(B_BIAS, D.shape[0])).astype(np.complex128)
    _, op128 = ops16(np.complex128, torch.complex128)
    cfg128 = cfg.replace(dtype=torch.complex128)
    oracle, relres = _estimates(MGSolver(setup_hierarchy(op128, cfg128), cfg128.solver),
                                X, 1e-13, np.complex128)
    Dinv = np.linalg.inv(D)
    assert relres.max() < 1e-10
    np.testing.assert_allclose(oracle, np.einsum("bi,ij,bj->b", X.conj(), Dinv, X), rtol=1e-9)
    exact = complex(np.trace(Dinv))
    assert abs(oracle.mean() - exact) < 5 * oracle.std() / np.sqrt(B_BIAS)
    jop, op = ops16(np.complex64, torch.complex64)
    return (cfg, X, oracle, exact, MGSolver(setup_hierarchy(op, cfg), cfg.solver),
            JaxMGSolver(jax_setup(jop, jcfg), jcfg.solver))


@pytest.mark.parametrize("tol, bound", [(1e-12, 1e-3), (5e-4, 5e-3)])
def test_complex64_bias_below_trace_budget(bias16, tol, bound):
    """|mean(e64 - e128)| / |tr| below the JAX test's bounds in both
    packages; their complex64 means agree to 1e-5 of |tr|."""
    cfg, X, oracle, exact, solver, jsolver = bias16
    if tol == 1e-12:
        assert cfg.solver.effective_tol(tol, torch.complex64) == cfg.solver.tol_floor_c64
        assert jsolver.cfg.effective_tol(tol, jnp.complex64) == jsolver.cfg.tol_floor_c64
    e32, _ = _estimates(solver, X, tol, np.complex64)
    je32, _ = _estimates(jsolver, X, tol, np.complex64)
    rel_bias = abs((e32 - oracle).mean()) / abs(exact)
    jax_rel_bias = abs((je32 - oracle).mean()) / abs(exact)
    assert rel_bias < bound and jax_rel_bias < bound, (rel_bias, jax_rel_bias)
    assert abs(e32.mean() - je32.mean()) <= TRACE_RTOL_C64 * abs(exact)


def _shared_start_block(monkeypatch, n: int, m: int, seed: int = 4):
    """Both packages' deflation eigensolvers start from one block."""
    rng = np.random.default_rng(seed)
    V0 = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    monkeypatch.setattr(jax_eigs, "inverse_iteration_smallest_device",
                        functools.partial(jax_eigs.inverse_iteration_smallest_device, V0=V0))
    monkeypatch.setattr(deflation, "inverse_iteration_smallest_device",
                        functools.partial(eigs.inverse_iteration_smallest_device, V0=V0))


REFINE = dict(LEVELS16, chebyshev_degree=40, subspace_iters=3, probe_batch=16,
              nr_deflat_vctrs=16, defl_buffer=16, defl_subspace_rounds=2,
              defl_eigvs_tol_Hutch=1e-3, function_tol=1e-4)


def test_refinement_removes_complex64_correction_error(dense16, monkeypatch):
    """The JAX refinement test's bound, err2 < max(0.1 err0, 2e-4 |oracle|),
    and the tenfold cut itself, in both packages; the oracle tr(U^H A^-1 U)
    takes each package's own basis and the complex128 inverse of the
    complex64-rounded operator. The refined tr1 of the two packages agree to
    1e-6 relative (their bases differ by complex64 rounding)."""
    _, D64 = dense16
    Ainv = np.linalg.inv(D64)
    cfg = TraceConfig(dtype=torch.complex64, **REFINE)
    jcfg = JaxTraceConfig(dtype=jnp.complex64, **REFINE)
    jop, op = ops16(np.complex64, torch.complex64)
    solver = MGSolver(setup_hierarchy(op, cfg), cfg.solver)
    jsolver = JaxMGSolver(jax_setup(jop, jcfg), jcfg.solver)
    _shared_start_block(monkeypatch, op.n, cfg.defl_buffer)
    tr1 = {}
    for steps in (0, 2):
        d = deflation.hutchinson_deflation(op, solver, cfg.replace(defl_refine_steps=steps))
        jd = jax_deflation.hutchinson_deflation(pair_operator(jop), jsolver,
                                                jcfg.replace(defl_refine_steps=steps))
        for name, U, t in (("port", d.U.numpy(), d.tr1),
                           ("jax", cplx.to_complex(jd.U), jd.tr1)):
            U = U.astype(np.complex128)
            oracle = complex(np.trace(U.conj().T @ Ainv @ U))
            tr1[name, steps] = t, abs(t - oracle), abs(oracle)
    for name in ("port", "jax"):
        (_, err0, scale), (_, err2, _) = tr1[name, 0], tr1[name, 2]
        assert err2 < max(0.1 * err0, 2e-4 * scale), (name, err0, err2, scale)
        assert err2 < 0.1 * err0, (name, err0, err2)
    assert abs(tr1["port", 2][0] - tr1["jax", 2][0]) <= 1e-6 * abs(tr1["jax", 2][0])


ESTIMATOR_REFINE = dict(REFINE, probe_batch=8, max_nr_ests=16, mlmc_fine_deflation=True,
                        mlmc_deflat_vctrs=(0, 0), mlmc_levels_to_skip=(1,),
                        defl_refine_steps=2)


@pytest.fixture(scope="module")
def refine128():
    """Both packages' complex128 solvers for the estimators with
    refinement (one each for the module: the JAX package compiles once)."""
    cfg = TraceConfig(dtype=torch.complex128, **ESTIMATOR_REFINE)
    jcfg = JaxTraceConfig(dtype=jnp.complex128, **ESTIMATOR_REFINE)
    jop, op = ops16(np.complex128, torch.complex128)
    return (cfg, jcfg, op, jop, MGSolver(setup_hierarchy(op, cfg), cfg.solver),
            JaxMGSolver(jax_setup(jop, jcfg), jcfg.solver))


@pytest.mark.parametrize("estimator", ["hutchinson", "mlmc"])
def test_estimators_with_refinement_match_jax(refine128, monkeypatch, estimator):
    """defl_refine_steps=2 inside the estimators (the Hutchinson correction,
    and for MLMC also the level-0 add-back of mlmc_fine_deflation), in
    complex128 at function_tol 1e-4, where the refinement moves tr1: equal
    counts per level, traces to 1e-8 relative. (At function_tol 1e-12 the
    refinement moves tr1 by about 1e-13 only: the estimators' 'solve'
    correction mode refines, but the solves are already that exact.)"""
    cfg, jcfg, op, jop, solver, jsolver = refine128
    _shared_start_block(monkeypatch, op.n, cfg.defl_buffer)
    if estimator == "hutchinson":
        ref = jax_hutch_mod.hutchinson(jop, jcfg, solver=jsolver, probe_source="numpy",
                                       verbose=False)
        res = hutch_mod.hutchinson(op, cfg, solver=solver, probe_source="numpy", verbose=False)
        levels, jlevels = [res], [ref]
        unrefined = deflation.hutchinson_deflation(op, solver,
                                                   cfg.replace(defl_refine_steps=0)).tr1
        refined = res["deflation"].tr1
        assert abs(refined - unrefined) > 1e-9 * abs(refined)
    else:
        ref = jax_mlmc(jop, jcfg, solver=jsolver, probe_source="numpy", verbose=False)
        res = mlmc(op, cfg, solver=solver, probe_source="numpy", verbose=False)
        levels, jlevels = res["results"], ref["results"]
    for r, j in zip(levels, jlevels):
        assert r["nr_ests"] == j["nr_ests"]
        assert r["function_iters"] == j["function_iters"]
    assert res["stalled_rows"] == ref["stalled_rows"] == 0
    for key in ("trace", "rough_trace"):
        assert abs(res[key] - ref[key]) <= 1e-8 * abs(ref[key]), key
