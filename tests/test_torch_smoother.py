"""The port's GMRES smoother, the smoother-root fallback and the fused
(z, A z) V-cycle vs the JAX package, complex128, on a non-square generated
lattice (latt_dims (32, 64), aggregates (16, 4), dof (2, 8, 8)) with the JAX
package's own hierarchy loaded into the port:

  * ``gmres_smoother`` to 1e-10, with one all-zero row in the batch (rows
    that FGMRES has finished ride on as zeros);
  * ``gmres_poly_roots`` (the fallback of ``MGSolver._roots_for``) to 1e-10;
  * one V-cycle and one ``MGSolver.solve`` with ``smoother='gmres'``: equal
    per-row iteration counts, x to 1e-9;
  * the ``with_residual`` V-cycle emits the true residual, for both
    smoothers, and ``fgmres(matvec_precond=)`` equals the precond + matvec
    pair.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deflatedmlmc_schwinger_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import MGSolver as JaxMGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import cycle as jax_cycle  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy as jax_setup  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.utils.checkpoint import (  # noqa: E402
    save_hierarchy as jax_save_hierarchy,
)
from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, cycle  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.solvers import fgmres  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import load_hierarchy  # noqa: E402

NT, NX = 32, 64
SMALL = dict(latt_dims=(NT, NX), aggrs=(16, 4), matrix=f"generated:{NX}x{NT}:beta=5.0:seed=8")
SMOOTHERS = ("gmres", "poly")


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
    assert err <= tol, err


def _randc(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hiers(tmp_path_factory):
    """(JAX hierarchy, the same hierarchy loaded into the port)."""
    jcfg = jax_set_params("schwinger256").replace(dtype=jnp.complex128, **SMALL)
    jop = jax_gauge.generate_operator(NX, NT, jcfg.mass, beta=5.0, seed=8)
    jh = jax_setup(jop, jcfg)
    path = tmp_path_factory.mktemp("hier") / "hierarchy.npz"
    jax_save_hierarchy(jh, str(path))
    return jh, load_hierarchy(str(path), "cpu", torch.complex128)


@pytest.mark.parametrize("level,iters", [(0, 4), (1, 4), (0, 6)])
def test_gmres_smoother_matches_jax(hiers, level, iters):
    jh, th = hiers
    r = _randc(21 + level, 5, th.sizes()[level])
    r[2] = 0.0                      # a row whose residual is already zero
    r[3] *= 1e-9
    ref = cplx.to_complex(jax_cycle.gmres_smoother(
        jh.levels[level].op.matvec, cplx.from_complex(r), iters))
    out = cycle.gmres_smoother(th.levels[level].op.matvec, torch.from_numpy(r), iters)
    assert bool(torch.isfinite(out).all())
    assert float(out[2].abs().max()) == 0.0
    _close(out.numpy(), ref, 1e-10)
    np.testing.assert_allclose(out[3].numpy(), ref[3], rtol=1e-8, atol=1e-22)


def test_solve_hpd_small_matches_dense_solve():
    M = torch.from_numpy(_randc(5, 3, 6, 4))
    A = M.mH @ M
    b = torch.from_numpy(_randc(6, 3, 4))
    _close(cycle._solve_hpd_small(A, b).numpy(),
           torch.linalg.solve(A, b[..., None])[..., 0].numpy(), 1e-10)


@pytest.mark.parametrize("level,m", [(0, 4), (0, 7), (1, 4), (1, 16)])
def test_gmres_poly_roots_match_jax(hiers, level, m):
    jh, th = hiers
    jl, tl = jh.levels[level], th.levels[level]
    ref = jax_cycle.gmres_poly_roots(jax.jit(jl.op.matvec), jl.n, jl.op.dtype, m)
    out = cycle.gmres_poly_roots(tl.op.matvec, tl.n, tl.op.dtype, "cpu", m)
    _close(out, ref, 1e-10)


def test_roots_fallback_when_hierarchy_has_none(hiers):
    """Depth 7 is stored nowhere: both packages compute the roots at first
    use and the solves agree."""
    jh, th = hiers
    b = _randc(31, 3, th.sizes()[0])
    js = JaxMGSolver(jh, JaxSolverConfig(restart=40, smoother="poly", smooth_iters=7))
    ts = MGSolver(th, SolverConfig(restart=40, smoother="poly", smooth_iters=7))
    for lvl in range(2):
        _close(ts._roots_for(lvl), js._roots_for(lvl), 1e-10)
    ref = js.solve(b, 1e-9)
    res = ts.solve(b, 1e-9)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    _close(res.x.numpy(), cplx.to_complex(ref.x), 1e-9)


def test_unknown_smoother_rejected(hiers):
    with pytest.raises(ValueError, match="smoother"):
        MGSolver(hiers[1], SolverConfig(smoother="jacobi")).precond(0)


def test_gmres_v_cycle_matches_jax(hiers):
    jh, th = hiers
    b = _randc(7, 3, th.sizes()[0])
    ref = cplx.to_complex(JaxMGSolver(jh, JaxSolverConfig()).precond(0)(cplx.from_complex(b)))
    out = MGSolver(th, SolverConfig()).precond(0)(torch.from_numpy(b)).numpy()
    _close(out, ref, 1e-10)


@pytest.mark.parametrize("level", [0, 1])
def test_gmres_mg_solve_matches_jax(hiers, level):
    """The default SolverConfig (GMRES smoother, restart 20) at 1e-12, the
    16^2 profile's tolerance: equal per-row iterations, x to 1e-9."""
    jh, th = hiers
    b = _randc(11 + level, 4, th.sizes()[level])
    b[1] *= 1e-4
    ref = JaxMGSolver(jh, JaxSolverConfig()).solve(b, 1e-12, level=level)
    res = MGSolver(th, SolverConfig()).solve(b, 1e-12, level=level)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    _close(res.x.numpy(), cplx.to_complex(ref.x), 1e-9)
    assert not bool(res.stalled.any())


@pytest.mark.parametrize("smoother", SMOOTHERS)
@pytest.mark.parametrize("level", [0, 1])
def test_v_cycle_with_residual_is_true_residual(hiers, smoother, level):
    _, th = hiers
    s = MGSolver(th, SolverConfig(restart=40, smoother=smoother))
    v = torch.from_numpy(_randc(40 + level, 3, th.sizes()[level]))
    z, Az = s.precond_matvec(level)(v)
    _close(z.numpy(), s.precond(level)(v).numpy(), 1e-12)
    _close(Az.numpy(), s.matvec(level)(z).numpy(), 1e-10)
    zz, r = cycle.build_v_cycle(list(th.levels)[level:], th.coarsest_inv,
                                s._smoothers(level), with_residual=True)(v)
    _close(r.numpy(), (v - s.matvec(level)(zz)).numpy(), 1e-10)


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_precond_matvec_matches_jax(hiers, smoother):
    jh, th = hiers
    v = _randc(50, 2, th.sizes()[0])
    jz, jAz = JaxMGSolver(jh, JaxSolverConfig(smoother=smoother)).precond_matvec(0)(
        cplx.from_complex(v))
    z, Az = MGSolver(th, SolverConfig(smoother=smoother)).precond_matvec(0)(torch.from_numpy(v))
    _close(z.numpy(), cplx.to_complex(jz), 1e-10)
    _close(Az.numpy(), cplx.to_complex(jAz), 1e-10)


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_fgmres_matvec_precond_equals_pair(hiers, smoother):
    _, th = hiers
    s = MGSolver(th, SolverConfig(restart=40, smoother=smoother))
    b = torch.from_numpy(_randc(60, 4, th.sizes()[0]))
    kw = dict(tol=1e-10, restart=40, max_restarts=10)
    pair = fgmres(s.matvec(0), b, precond=s.precond(0), **kw)
    fused = fgmres(s.matvec(0), b, matvec_precond=s.precond_matvec(0), **kw)
    np.testing.assert_array_equal(fused.iters.numpy(), pair.iters.numpy())
    assert fused.cycles == pair.cycles
    _close(fused.x.numpy(), pair.x.numpy(), 1e-9)
    assert float((fused.resnorm / fused.bnorm).max()) < 1e-10
