"""The port's device setup backend and the remaining eigensolvers vs the JAX
package, complex128, on a non-square generated lattice (latt_dims (32, 64),
aggregates (16, 4), dof (2, 8, 8)):

  * ``galerkin_block_stencil``: the JAX package's offsets, its blocks to
    1e-10, and the dense P^H A P; ``galerkin_coarse`` to 1e-10;
  * ``setup_hierarchy`` with ``setup_backend='device'`` (RSV and EV test
    vectors): projectors P P^H and coarse operators to 1e-8, and a solve with
    equal per-row iteration counts (the device backend stores no smoother
    roots, so both packages take the gmres_poly_roots fallback);
  * ``harmonic_ritz_smallest``, ``inverse_iteration_smallest`` and
    ``smallest_eigpairs_nonhermitian``: |theta| to 1e-8 and the spanned
    subspace to 1e-7 (eigenvector phases and scalings are not compared).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import MGSolver as JaxMGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import setup as jax_setup_mod  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.dirac import gamma3_pair  # noqa: E402
from deflatedmlmc_schwinger_tpu.solvers import eigs as jax_eigs  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, check_quality  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import setup as setup_mod  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import gamma3  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.solvers import eigs  # noqa: E402

NT, NX = 32, 64
SMALL = dict(latt_dims=(NT, NX), aggrs=(16, 4), setup_backend="device",
             matrix=f"generated:{NX}x{NT}:beta=5.0:seed=8")


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
    assert err <= tol, err


def _subspace_gap(X, Y) -> float:
    """sin of the largest principal angle between span(X) and span(Y)."""
    Qx, _ = np.linalg.qr(X)
    Qy, _ = np.linalg.qr(Y)
    return float(np.linalg.norm(Qy - Qx @ (Qx.conj().T @ Qy), 2))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(**kw):
    port = set_params("schwinger256").replace(dtype=torch.complex128, **SMALL, **kw)
    ref = jax_set_params("schwinger256").replace(dtype=jnp.complex128, **SMALL, **kw)
    return port, ref


def _ops(cfg):
    jop = jax_gauge.generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8)
    op = generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8, device="cpu")
    return jop, op


@pytest.fixture(scope="module")
def built():
    """Both packages' device-backend hierarchies of the RSV profile."""
    cfg, jcfg = _cfgs()
    jop, op = _ops(cfg)
    return (cfg, jcfg, jop, op, jax_setup_mod.setup_hierarchy(jop, jcfg),
            setup_mod.setup_hierarchy(op, cfg))


def _compare_hierarchies(th, jh):
    assert th.sizes() == jh.sizes() == (4096, 1024, 256)
    assert th.poly_roots is None and jh.poly_roots is None
    for i in range(th.nr_levels - 1):
        Pt = th.levels[i].P.to_dense()
        Pj = jh.levels[i].P.to_dense()
        _close(Pt @ Pt.conj().T, Pj @ Pj.conj().T, 1e-8)
        assert th.levels[i].perm_shift == jh.levels[i].perm_shift
    for i in range(1, th.nr_levels):
        _close(th.levels[i].op.complex_matrix(), jh.levels[i].op.complex_matrix(), 1e-8)
    assert th.levels[1].op.offsets == jh.levels[1].op.offsets
    assert (th.levels[1].op.gmat is None) == (jh.levels[1].op.gmat is None)
    _close(th.coarsest_inv.numpy(), cplx.to_complex(jh.coarsest_inv), 1e-8)


def test_device_setup_matches_jax(built):
    cfg, jcfg, _, _, jh, th = built
    _compare_hierarchies(th, jh)
    q = check_quality(th)
    assert q["orthonormality of P at level 0"] < 1e-12
    assert q["hermiticity of g3*A at level 1"] < 1e-10


def test_device_setup_ev_test_vectors_match_jax():
    """The 'EVs' mode goes through smallest_eigpairs_nonhermitian; with the
    displaced trace's per-level shifts."""
    cfg, jcfg = _cfgs(test_vectors_type="EVs", use_permuted=True, x_displacement=2)
    jop, op = _ops(cfg)
    _compare_hierarchies(setup_mod.setup_hierarchy(op, cfg),
                         jax_setup_mod.setup_hierarchy(jop, jcfg))


def test_device_and_host_backends_build_the_same_levels(built):
    """Same seeds and the same CheFSI: the two backends differ in where the
    Galerkin product runs and in the block size the stencil is cut into."""
    cfg, _, _, op, _, th = built
    hh = setup_mod.setup_hierarchy(op, cfg.replace(setup_backend="host"))
    for i in range(1, th.nr_levels):
        _close(th.levels[i].op.complex_matrix(), hh.levels[i].op.complex_matrix(), 1e-8)


def test_unknown_backend_rejected(built):
    cfg, _, _, op, _, _ = built
    with pytest.raises(ValueError, match="setup_backend"):
        setup_mod.setup_hierarchy(op, cfg.replace(setup_backend="gpu"))


def test_solve_on_device_hierarchy_matches_jax(built):
    cfg, jcfg, _, _, jh, th = built
    rng = np.random.default_rng(17)
    b = rng.standard_normal((4, th.sizes()[0])) + 1j * rng.standard_normal((4, th.sizes()[0]))
    ref = JaxMGSolver(jh, jcfg.solver).solve(b, 1e-9)
    res = MGSolver(th, cfg.solver).solve(b, 1e-9)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    _close(res.x.numpy(), cplx.to_complex(ref.x), 1e-8)
    assert not bool(res.stalled.any())


@pytest.mark.parametrize("level", [0, 1])
def test_galerkin_block_stencil_matches_jax_and_dense(built, level):
    _, _, _, _, jh, th = built
    jl, tl = jh.levels[level], th.levels[level]
    got = setup_mod.galerkin_block_stencil(tl.op, tl.P)
    dense = setup_mod.galerkin_coarse(tl.op, tl.P)
    _close(dense, jax_setup_mod.galerkin_coarse(jl.op, jl.P, jl.op.dtype), 1e-10)
    P = tl.P.to_dense()
    A = (tl.op.matvec(torch.eye(tl.n, dtype=torch.complex128)).numpy().T)
    _close(dense, P.conj().T @ A @ P, 1e-10)
    if level == 1:
        # 16 aggregates couple at 15 cyclic offsets: still a block stencil
        assert len(got.offsets) <= 48
    ref = jax_setup_mod.galerkin_block_stencil(jl.op, jl.P, jl.op.dtype)
    assert got.offsets == ref.offsets
    _close(got.blocks.numpy(), cplx.to_complex(ref.blocks), 1e-10)
    _close(got.complex_matrix(), dense, 1e-10)
    assert setup_mod.galerkin_block_stencil(tl.op, tl.P, max_offsets=1) is None


def _level2(built):
    """The dense coarsest level (n = 256): Q = gamma3 A with its exact
    inverse, in both packages' forms."""
    _, _, _, _, jh, th = built
    jop, top = jh.levels[2].op, th.levels[2].op
    jinv, tinv = jh.coarsest_inv, th.coarsest_inv
    return (
        (lambda v: gamma3_pair(jop.matvec(v)),
         lambda v: cplx.matmul_right(gamma3_pair(v), jinv)),
        (lambda v: gamma3(top.matvec(v)), lambda v: gamma3(v) @ tinv.T),
        top.n,
    )


def test_inverse_iteration_smallest_matches_jax(built):
    (jQ, jQinv), (tQ, tQinv), n = _level2(built)
    ref = jax_eigs.inverse_iteration_smallest(jQ, jQinv, n, 6, rdtype=jnp.float64,
                                              seed=5, rounds=3)
    res = eigs.inverse_iteration_smallest(tQ, tQinv, n, 6, dtype=torch.complex128,
                                          device="cpu", seed=5, rounds=3)
    _close(np.abs(res.values), np.abs(ref.values), 1e-8)
    assert _subspace_gap(res.vectors, ref.vectors) < 1e-7
    _close(res.resnorms, ref.resnorms, 1e-8)
    # Rayleigh quotients of unit vectors: none below the smallest |eigenvalue|
    Q = tQ(torch.eye(n, dtype=torch.complex128)).numpy().T
    lowest = np.abs(np.linalg.eigvalsh(0.5 * (Q + Q.conj().T))).min()
    assert float(np.abs(res.values).min()) >= lowest - 1e-10


def test_harmonic_ritz_smallest_matches_jax(built):
    (jQ, jQinv), (tQ, tQinv), n = _level2(built)
    rng = np.random.default_rng(9)
    V = rng.standard_normal((n, 10)) + 1j * rng.standard_normal((n, 10))
    V = eigs._apply_cols(tQinv, V, torch.complex128, "cpu")     # one inverse pass
    ref = jax_eigs.harmonic_ritz_smallest(jQ, V, 5, jnp.float64)
    res = eigs.harmonic_ritz_smallest(tQ, V, 5, torch.complex128, "cpu")
    _close(np.abs(res.values), np.abs(ref.values), 1e-8)
    _close(res.resnorms, ref.resnorms, 1e-8)
    assert _subspace_gap(res.vectors, ref.vectors) < 1e-7


def test_smallest_eigpairs_nonhermitian_matches_jax(built):
    """On the level-1 block-stencil operator (n = 1024)."""
    _, _, _, _, jh, th = built
    jop, top = jh.levels[1].op, th.levels[1].op
    kw = dict(seed=23, degree=30, rounds=3)
    jt, jV = jax_eigs.smallest_eigpairs_nonhermitian(
        jop.matvec, lambda v: gamma3_pair(jop.matvec(v)), jop.n, 4, rdtype=jnp.float64, **kw)
    tt, tV = eigs.smallest_eigpairs_nonhermitian(
        top.matvec, lambda v: gamma3(top.matvec(v)), top.n, 4, dtype=torch.complex128,
        device="cpu", **kw)
    _close(np.abs(tt), np.abs(jt), 1e-8)
    assert _subspace_gap(tV, jV) < 1e-7
