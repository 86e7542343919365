"""Port multigrid layer vs the JAX package, complex128, on a G301-shaped
non-square lattice (latt_dims (32, 64), aggregates (16, 4), dof (2, 8, 8)):

  * (c) the hierarchy from setup_hierarchy_host (fine test vectors on the
    host and through the device CheFSI) equals JAX's to 1e-10;
  * (d) with JAX's own hierarchy loaded through load_hierarchy, one V-cycle
    agrees to 1e-10 and one MGSolver.solve agrees on x to 1e-9 with equal
    per-row iteration counts;
  * FGMRES alone and the device CheFSI alone against their counterparts.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import MGSolver as JaxMGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy as jax_setup  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu.utils.checkpoint import (  # noqa: E402
    save_hierarchy as jax_save_hierarchy,
)
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, check_quality, setup_hierarchy  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import load_hierarchy  # noqa: E402

NT, NX = 32, 64
SMALL = dict(latt_dims=(NT, NX), aggrs=(16, 4), matrix=f"generated:{NX}x{NT}:beta=5.0:seed=8")


def _cfgs(**kw):
    port = set_params("schwinger256").replace(dtype=torch.complex128, **SMALL, **kw)
    ref = jax_set_params("schwinger256").replace(dtype=jnp.complex128, **SMALL, **kw)
    return port, ref


def _ops(cfg):
    jop = jax_gauge.generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8)
    op = generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8, device="cpu")
    return jop, op


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max()) / scale
    assert err <= tol, err


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_built():
    cfg, jcfg = _cfgs()
    jop, op = _ops(cfg)
    return cfg, jcfg, jop, op, jax_setup(jop, jcfg)


@pytest.mark.parametrize("fine_eigs", ["host", "device"])
def test_setup_hierarchy_matches_jax(fine_eigs):
    """(c) P blocks, coarse operators, coarsest inverse and smoother roots."""
    cfg, jcfg = _cfgs(setup_fine_eigs=fine_eigs)
    jop, op = _ops(cfg)
    jh = jax_setup(jop, jcfg)
    th = setup_hierarchy(op, cfg)
    assert th.sizes() == jh.sizes() == (4096, 1024, 256)
    for i in range(th.nr_levels - 1):
        _close(th.levels[i].P.blocks.numpy(), cplx.to_complex(jh.levels[i].P.blocks), 1e-10)
        assert th.levels[i].perm_shift == jh.levels[i].perm_shift
    for i in range(1, th.nr_levels):
        _close(th.levels[i].op.complex_matrix(), jh.levels[i].op.complex_matrix(), 1e-10)
    assert th.levels[1].op.offsets == jh.levels[1].op.offsets
    assert (th.levels[1].op.gmat is None) == (jh.levels[1].op.gmat is None)
    _close(th.coarsest_inv.numpy(), cplx.to_complex(jh.coarsest_inv), 1e-10)
    _close(np.asarray(th.poly_roots), np.asarray(jh.poly_roots), 1e-10)
    q = check_quality(th)
    assert q["orthonormality of P at level 0"] < 1e-12
    assert q["hermiticity of g3*A at level 1"] < 1e-10


def test_setup_backend_device_waits():
    """The device backend no longer waits for its slice: it builds the
    levels the host backend builds, without stored smoother roots (the full
    comparison with the JAX package is tests/test_torch_setup_device.py)."""
    cfg, _ = _cfgs(setup_backend="device")
    _, op = _ops(cfg)
    th = setup_hierarchy(op, cfg)
    hh = setup_hierarchy(op, cfg.replace(setup_backend="host"))
    assert th.sizes() == hh.sizes() == (4096, 1024, 256)
    assert th.poly_roots is None and hh.poly_roots is not None
    for i in range(1, th.nr_levels):
        _close(th.levels[i].op.complex_matrix(), hh.levels[i].op.complex_matrix(), 1e-8)
    with pytest.raises(ValueError, match="setup_backend"):
        setup_hierarchy(op, cfg.replace(setup_backend="chip"))


def test_block_stencil_packed_matvec(loaded):
    """The grouped-band packed coarse matvec equals the unpacked one."""
    from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import BlockStencilOperator

    packed = loaded[3].levels[1].op
    assert packed.gmat is not None
    plain = BlockStencilOperator(packed.blocks, packed.offsets)
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((3, packed.n)) + 1j * rng.standard_normal((3, packed.n)))
    _close(packed.matvec(v).numpy(), plain.matvec(v).numpy(), 1e-13)
    _close(packed.matvec(v).numpy(), (packed.complex_matrix() @ v.numpy().T).T, 1e-12)


@pytest.fixture(scope="module")
def loaded(jax_built, tmp_path_factory):
    cfg, jcfg, jop, op, jh = jax_built
    path = tmp_path_factory.mktemp("hier") / "hierarchy.npz"
    jax_save_hierarchy(jh, str(path))
    th = load_hierarchy(str(path), "cpu", torch.complex128)
    return cfg, jcfg, jh, th


def test_load_hierarchy_exact(loaded):
    _, _, jh, th = loaded
    assert th.sizes() == jh.sizes()
    np.testing.assert_array_equal(th.levels[0].op.coeffs.numpy(),
                                  cplx.to_complex(jh.levels[0].op.coeffs))
    assert th.poly_roots == jh.poly_roots
    for i in range(1, th.nr_levels):
        np.testing.assert_array_equal(th.levels[i].op.complex_matrix(),
                                      jh.levels[i].op.complex_matrix())


def test_v_cycle_matches_jax(loaded):
    """(d) one V-cycle on the same hierarchy and right-hand sides."""
    cfg, jcfg, jh, th = loaded
    rng = np.random.default_rng(7)
    n = th.sizes()[0]
    b = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    ref = cplx.to_complex(JaxMGSolver(jh, jcfg.solver).precond(0)(cplx.from_complex(b)))
    stencil_kernels.reset_launch_counts()
    out = MGSolver(th, cfg.solver).precond(0)(torch.from_numpy(b)).numpy()
    _close(out, ref, 1e-10)
    assert stencil_kernels.launch_counts()["stencil_poly_smooth"] == 0


@pytest.mark.parametrize("level", [0, 1])
def test_mg_solve_matches_jax(loaded, level):
    """(d) one preconditioned solve: x to 1e-9, equal per-row iterations;
    level 1 exercises the retargeted solve."""
    cfg, jcfg, jh, th = loaded
    rng = np.random.default_rng(11 + level)
    n = th.sizes()[level]
    b = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    ref = JaxMGSolver(jh, jcfg.solver).solve(b, 1e-9, level=level)
    res = MGSolver(th, cfg.solver).solve(b, 1e-9, level=level)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    _close(res.x.numpy(), cplx.to_complex(ref.x), 1e-9)
    assert not bool(res.stalled.any())
    assert float((res.resnorm / res.bnorm).max()) < 1e-9


def test_gmres_smoother_waits(loaded):
    """Neither the GMRES smoother nor a polynomial depth without stored
    roots waits for its slice any more: both precondition a solve that
    converges (parity with the JAX package: tests/test_torch_smoother.py)."""
    from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig

    _, _, _, th = loaded
    rng = np.random.default_rng(2)
    b = rng.standard_normal((2, th.sizes()[0])) + 1j * rng.standard_normal((2, th.sizes()[0]))
    plain = MGSolver(th, SolverConfig(smoother="poly")).solve(b, 1e-9, precondition=False,
                                                               max_restarts=2)
    for sc in (SolverConfig(smoother="gmres"), SolverConfig(smoother="poly", smooth_iters=7)):
        res = MGSolver(th, sc).solve(b, 1e-9)
        assert float((res.resnorm / res.bnorm).max()) < 1e-9
        assert not bool(res.stalled.any())
    assert bool(plain.stalled.all())        # 40 unpreconditioned steps do not


@pytest.mark.parametrize("stall_ratio", [None, 0.9])
def test_fgmres_unpreconditioned_matches_jax(jax_built, stall_ratio):
    """FGMRES alone, several restart cycles: equal per-row iterations and
    cycles, x to 1e-9."""
    from deflatedmlmc_schwinger_tpu.solvers.fgmres import fgmres as jax_fgmres
    from deflatedmlmc_schwinger_tpu_torch.solvers import fgmres

    _, _, jop, op, _ = jax_built
    pop = pair_operator(jop)
    rng = np.random.default_rng(5)
    b = rng.standard_normal((3, op.n)) + 1j * rng.standard_normal((3, op.n))
    b[1] *= 1e-3      # rows of different scale converge at different steps
    kw = dict(tol=1e-6, restart=12, max_restarts=6, stall_ratio=stall_ratio)
    ref = jax_fgmres(pop.matvec, cplx.from_complex(b), **kw)
    res = fgmres(op.matvec, torch.from_numpy(b), **kw)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert res.cycles == int(ref.cycles)
    np.testing.assert_array_equal(res.stalled.numpy(), np.asarray(ref.stalled))
    _close(res.x.numpy(), cplx.to_complex(ref.x), 1e-9)


def test_chebyshev_filtered_smallest_matches_jax(jax_built):
    """The device-resident CheFSI (here on CPU tensors) vs the JAX one."""
    from deflatedmlmc_schwinger_tpu.ops.dirac import gamma3_pair
    from deflatedmlmc_schwinger_tpu.solvers.eigs import (
        chebyshev_filtered_smallest as jax_chefsi,
    )
    from deflatedmlmc_schwinger_tpu_torch.ops.dirac import gamma3
    from deflatedmlmc_schwinger_tpu_torch.solvers.eigs import chebyshev_filtered_smallest

    _, _, jop, op, _ = jax_built
    pop = pair_operator(jop)
    ref = jax_chefsi(lambda v: gamma3_pair(pop.matvec(v)), pop.n, 4,
                     rdtype=jnp.float64, seed=9, degree=20, rounds=2)
    res = chebyshev_filtered_smallest(lambda v: gamma3(op.matvec(v)), op.n, 4,
                                      dtype=torch.complex128, device="cpu",
                                      seed=9, degree=20, rounds=2)
    _close(res.values, ref.values, 1e-10)
    _close(res.vectors, ref.vectors, 1e-10)
    _close(res.resnorms, ref.resnorms, 1e-8)
