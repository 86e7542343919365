"""The port's halo-exchange stencil (parallel/halo.py) on gloo ranks against
the JAX package's ``halo_matvec`` on the same mesh shapes and against the
dense operator, complex128, on generated:16x16:beta=5.0:seed=1 and on a
non-square generated lattice (X = 24, T = 16), both at mass -0.29.

Tolerance 1e-12 (relative and absolute) throughout: 18 complex products per
site in float64, summed in another order than the CSR product; two
applications of D get 1e-11, as in the JAX package's own test.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.parallel import halo_matvec as jax_halo_matvec  # noqa: E402
from deflatedmlmc_schwinger_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from deflatedmlmc_schwinger_tpu.parallel import shard_coeffs as jax_shard_coeffs  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import csr_from_stencil  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops.stencil_kernels import stencil_matvec_plain  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.parallel import halo, make_mesh  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import Group  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.parallel.mesh import Mesh  # noqa: E402

import torch_parallel_setup as tps  # noqa: E402

TOL = 1e-12
# (mesh shape, axis names, applications of D); all run in one 4-rank group,
# a smaller mesh takes the first ranks of it
CASES = [((1,), ("x",), 1), ((2,), ("x",), 1), ((4,), ("x",), 1),
         ((2, 2), ("samples", "x"), 1), ((1, 4), ("samples", "x"), 2)]
LATTICES = {"16x16": tps.SQUARE, "24x16": tps.OBLONG}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{lattice: (setup dict, per-case results of the 4 ranks)}."""
    tmp = tmp_path_factory.mktemp("halo")
    out = {}
    for name, lattice in LATTICES.items():
        nx, nt, seed = lattice["nx"], lattice["nt"], lattice["seed"]
        from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge
        from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator

        jop = jax_gauge.generate_operator(nx, nt, tps.MASS, beta=tps.BETA, seed=seed)
        rng = np.random.default_rng(3)
        v = rng.standard_normal((8, 2 * nx * nt)) + 1j * rng.standard_normal((8, 2 * nx * nt))
        coeffs = np.asarray(jop.coeffs).astype(np.complex128)
        path = str(tmp / f"data_{name}.npz")
        np.savez(path, coeffs=coeffs, v=v)
        per_rank = tps.run_ranks("halo_cases", 4, CASES, path)
        out[name] = (dict(pop=pair_operator(jop), v=v, coeffs=coeffs, nx=nx, nt=nt), per_rank)
    return out


def _jax_halo(setup, shape, names, applications):
    """The JAX package's halo matvec on the same mesh shape (a mesh without
    a samples axis gets one of size 1: its halo_matvec names both axes)."""
    if "samples" not in names:
        shape, names = (1,) + tuple(shape), ("samples",) + tuple(names)
    mesh = jax_make_mesh(shape, names)
    mv = jax_halo_matvec(jax_shard_coeffs(setup["pop"], mesh, "x"), mesh)
    B = setup["v"].shape[0]
    g = cplx.from_complex(setup["v"].reshape(B, 2, setup["nx"], setup["nt"]))
    g = jax.device_put(g, NamedSharding(mesh, P("samples", None, "x", None)))
    for _ in range(applications):
        g = mv(g)
    return cplx.to_complex(g).reshape(B, -1)


@pytest.mark.parametrize("lattice", list(LATTICES))
@pytest.mark.parametrize("case", range(len(CASES)), ids=[str(c[0]) for c in CASES])
def test_halo_matvec_matches_jax_and_dense(ranks, lattice, case):
    setup, per_rank = ranks[lattice]
    shape, names, applications = CASES[case]
    A = csr_from_stencil(setup["coeffs"])
    want = setup["v"]
    for _ in range(applications):
        want = (A @ want.T).T
    want_jax = _jax_halo(setup, shape, names, applications)
    tol = TOL if applications == 1 else 1e-11
    np.testing.assert_allclose(want_jax, want, rtol=tol, atol=tol)
    in_mesh = int(np.prod(shape))
    for rank, results in enumerate(per_rank):
        got = results[case]
        if rank >= in_mesh:
            assert got is None      # a rank the mesh leaves out
            continue
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, want_jax, rtol=tol, atol=tol)
        # every rank holds the same gathered result, bit for bit
        assert np.array_equal(got, per_rank[0][case])


def test_one_shard_wraps_locally_and_plain_taps_match_the_stencil(ranks):
    """nshards = 1 needs no process group: the boundary rows are the block's
    own, and the plain local apply equals the unsharded plain stencil."""
    setup, _ = ranks["24x16"]
    op = StencilOperator.from_numpy(setup["coeffs"], device="cpu")
    mesh = make_mesh((1, 1), ("samples", "x"), device="cpu")
    sh = halo.shard_coeffs(op, mesh, "x")
    assert sh.group is None and sh.nshards == 1 and sh.padded is None
    v = torch.from_numpy(setup["v"])
    blk = halo.local_block(v, mesh, op.nx, op.nt)
    got = halo.halo_matvec(sh, mesh)(blk).reshape(v.shape)
    want = stencil_matvec_plain(op.coeffs, v, op.nx, op.nt)
    assert float((got - want).abs().max()) < TOL
    r = halo.halo_residual(sh, blk, blk).reshape(v.shape)
    assert float((r - (v - want)).abs().max()) < TOL


def test_padded_block_gives_the_local_rows():
    """What the CUDA path computes, replayed with the plain stencil on the
    CPU: the periodic stencil on the block padded with the neighbours' rows,
    against coefficients padded with zero rows, equals the halo apply on the
    block's own rows (K1's wrap only touches the two pad rows)."""
    rng = np.random.default_rng(8)
    xl, nt, B = 6, 8, 3
    c = torch.from_numpy(rng.standard_normal((2, 2, 5, xl, nt))
                         + 1j * rng.standard_normal((2, 2, 5, xl, nt)))
    v, prv, nxt = (torch.from_numpy(rng.standard_normal(s) + 1j * rng.standard_normal(s))
                   for s in ((B, 2, xl, nt), (B, 2, 1, nt), (B, 2, 1, nt)))
    want = halo._halo_kernel(c, v, prv, nxt)
    padded = torch.nn.functional.pad(c, (0, 0, 1, 1))
    y = stencil_matvec_plain(padded, halo._padded(v, prv, nxt), xl + 2, nt)
    got = y.reshape(B, 2, xl + 2, nt)[:, :, 1:-1]
    assert float((got - want).abs().max()) < TOL


def test_indivisible_lattice_is_refused(ranks):
    setup, _ = ranks["16x16"]
    op = StencilOperator.from_numpy(setup["coeffs"], device="cpu")
    three = Group(None, (0, 1, 2), 0)
    mesh = Mesh(shape={"samples": 1, "x": 3}, axis_names=("samples", "x"),
                coords={"samples": 0, "x": 0}, groups={"x": three}, world=three,
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="nx=16 not divisible by 3 x-shards"):
        halo.shard_coeffs(op, mesh, "x")
    sh = halo.shard_coeffs(op, make_mesh((1, 1), ("samples", "x"), device="cpu"), "x")
    with pytest.raises(ValueError, match="cut for 1 x-shards, mesh has 3"):
        halo.halo_matvec(sh, mesh)
