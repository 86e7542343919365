"""Plain versions of the port's stencil kernels K1-K3 vs the JAX package's
Pallas kernels run in interpret mode, on non-square lattices in complex128.

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
to these plain versions there. Here a CPU tensor must take the plain
version and leave every launch counter at 0."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.pallas_stencil import (  # noqa: E402
    stencil_matvec_pallas,
    stencil_poly_smooth_pallas,
    stencil_residual_pallas,
)
from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

ATOL = 1e-12
LATTICES = [(6, 10), (16, 8)]   # (X, T), both non-square


def _setup(nx, nt, batch, seed):
    jop = jax_gauge.generate_operator(nx, nt, -0.15, beta=3.0, seed=seed)
    pop = pair_operator(jop)
    C = torch.from_numpy(np.asarray(jop.coeffs))
    rng = np.random.default_rng(seed)
    n = 2 * nx * nt
    z = [rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
         for _ in range(2)]
    return pop, C, z


@pytest.fixture(autouse=True)
def _counters():
    sk.reset_launch_counts()
    yield
    # a CPU tensor never launches a kernel
    assert sk.launch_counts() == {"stencil_matvec": 0, "stencil_residual": 0,
                                  "stencil_poly_smooth": 0}
    assert not any(sk.yardstick_counts().values())


@pytest.mark.parametrize("nx,nt", LATTICES)
def test_k1_plain_matches_pallas(nx, nt):
    pop, C, (z, _) = _setup(nx, nt, 3, 1)
    ref = cplx.to_complex(stencil_matvec_pallas(pop.coeffs, cplx.from_complex(z), nx, nt,
                                                interpret=True))
    y = sk.stencil_matvec(C, torch.from_numpy(z), nx, nt).numpy()
    np.testing.assert_allclose(y, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(sk.stencil_matvec_plain(C, torch.from_numpy(z), nx, nt).numpy(),
                               ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nx,nt", LATTICES)
def test_k2_plain_matches_pallas(nx, nt):
    pop, C, (b, x) = _setup(nx, nt, 2, 2)
    ref = cplx.to_complex(stencil_residual_pallas(
        pop.coeffs, cplx.from_complex(b), cplx.from_complex(x), nx, nt, interpret=True))
    r = sk.stencil_residual(C, torch.from_numpy(b), torch.from_numpy(x), nx, nt).numpy()
    np.testing.assert_allclose(r, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("nx,nt", LATTICES)
def test_k3_plain_matches_pallas(nx, nt, with_residual):
    pop, C, (r, _) = _setup(nx, nt, 2, 3)
    rng = np.random.default_rng(4)
    roots = tuple(complex(a, b) for a, b in
                  zip(rng.standard_normal(4) + 3.0, rng.standard_normal(4)))
    x_ref, cur_ref = stencil_poly_smooth_pallas(
        pop.coeffs, cplx.from_complex(r), roots, nx, nt,
        with_residual=with_residual, interpret=True)
    x, cur = sk.stencil_poly_smooth(C, torch.from_numpy(r), roots, nx, nt,
                                    with_residual=with_residual)
    np.testing.assert_allclose(x.numpy(), cplx.to_complex(x_ref), rtol=0, atol=ATOL)
    if with_residual:
        np.testing.assert_allclose(cur.numpy(), cplx.to_complex(cur_ref), rtol=0, atol=ATOL)
        # the emitted residual really is r - D x
        true_r = r - sk.stencil_matvec_plain(C, x, nx, nt).numpy()
        np.testing.assert_allclose(cur.numpy(), true_r, rtol=0, atol=ATOL)
    else:
        assert cur is None and cur_ref is None


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor on neither CPU nor CUDA raises."""
    C = torch.zeros((2, 2, 5, 4, 6), dtype=torch.complex128, device="meta")
    v = torch.zeros((1, 48), dtype=torch.complex128, device="meta")
    with pytest.raises(RuntimeError):
        sk.stencil_matvec(C, v, 4, 6)
    with pytest.raises(RuntimeError):
        sk.stencil_residual(C, v, v, 4, 6)
    with pytest.raises(RuntimeError):
        sk.stencil_matvec_per_site(C, v, 4, 6)
    with pytest.raises(RuntimeError):
        sk.stencil_residual_per_site(C, v, v, 4, 6)
    with pytest.raises(RuntimeError):
        sk.stencil_poly_smooth(C, v, (2.0,), 4, 6)
    with pytest.raises(RuntimeError):
        sk.stencil_poly_smooth_per_root(C, v, (2.0,), 4, 6)
    # no roots: refused before dispatch, on the CPU too
    c = torch.zeros((2, 2, 5, 4, 6), dtype=torch.complex128)
    w = torch.zeros((1, 48), dtype=torch.complex128)
    for fn in (sk.stencil_poly_smooth, sk.stencil_poly_smooth_per_root):
        with pytest.raises(ValueError):
            fn(c, w, (), 4, 6)
        with pytest.raises(ValueError):
            fn(C, v, (), 4, 6)


def test_library_path_keyed_by_sources():
    """The build lands in a git-ignored directory keyed by the sources."""
    path = sk.library_path()
    assert path.parent.parent.name == "_build"
    assert path.name == "libdmlmc_stencil.so"
    gitignore = (sk._PKG_DIR.parent / ".gitignore").read_text().split()
    assert "deflatedmlmc_schwinger_tpu_torch/_build/" in gitignore
