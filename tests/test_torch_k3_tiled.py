"""The tiled K3's algorithm (several roots per launch on a window of the
periodic lattice with a halo) replayed in plain PyTorch, against the plain
recurrence and the JAX package's Pallas kernel in interpret mode, complex128.

The CUDA kernel itself runs only on the card, where chip_smoke.py holds it
to the plain recurrence on the same kinds of shapes. The replay shares with
the kernel's wrapper how the roots are spread over launches
(``fused_passes``) and marks every window site outside the valid region with
NaN, so a tile that read one would not come out finite."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.pallas_stencil import (  # noqa: E402
    stencil_poly_smooth_pallas,
)
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

ATOL = 1e-12
# (X, T): smaller than a window, two that no tile divides, one that is
# several windows wide
LATTICES = [(8, 8), (24, 40), (20, 52), (32, 64)]


def _roots(m, seed=4):
    rng = np.random.default_rng(seed)
    return tuple(complex(a, b) for a, b in
                 zip(rng.standard_normal(m) + 3.0, rng.standard_normal(m)))


def _inputs(nx, nt, batch=3, seed=1):
    op = generate_operator(nx, nt, -0.15, beta=3.0, seed=seed, device="cpu",
                           dtype=torch.complex128)
    assert (op.nx, op.nt) == (nx, nt)
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((batch, op.n)) + 1j * rng.standard_normal((batch, op.n))
    return op.coeffs, torch.from_numpy(r)


def _assert_same(got, ref):
    scale = float(ref[0].abs().max())
    assert torch.isfinite(got[0]).all()
    assert float((got[0] - ref[0]).abs().max()) <= ATOL * scale
    if ref[1] is None:
        assert got[1] is None
    else:
        assert torch.isfinite(got[1]).all()
        assert float((got[1] - ref[1]).abs().max()) <= ATOL * float(ref[1].abs().max())


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("m", [1, 4, 5, 16])
@pytest.mark.parametrize("nx,nt", LATTICES)
def test_tiled_replay_matches_plain(nx, nt, m, depth, with_residual):
    C, r = _inputs(nx, nt)
    roots = _roots(m)
    ref = sk.stencil_poly_smooth_plain(C, r, roots, nx, nt, with_residual)
    got = sk.stencil_poly_smooth_tiled_plain(C, r, roots, nx, nt, with_residual,
                                             window=(32, 32), depth=depth)
    _assert_same(got, ref)


@pytest.mark.parametrize("window,depth", [((16, 32), 2), ((12, 10), 3), ((32, 32), 8)])
@pytest.mark.parametrize("nx,nt", [(24, 40), (20, 52)])
def test_tiled_replay_other_windows(nx, nt, window, depth):
    """The complex128 window of the kernel, a small odd one, and the deepest
    halo a launch takes."""
    C, r = _inputs(nx, nt, batch=2, seed=2)
    roots = _roots(7, seed=5)
    for with_residual in (False, True):
        ref = sk.stencil_poly_smooth_plain(C, r, roots, nx, nt, with_residual)
        got = sk.stencil_poly_smooth_tiled_plain(C, r, roots, nx, nt, with_residual,
                                                 window=window, depth=depth)
        _assert_same(got, ref)


@pytest.mark.parametrize("nx,nt,m,depth,with_residual",
                         [(24, 40, 5, 4, True), (20, 52, 16, 2, False)])
def test_tiled_replay_matches_pallas(nx, nt, m, depth, with_residual):
    jop = jax_gauge.generate_operator(nx, nt, -0.15, beta=3.0, seed=3)
    pop = pair_operator(jop)
    C = torch.from_numpy(np.asarray(jop.coeffs))
    rng = np.random.default_rng(7)
    r = rng.standard_normal((2, 2 * nx * nt)) + 1j * rng.standard_normal((2, 2 * nx * nt))
    roots = _roots(m, seed=6)
    x_ref, cur_ref = stencil_poly_smooth_pallas(
        pop.coeffs, cplx.from_complex(r), roots, nx, nt,
        with_residual=with_residual, interpret=True)
    x, cur = sk.stencil_poly_smooth_tiled_plain(C, torch.from_numpy(r), roots, nx, nt,
                                                with_residual, depth=depth)
    np.testing.assert_allclose(x.numpy(), cplx.to_complex(x_ref), rtol=0, atol=ATOL)
    if with_residual:
        np.testing.assert_allclose(cur.numpy(), cplx.to_complex(cur_ref), rtol=0, atol=ATOL)
    else:
        assert cur is None and cur_ref is None


@pytest.mark.parametrize("m", [1, 2, 4, 5, 7, 16, 17])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
def test_fused_passes_cover_the_roots(m, depth):
    passes = sk.fused_passes(m, depth)
    assert len(passes) == -(-m // depth)
    assert [f for f, _ in passes] == [sum(n for _, n in passes[:i]) for i in range(len(passes))]
    assert sum(n for _, n in passes) == m
    sizes = [n for _, n in passes]
    assert max(sizes) <= depth and max(sizes) - min(sizes) <= 1


def test_fused_passes_need_a_root():
    with pytest.raises(ValueError):
        sk.fused_passes(0, 4)


def test_halo_must_leave_a_tile():
    C, r = _inputs(8, 8)
    with pytest.raises(ValueError):
        sk.stencil_poly_smooth_tiled_plain(C, r, _roots(4), 8, 8, True,
                                           window=(8, 8), depth=4)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_fuse_depth_leaves_a_tile(dtype):
    """The deepest halo a launch of the kernel may get fits its window."""
    WX, WT = sk.WINDOW[dtype]
    d = sk.FUSE_DEPTH[dtype]
    assert 1 <= d <= sk.MAX_FUSE and 2 * d < min(WX, WT)
    C, r = _inputs(24, 40)
    roots = _roots(2 * d + 1)
    ref = sk.stencil_poly_smooth_plain(C, r, roots, 24, 40, True)
    got = sk.stencil_poly_smooth_tiled_plain(C, r, roots, 24, 40, True,
                                             window=(WX, WT), depth=d)
    _assert_same(got, ref)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU both K3 wrappers are the plain recurrence and count no
    launch."""
    C, r = _inputs(24, 40)
    roots = _roots(5)
    sk.reset_launch_counts()
    ref = sk.stencil_poly_smooth_plain(C, r, roots, 24, 40, True)
    for fn in (sk.stencil_poly_smooth, sk.stencil_poly_smooth_per_root):
        got = fn(C, r, roots, 24, 40, with_residual=True)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert fn.launches == 0
