"""The tiled K3's algorithm (several roots per launch on a window of the
periodic lattice with a halo, a strip of t-sites a thread, probes in passes)
replayed in plain PyTorch, against the plain recurrence and the JAX
package's Pallas kernel in interpret mode, complex128.

The CUDA kernel itself runs only on the card, where chip_smoke.py holds it
to the plain recurrence on the same kinds of shapes. The replay shares with
the kernel's wrapper how the roots are spread over launches and the halo
they leave (``poly_launches``), and marks every window site outside the
region the kernel computes with NaN, so a tile that read one would not come
out finite."""

import re
from pathlib import Path

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
# the complex64 plan's geometry (window, strip, probes a pass)
C64 = torch.complex64
GEOMETRY = dict(window=sk.WINDOW[C64], strip=sk.STRIP[C64], probes=sk.PROBES_PER_PASS[C64])


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
                                             depth=depth, **GEOMETRY)
    _assert_same(got, ref)


@pytest.mark.parametrize("window,depth,strip,probes",
                         [((16, 32), 2, 2, 1), ((12, 10), 3, 2, 2), ((32, 32), 8, 4, 3)])
@pytest.mark.parametrize("nx,nt", [(24, 40), (20, 52), (21, 41)])
def test_tiled_replay_other_windows(nx, nt, window, depth, strip, probes):
    """Strips of 2 and 4 sites (also on a T that no strip divides), a small
    odd window, probes in passes of 2 and 3, and a halo deeper than a launch
    takes."""
    C, r = _inputs(nx, nt, batch=2, seed=2)
    roots = _roots(7, seed=5)
    for with_residual in (False, True):
        ref = sk.stencil_poly_smooth_plain(C, r, roots, nx, nt, with_residual)
        got = sk.stencil_poly_smooth_tiled_plain(C, r, roots, nx, nt, with_residual,
                                                 window=window, depth=depth, strip=strip,
                                                 probes=probes)
        _assert_same(got, ref)


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("B", [1, 3, 37])
@pytest.mark.parametrize("nx,nt", [(24, 41), (5, 7), (20, 52)])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_tiled_replay_of_each_plan(dtype, nx, nt, B, with_residual):
    """Each dtype's plan at its depth on an odd T, a lattice smaller than
    the window and ragged tiles, for 1, 3 and 37 probes (strips of 2 and 4
    sites on an odd T and probes in passes of 2 and 3 are in
    test_tiled_replay_other_windows)."""
    C, r = _inputs(nx, nt, batch=B, seed=3)
    roots = _roots(2 * sk.FUSE_DEPTH[dtype] + 1, seed=8)
    ref = sk.stencil_poly_smooth_plain(C, r, roots, nx, nt, with_residual)
    got = sk.stencil_poly_smooth_tiled_plain(
        C, r, roots, nx, nt, with_residual, window=sk.WINDOW[dtype],
        depth=sk.FUSE_DEPTH[dtype], strip=sk.STRIP[dtype], probes=sk.PROBES_PER_PASS[dtype])
    _assert_same(got, ref)


@pytest.mark.parametrize("m,depth,with_residual,halo",
                         [(16, 4, True, 4), (16, 4, False, 4), (4, 2, True, 2), (4, 2, False, 2),
                          (5, 4, False, 3), (1, 4, False, 0), (1, 4, True, 1), (3, 4, False, 2)])
def test_poly_launches_share_one_halo(m, depth, with_residual, halo):
    launches, h = sk.poly_launches(m, depth, with_residual)
    assert h == halo
    assert [(f, n) for f, n, _ in launches] == sk.fused_passes(m, depth)
    assert [a for *_, a in launches] == [f + n < m or with_residual for f, n, _ in launches]


def test_strip_must_divide_the_window_row():
    C, r = _inputs(8, 8)
    with pytest.raises(ValueError):
        sk.stencil_poly_smooth_tiled_plain(C, r, _roots(4), 8, 8, True,
                                           window=(24, 30), depth=2, strip=4)


@pytest.mark.parametrize("dtype,sfx,vec", [(torch.complex64, "c64", "float2"),
                                           (torch.complex128, "c128", "double2")])
def test_the_entries_launch_each_dtypes_plan(dtype, sfx, vec):
    """The C entry of each dtype instantiates the plan the wrapper reports
    (WINDOW, STRIP, PROBES_PER_PASS)."""
    src = (Path(sk.__file__).resolve().parent.parent / "csrc" / "stencil.cu").read_text()
    body = src[src.index(f"int dmlmc_stencil_poly_tiled_{sfx}("):]
    m = re.search(r"launch_poly_tiled<(\w+), (\d+), (\d+), (\d+), (\d+)>", body)
    assert m.group(1) == vec
    (wx, wt), S, pb = sk.WINDOW[dtype], sk.STRIP[dtype], sk.PROBES_PER_PASS[dtype]
    assert tuple(int(g) for g in m.groups()[1:]) == (wx, wt, S, pb)
    assert wt % S == 0


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
    """The deepest halo a launch of the kernel may get fits its window, in
    the dtype's plan."""
    WX, WT = sk.WINDOW[dtype]
    d = sk.FUSE_DEPTH[dtype]
    assert 1 <= d <= sk.MAX_FUSE and 2 * d < min(WX, WT)
    C, r = _inputs(24, 40)
    roots = _roots(2 * d + 1)
    ref = sk.stencil_poly_smooth_plain(C, r, roots, 24, 40, True)
    got = sk.stencil_poly_smooth_tiled_plain(C, r, roots, 24, 40, True,
                                             window=(WX, WT), depth=d, strip=sk.STRIP[dtype],
                                             probes=sk.PROBES_PER_PASS[dtype])
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
    assert sk.stencil_poly_smooth.plans == {}


def test_plans_reset_with_the_launch_counts():
    """``stencil_poly_smooth.plans`` is one dict, emptied in place by
    ``reset_launch_counts``, keyed by the shape and the dtype's plan."""
    plans = sk.stencil_poly_smooth.plans
    key = sk._plan_key(torch.complex128, 128, 128, 128, 2)
    assert key.startswith("c128 B=128 128x128: window ")
    plans[key] = 3
    sk.reset_launch_counts()
    assert sk.stencil_poly_smooth.plans is plans and plans == {}
