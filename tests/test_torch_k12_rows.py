"""K1/K2's row kernel (whole lattice rows of a chunk of probes staged in
shared memory, coefficients held over the chunk) replayed in plain PyTorch
against the plain stencil and the JAX package's Pallas kernels in interpret
mode, complex128; its launch plan at every shape a path gives K1/K2; and the
wrappers' cached operand validation.

The CUDA kernel itself runs only on the card, where chip_smoke.py holds it to
the plain versions. The replay follows the plan the wrapper would launch
(tiles of R rows, column tiles, chunks of probes, the bulk or per-element
copy path) and raises unless every site is written by exactly one block."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.pallas_stencil import (  # noqa: E402
    stencil_matvec_pallas,
    stencil_residual_pallas,
)
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

ATOL = 1e-12
SMS = 132           # the H100's SM count, which the plan reads on the card
# (X, T): non-square; odd T (the per-element copy path in complex64); X
# smaller than R + 2; X that R does not divide
LATTICES = [(6, 10), (16, 8), (5, 7), (2, 8), (7, 6)]
# (rows R, probes per block); None takes the plan's own choice
PLANS = [(None, None), (1, 1), (3, 2), (4, 5)]


def _inputs(nx, nt, batch=5, seed=1):
    op = generate_operator(nx, nt, -0.15, beta=3.0, seed=seed, device="cpu",
                           dtype=torch.complex128)
    assert (op.nx, op.nt) == (nx, nt)
    rng = np.random.default_rng(seed)
    v, b = (torch.from_numpy(rng.standard_normal((batch, op.n))
                             + 1j * rng.standard_normal((batch, op.n))) for _ in range(2))
    return op.coeffs, v, b


def _plan(B, nx, nt, itemsize, residual, rows=None, ppb=None, aligned=True):
    return sk.launch_plan(B, nx, nt, itemsize, SMS, residual=residual, aligned=aligned,
                          rows=None if rows is None else min(rows, nx),
                          probes_per_block=ppb)


def _close(got, ref):
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= ATOL * float(ref.abs().max())


@pytest.mark.parametrize("itemsize,aligned", [(8, True), (8, False), (16, True)])
@pytest.mark.parametrize("rows,ppb", PLANS)
@pytest.mark.parametrize("nx,nt", LATTICES)
def test_replay_matches_plain(nx, nt, rows, ppb, itemsize, aligned):
    C, v, b = _inputs(nx, nt)
    B = v.shape[0]
    p1 = _plan(B, nx, nt, itemsize, False, rows, ppb, aligned)
    p2 = _plan(B, nx, nt, itemsize, True, rows, ppb, aligned)
    _close(sk.stencil_rows_plain(C, v, nx, nt, plan=p1), sk.stencil_matvec_plain(C, v, nx, nt))
    _close(sk.stencil_rows_plain(C, v, nx, nt, b, plan=p2),
           sk.stencil_residual_plain(C, b, v, nx, nt))


@pytest.mark.parametrize("nx,nt", [(6, 10), (5, 7), (2, 8)])
def test_replay_matches_pallas(nx, nt):
    jop = jax_gauge.generate_operator(nx, nt, -0.15, beta=3.0, seed=3)
    pop = pair_operator(jop)
    C = torch.from_numpy(np.asarray(jop.coeffs))
    rng = np.random.default_rng(7)
    n = 2 * nx * nt
    z, w = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)) for _ in range(2))
    y_ref = cplx.to_complex(stencil_matvec_pallas(pop.coeffs, cplx.from_complex(z), nx, nt,
                                                  interpret=True))
    r_ref = cplx.to_complex(stencil_residual_pallas(
        pop.coeffs, cplx.from_complex(w), cplx.from_complex(z), nx, nt, interpret=True))
    for itemsize in (8, 16):
        for rows, ppb in PLANS[:3]:
            y = sk.stencil_rows_plain(C, torch.from_numpy(z), nx, nt,
                                      plan=_plan(3, nx, nt, itemsize, False, rows, ppb))
            r = sk.stencil_rows_plain(C, torch.from_numpy(z), nx, nt, torch.from_numpy(w),
                                      plan=_plan(3, nx, nt, itemsize, True, rows, ppb))
            np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=ATOL)
            np.testing.assert_allclose(r.numpy(), r_ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("rows", [None, 1, 2])
def test_replay_on_a_padded_block(rows):
    """The lattice-sharded path's block: X/k rows between two rows of zero
    coefficients (parallel/halo.py); interior rows equal the whole lattice's."""
    C, v, _ = _inputs(8, 6, batch=3)
    xl = 4
    padded = torch.nn.functional.pad(C[:, :, :, :xl], (0, 0, 1, 1)).contiguous()
    g = v.reshape(3, 2, 8, 6)
    blk = torch.cat([g[:, :, -1:], g[:, :, :xl], g[:, :, xl:xl + 1]], dim=2).reshape(3, -1)
    for itemsize in (8, 16):
        plan = _plan(3, xl + 2, 6, itemsize, False, rows, 2)
        got = sk.stencil_rows_plain(padded, blk, xl + 2, 6, plan=plan)
        _close(got, sk.stencil_matvec_plain(padded, blk, xl + 2, 6))
        whole = sk.stencil_matvec_plain(C, v, 8, 6).reshape(3, 2, 8, 6)[:, :, :xl]
        _close(got.reshape(3, 2, xl + 2, 6)[:, :, 1:-1], whole)


def test_replay_with_column_tiles():
    """A row wider than a block's threads is cut into column tiles, which
    stage the two neighbouring columns; the copy path is per element."""
    nx, nt = 3, 2100
    C, v, b = _inputs(nx, nt, batch=2)
    for itemsize in (8, 16):
        plan = _plan(2, nx, nt, itemsize, True)
        assert plan.cols < nt and not plan.bulk
        _close(sk.stencil_rows_plain(C, v, nx, nt, b, plan=plan),
               sk.stencil_residual_plain(C, b, v, nx, nt))


# Every (B, X, T, itemsize) a path or chip_smoke.py gives K1/K2.
PLAN_SHAPES = {
    "G101": (8, 16, 16, 16), "G102": (128, 128, 128, 8), "G301": (64, 256, 256, 8),
    "G302": (16, 512, 512, 8), "G302 B8": (8, 512, 512, 8),
    "x2 B8": (8, 258, 512, 8), "x2 B16": (16, 258, 512, 8),
    "x4 B8": (8, 130, 512, 8), "x4 B16": (16, 130, 512, 8),
    "stress 24x40 c128": (3, 24, 40, 16), "stress 24x40 B37": (37, 24, 40, 8),
    "stress 20x52": (37, 20, 52, 16), "odd T": (5, 9, 13, 8), "odd T small": (3, 5, 7, 8),
    "one row": (2, 1, 16, 16), "two rows": (3, 2, 8, 8), "column tiles": (3, 3, 2100, 8),
    "deflation block": (256, 128, 128, 8), "one probe": (1, 128, 128, 8),
}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("label", sorted(PLAN_SHAPES))
def test_launch_plan(label, residual, aligned):
    B, nx, nt, itemsize = PLAN_SHAPES[label]
    p = sk.launch_plan(B, nx, nt, itemsize, SMS, residual=residual, aligned=aligned)
    spt = 2 if itemsize == 8 else 1
    assert 1 <= p.rows <= nx and 1 <= p.cols <= nt
    assert p.threads == -(-p.rows * p.cols // spt) <= sk.ROWS_MAX_THREADS
    assert 1 <= p.stages <= min(sk.ROWS_MAX_STAGES, p.probes_per_block)
    assert p.smem <= sk.MAX_SMEM
    # the bytes the C launcher recomputes and checks
    pitch = nt if p.bulk else -(-(p.cols + 2) // (16 // itemsize)) * (16 // itemsize)
    rows_staged = 2 * (p.rows + 2) + (2 * p.rows if residual else 0)
    assert p.smem == sk.ROWS_BAR_BYTES + p.stages * rows_staged * pitch * itemsize
    # tiles cover every row (and column) once, chunks every probe once
    starts = list(range(0, nx, p.rows))
    covered = [x for x0 in starts for x in range(x0, min(nx, x0 + p.rows))]
    assert covered == list(range(nx))
    assert p.tiles == len(starts) * -(-nt // p.cols)
    assert p.chunks == -(-B // p.probes_per_block)
    assert (p.chunks - 1) * p.probes_per_block < B <= p.chunks * p.probes_per_block
    # whole rows are copied in bulk exactly where alignment allows it
    assert p.bulk == (aligned and p.cols == nt and (nt * itemsize) % 16 == 0)
    assert p.cols == min(nt, sk.ROWS_MAX_THREADS * spt)


def test_launch_plan_g102_chunks():
    """At G102 a tile is 2 rows (128 threads, four blocks per SM by their
    registers) and 8 chunks of 16 probes give 512 blocks, one such wave."""
    p = sk.launch_plan(128, 128, 128, 8, SMS, residual=False)
    assert (p.rows, p.cols, p.threads, p.tiles, p.chunks, p.probes_per_block) == (
        2, 128, 128, 64, 8, 16)
    assert p.bulk and p.stages == sk.ROWS_STAGES


def test_launch_plan_small_batches_take_small_tiles():
    """At G101 (8 probes, 16^2) the card is not filled even at one probe per
    block, so a tile is one row: 128 blocks."""
    p = sk.launch_plan(8, 16, 16, 16, SMS, residual=True)
    assert (p.rows, p.probes_per_block, p.tiles * p.chunks) == (1, 1, 128)


def test_launch_plan_leaves_room_for_its_blocks():
    """The stages leave an SM's shared memory to as many blocks as its
    registers hold (at G302, K2's three stages are 98 KB: two blocks)."""
    for B, nx, nt in ((16, 512, 512), (128, 128, 128), (64, 256, 256)):
        for residual in (False, True):
            p = sk.launch_plan(B, nx, nt, 8, SMS, residual=residual)
            occupancy = min(sk.SM_MAX_BLOCKS, sk.SM_REGS // (p.threads * sk.ROWS_REGS))
            assert occupancy * (p.smem + 1024) <= sk.SM_SMEM


def test_launch_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError):
        sk.launch_plan(8, 512, 512, 8, SMS, residual=False, rows=4)   # 1024 threads
    with pytest.raises(ValueError):
        sk.launch_plan(8, 16, 16, 16, SMS, residual=False, stages=9)
    with pytest.raises(ValueError):
        sk.launch_plan(0, 16, 16, 16, SMS, residual=False)


def _valid(device="cpu", dtype=torch.complex128, nx=4, nt=6, B=2):
    C = torch.zeros((2, 2, 5, nx, nt), dtype=dtype, device=device)
    v = torch.zeros((B, 2 * nx * nt), dtype=dtype, device=device)
    return C, v


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_validation_accepts_and_caches(device):
    C, v = _valid(device)
    assert sk._check_operands(C, 4, 6, v, v) == ("c128", 16, 2)
    assert sk._coeff_cache[id(C)][1] == ("c128", 16)
    assert sk._check_operands(C, 4, 6, v.reshape(1, 2, -1)) == ("c128", 16, 2)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_validation_refuses(device):
    C, v = _valid(device)
    with pytest.raises(TypeError):           # coefficients of a real dtype
        sk._check_operands(C.real.contiguous(), 4, 6, v)
    with pytest.raises(TypeError):           # vectors of another dtype
        sk._check_operands(C, 4, 6, v.to(torch.complex64))
    with pytest.raises(ValueError):          # coefficients of another lattice
        sk._check_operands(C, 6, 4, v)
    with pytest.raises(ValueError):          # vectors of another length
        sk._check_operands(C, 4, 6, v[:, :-2].contiguous())
    with pytest.raises(ValueError):          # b and x of different shapes
        sk._check_operands(C, 4, 6, v, v[:1])
    with pytest.raises(ValueError):          # non-contiguous vectors
        sk._check_operands(C, 4, 6, torch.zeros((48, 2), dtype=C.dtype, device=device).T)
    wide = torch.zeros((2, 2, 5, 4, 12), dtype=C.dtype, device=device)
    with pytest.raises(ValueError):          # non-contiguous coefficients
        sk._check_operands(wide[..., ::2], 4, 6, v)
    other = "meta" if device == "cpu" else "cpu"
    with pytest.raises(ValueError):          # mixed devices
        sk._check_operands(C, 4, 6, torch.zeros(v.shape, dtype=v.dtype, device=other))


def test_validation_cache_sees_a_changed_tensor():
    """A cached tensor is validated anew when what the key holds changes: a
    non-contiguous view with the same shape, address and dtype is refused."""
    C = torch.zeros((2, 2, 5, 6, 6), dtype=torch.complex128)
    v = torch.zeros((1, 72), dtype=torch.complex128)
    sk._check_operands(C, 6, 6, v)
    view = C.transpose(3, 4)
    assert view.data_ptr() == C.data_ptr() and view.shape == C.shape
    with pytest.raises(ValueError):
        sk._check_operands(view, 6, 6, v)
    sk._coeff_cache[id(view)] = sk._coeff_cache[id(C)]   # the same id, reused
    with pytest.raises(ValueError):
        sk._check_operands(view, 6, 6, v)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the row-kernel and per-site wrappers are the plain stencil
    and count no launch."""
    C, v, b = _inputs(6, 10)
    sk.reset_launch_counts()
    y = sk.stencil_matvec_plain(C, v, 6, 10)
    r = sk.stencil_residual_plain(C, b, v, 6, 10)
    for fn in (sk.stencil_matvec, sk.stencil_matvec_per_site):
        assert torch.equal(fn(C, v, 6, 10), y)
    for fn in (sk.stencil_residual, sk.stencil_residual_per_site):
        assert torch.equal(fn(C, b, v, 6, 10), r)
    assert sum(sk.launch_counts().values()) == 0
    assert sk.yardstick_counts() == {"stencil_poly_smooth_per_root": 0,
                                     "stencil_matvec_per_site": 0,
                                     "stencil_residual_per_site": 0}
