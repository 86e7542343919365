"""Kernel K4's block-sparse layout and plain version (ops/block_kernels.py),
held to the coarse operators they replace on the card
(mg/hierarchy.py BlockStencilOperator, mg/cycle.py residual and
poly_smoother). Port only: this file imports no JAX.

On the CPU, on the block-stencil levels of two hierarchies, each in
complex64 and complex128: levels 1 and 2 of a 32^2 lattice with the
schwinger128 profile's aggregates and dof (16 x 16 blocks, grouped band on
level 1, plain blocks on level 2), and level 1 of the 16^2 profile (8 x 8
blocks, grouped band):

  * the layout rebuilds ``blocks`` exactly; blocks of odd size have none;
  * its plain matvec, residual and smoother equal the einsum matvec
    (grouped and plain), ``residual`` and ``poly_smoother``;
  * a layout with one nonzero sub-block left out rebuilds other blocks and
    computes another matvec;
  * a checkpointed hierarchy reloads with the same layout; ``to(dtype)``
    converts the values and keeps the indices; the grouped band's packing
    keeps the layout it was given;
  * on the CPU the V-cycle takes the einsum path (no K4 launch).

On the card (marked ``card``; run
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_block_kernels.py``
there): the kernel against its plain version on the same levels, a
V-cycle whose coarse levels launch K4, and an operator on the card that
packs no grouped band.
"""

import copy
from typing import Sequence

import pytest

torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, cycle, setup_hierarchy  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import (  # noqa: E402
    BlockStencilOperator,
    pack_grouped,
)
from deflatedmlmc_schwinger_tpu_torch.ops import block_kernels as bk  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_hierarchy,
    save_hierarchy,
)

DTYPES = {"c64": torch.complex64, "c128": torch.complex128}
# relative tolerance of a comparison whose sums run in another order
TOL = {"c64": 5e-6, "c128": 1e-12}
CASES = [("flagship32", 1), ("flagship32", 2), ("profile16", 1)]
CASE_IDS = [f"{h}-level{lvl}" for h, lvl in CASES]


def _cfg(name: str, dtype):
    if name == "flagship32":
        return set_params("schwinger128").replace(
            latt_dims=(32, 32), matrix="generated:32x32:beta=5.0:seed=11", mass=-0.17,
            dtype=dtype)
    return set_params("schwinger16").replace(
        matrix="generated:16x16:beta=5.0:seed=1", mass=-0.29, dtype=dtype)


_HIERS: dict = {}


def _hierarchy(name: str, dt: str):
    """The hierarchy (cached per module run) and its config."""
    key = (name, dt)
    if key not in _HIERS:
        cfg = _cfg(name, DTYPES[dt])
        L = cfg.latt_dims[0]
        seed = 11 if name == "flagship32" else 1
        op = generate_operator(L, L, cfg.mass, beta=5.0, seed=seed, device="cpu",
                               dtype=DTYPES[dt])
        torch.manual_seed(0)
        _HIERS[key] = (cfg, setup_hierarchy(op, cfg))
    return _HIERS[key]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=CASES, ids=CASE_IDS)
def case(request):
    return request.param


@pytest.fixture(params=list(DTYPES))
def dt(request):
    return request.param


def _level(case, dt):
    name, lvl = case
    cfg, hier = _hierarchy(name, dt)
    op = hier.levels[lvl].op
    assert isinstance(op, BlockStencilOperator)
    return cfg, hier, lvl, op


def _randc(shape, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(shape, generator=g, dtype=torch.float64) \
        + 1j * torch.randn(shape, generator=g, dtype=torch.float64)
    return v.to(dtype)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _layout_blocks(layout: bk.BlockLayout, offsets: Sequence[int], nac: int) -> torch.Tensor:
    """The (nac, K, dc, dc) blocks that ``layout`` was built from (the
    inverse of ``bk.block_layout`` where the offsets differ mod nac); a
    sub-block column that no offset reaches fails."""
    s, nbr = layout.size, layout.rows
    q = nbr // nac
    offs = [int(o) % nac for o in offsets]
    kof = torch.full((nac,), -1, dtype=torch.long)
    kof[torch.as_tensor(offs, dtype=torch.long)] = torch.arange(len(offs))
    kof = kof.to(layout.vals.device)
    rows = torch.repeat_interleave(torch.arange(nbr, device=layout.vals.device),
                                   layout.rowptr.diff().long())
    cols = layout.cols.long()
    j, ra = rows // q, rows % q
    k = kof[(cols // q - j) % nac]
    assert bool((k >= 0).all()), "a sub-block at an offset the stencil lacks"
    sub = torch.zeros((nac, len(offs), q, q, s, s), dtype=layout.vals.dtype,
                      device=layout.vals.device)
    sub[j, k, ra, cols % q] = layout.vals
    return sub.permute(0, 1, 2, 4, 3, 5).reshape(nac, len(offs), q * s, q * s)


def test_layout_rebuilds_blocks_exactly(case, dt):
    _, _, _, op = _level(case, dt)
    nac, K, dc, _ = op.blocks.shape
    lay = op.layout
    assert lay.size == bk.SIZE == 2
    assert lay.rowptr.dtype == lay.cols.dtype == torch.int32
    assert lay.vals.dtype == op.blocks.dtype and lay.vals.is_contiguous()
    assert torch.equal(_layout_blocks(lay, op.offsets, nac), op.blocks)
    # every stored sub-block holds a nonzero entry, and none is missed
    assert bool((lay.vals != 0).flatten(1).any(1).all())
    # the columns of a row ascend
    for i in range(lay.rows):
        c = lay.cols[lay.rowptr[i]:lay.rowptr[i + 1]]
        assert bool((c[1:] > c[:-1]).all())


def test_blocks_of_odd_size_have_no_layout():
    """Coarse blocks are (2k, 2k); the kernel takes 2 x 2 sub-blocks alone."""
    blocks = _randc((4, 2, 3, 3), 12, torch.complex64)
    with pytest.raises(ValueError, match="sub-blocks"):
        BlockStencilOperator(blocks, (0, 1))


def test_pack_grouped_keeps_the_layout(dt):
    """The packed operator carries the unpacked one's layout, not a second
    one built anew."""
    _, hier = _hierarchy("flagship32", dt)
    op = hier.levels[1].op
    plain = BlockStencilOperator(op.blocks, op.offsets)
    packed = pack_grouped(plain)
    assert plain.gmat is None and packed.gmat is not None
    for a, b in zip(plain.layout, packed.layout):
        assert a is b
    assert torch.equal(packed.gmat, op.gmat)


def test_layout_stores_fewer_entries_than_the_blocks(case, dt):
    """The zeros the aggregation leaves stay out of the layout."""
    _, _, _, op = _level(case, dt)
    stored, nonzero = op.bsr_vals.numel(), int((op.blocks != 0).sum())
    assert nonzero <= stored < op.blocks.numel()
    assert stored <= 1.1 * nonzero


def test_plain_matvec_equals_the_einsum_matvec(case, dt):
    _, _, _, op = _level(case, dt)
    v = _randc((5, op.n), 1, op.dtype)
    got = bk.block_matvec(op.layout, v)        # a CPU tensor: the plain version
    assert (op.gmat is not None) == (case[1] == 1)  # level 1 is grouped, level 2 plain
    plain = BlockStencilOperator(op.blocks, op.offsets)
    assert plain.gmat is None
    assert _rel(got, op.einsum_matvec(v)) <= TOL[dt]
    assert _rel(got, plain.einsum_matvec(v)) <= TOL[dt]
    assert torch.equal(op.matvec(v), op.einsum_matvec(v))   # the CPU route
    # any batch shape
    v3 = v.reshape(5, 1, op.n)
    assert torch.equal(bk.block_matvec(op.layout, v3), got.reshape(5, 1, op.n))


def test_plain_residual_equals_residual(case, dt):
    _, _, _, op = _level(case, dt)
    b, x = _randc((4, op.n), 2, op.dtype), _randc((4, op.n), 3, op.dtype)
    assert _rel(bk.block_residual(op.layout, b, x), cycle.residual(op, b, x)) <= TOL[dt]


@pytest.mark.parametrize("with_residual", [True, False], ids=["residual", "no-residual"])
def test_plain_smoother_equals_poly_smoother(case, dt, with_residual):
    _, hier, lvl, op = _level(case, dt)
    roots = hier.poly_roots[lvl]
    r = _randc((3, op.n), 4, op.dtype)
    x, res = bk.block_poly_smooth(op.layout, r, roots, with_residual)
    ref = cycle.poly_smoother(op.matvec, r, roots, with_residual=with_residual)
    if with_residual:
        assert _rel(x, ref[0]) <= 4 * TOL[dt] and _rel(res, ref[1]) <= 4 * TOL[dt]
        # the emitted residual is the smoother's own: r - A x
        assert _rel(res, r - op.einsum_matvec(x)) <= 1e3 * TOL[dt]
    else:
        assert res is None and _rel(x, ref) <= 4 * TOL[dt]
    sm = cycle.PolySmoother(roots)
    assert torch.equal(sm.smooth(op, r), cycle.poly_smoother(op.matvec, r, roots))


def test_a_layout_missing_a_subblock_fails(case, dt):
    """Leave out one nonzero sub-block (the largest): the blocks no longer
    rebuild, and the matvec differs from the operator's by far more than
    rounding."""
    _, _, _, op = _level(case, dt)
    lay = op.layout
    drop = int(lay.vals.abs().flatten(1).amax(1).argmax())
    row = int(torch.searchsorted(lay.rowptr, drop, right=True)) - 1
    keep = torch.ones(lay.cols.numel(), dtype=torch.bool)
    keep[drop] = False
    rowptr = lay.rowptr.clone()
    rowptr[row + 1:] -= 1
    cut = bk.BlockLayout(rowptr, lay.cols[keep], lay.vals[keep])
    nac = op.blocks.shape[0]
    assert not torch.equal(_layout_blocks(cut, op.offsets, nac), op.blocks)
    v = _randc((2, op.n), 5, op.dtype)
    assert _rel(bk.block_matvec(cut, v), op.einsum_matvec(v)) > 1e3 * TOL[dt]


def test_checkpoint_reloads_the_layout(tmp_path, dt):
    _, hier = _hierarchy("flagship32", dt)
    path = tmp_path / "hierarchy.npz"
    save_hierarchy(hier, str(path))
    back = load_hierarchy(str(path), "cpu", DTYPES[dt])
    n_block = 0
    for lev, lev2 in zip(hier.levels, back.levels):
        if isinstance(lev.op, BlockStencilOperator):
            n_block += 1
            for a, b in zip(lev.op.layout, lev2.op.layout):
                assert a.dtype == b.dtype and torch.equal(a, b)
    assert n_block == 2
    # the layout is a set of buffers: .to(dtype) converts the values only
    op = back.levels[1].op
    other = torch.complex128 if DTYPES[dt] == torch.complex64 else torch.complex64
    op.to(other)
    assert op.bsr_vals.dtype == other and op.bsr_cols.dtype == torch.int32
    assert dict(op.named_buffers()).keys() >= {"bsr_rowptr", "bsr_cols", "bsr_vals"}


def test_offsets_equal_mod_nac_are_summed():
    """Two offsets that name one block column add, as the einsum does."""
    blocks = _randc((6, 3, 4, 4), 6, torch.complex128)
    op = BlockStencilOperator(blocks, (0, 1, 7))          # 7 = 1 mod 6
    lay = op.layout
    assert lay.cols.numel() == 6 * 2 * 2 * 2               # two block columns a row
    v = _randc((3, op.n), 7, torch.complex128)
    assert _rel(bk.block_matvec(lay, v), op.einsum_matvec(v)) <= 1e-13


def test_launch_plan_at_the_coarse_shapes():
    """8 probes a thread on level 1 of the 128^2 hierarchy, 4 on level 2
    (132 SMs: an H100 SXM)."""
    assert bk.launch_plan(8192, 128, 132) == 8
    assert bk.launch_plan(2048, 128, 132) == 4
    assert bk.launch_plan(2048, 1, 132) == 4


def test_cpu_v_cycle_takes_the_einsum_path():
    cfg, hier = _hierarchy("flagship32", "c128")
    bk.reset_launch_counts()
    solver = MGSolver(hier, cfg.solver)
    b = _randc((4, hier.levels[0].n), 8, torch.complex128)
    solver.precond(0)(b)
    assert bk.launch_counts() == {"block_matvec": 0, "block_residual": 0,
                                  "block_poly_smooth": 0}


# ---- on the card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: kernel K4 runs on the card only")
    from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels

    pin_full_precision_matmuls()
    stencil_kernels.load_library()
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 37, 128])
def test_kernel_matches_its_plain_version_on_the_card(card, case, dt, B):
    _, hier, lvl, op = _level(case, dt)
    lay = bk.BlockLayout(*(t.to(card) for t in op.layout))
    roots = hier.poly_roots[lvl]
    v, w = (_randc((B, op.n), s, op.dtype).to(card) for s in (9, 10))
    tol = {"c64": 1e-5, "c128": 1e-12}[dt]
    pairs = [
        (bk.block_matvec(lay, v), bk.block_matvec_plain(lay, v)),
        (bk.block_residual(lay, w, v), bk.block_residual_plain(lay, w, v)),
        (torch.cat(bk.block_poly_smooth(lay, v, roots, True)),
         torch.cat(bk.block_poly_smooth_plain(lay, v, roots, True))),
        (bk.block_poly_smooth(lay, v, roots)[0], bk.block_poly_smooth_plain(lay, v, roots)[0]),
    ]
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= tol


@pytest.mark.card
def test_v_cycle_launches_k4_on_the_card(card):
    cfg, hier = _hierarchy("flagship32", "c64")
    dev_hier = copy.deepcopy(hier).to(card)      # .to moves in place: keep the cached one
    bk.reset_launch_counts()
    solver = MGSolver(dev_hier, cfg.solver)
    b = _randc((8, dev_hier.levels[0].n), 11, cfg.dtype).to(card)
    z = solver.precond(0)(b)
    counts = bk.launch_counts()
    # the V-cycle's coarse levels smooth and take residuals; no bare matvec
    assert counts["block_poly_smooth"] > 0 and counts["block_residual"] > 0, counts
    assert counts["block_matvec"] == 0, counts
    ref = MGSolver(hier, cfg.solver).precond(0)(b.cpu())
    assert _rel(z.cpu(), ref) <= 1e-4


@pytest.mark.card
def test_an_operator_on_the_card_packs_no_grouped_band(card, dt):
    """On the card K4 reads the layout, so ``pack_grouped`` leaves the
    operator as it is; the same blocks on the CPU are packed."""
    _, hier = _hierarchy("flagship32", dt)
    op = hier.levels[1].op
    assert op.gmat is not None
    dev = BlockStencilOperator(op.blocks.to(card), op.offsets)
    assert pack_grouped(dev) is dev and dev.gmat is None
    assert torch.equal(dev.bsr_vals.cpu(), op.bsr_vals)
