"""Dense identities, the stopping guard, the quality checks and the
remaining small names of the port, against the JAX package (counterparts of
tests/test_permuted.py, the dense and stopping tests of tests/test_trace.py,
and the names the port lacked):

  * the MLMC telescoping identity on the port's own 3-level hierarchy of the
    generated 16^2 operator (``generated:16x16:beta=5.0:seed=1`` at mass
    -0.29), with and without the skipped level and with the displaced trace
    on and off, to 1e-9; each level's term equals the JAX package's
    ``exact_difference_trace`` on its hierarchy of the same operator;
  * ``bblock_apply`` against its definition, ``bblock_matrix_host`` and the
    JAX package's B-block;
  * ``ConfirmedStop`` through the JAX test's sequences, and ``stop_confirm``
    and ``rough_batch_full`` runs on the G301-shaped generated 64 x 32
    lattice (complex128, numpy probes): equal samples and rough traces;
  * ``check_quality``: the g3-compatibility the port computes (the JAX
    package's always reads 0) is 0 on real hierarchies and large on a
    prolongator whose blocks sit in the wrong spin half; every other entry
    equals the JAX package's;
  * ``block_stencil_from_dense``, ``BlockProlongator.n_fine``/``n_coarse``
    and ``PhaseTimer.reset``/``__str__``.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deflatedmlmc_schwinger_tpu.config import TraceConfig as JaxTraceConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import MGSolver as JaxMGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy as jax_setup  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg.hierarchy import (  # noqa: E402
    block_stencil_from_dense as jax_block_stencil_from_dense,
)
from deflatedmlmc_schwinger_tpu.mg.setup import check_quality as jax_check_quality  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace import hutchinson as jax_hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace.stats import ConfirmedStop as JaxConfirmedStop  # noqa: E402
from deflatedmlmc_schwinger_tpu.utils.timer import PhaseTimer as JaxPhaseTimer  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import csr_from_stencil, generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, check_quality, setup_hierarchy  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import block_stencil_from_dense  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg.setup import g3_compatibility  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.stats import ConfirmedStop  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.timer import PhaseTimer  # noqa: E402

# each package's trace/__init__ exports the function mlmc under the module's name
jax_mlmc_mod = importlib.import_module("deflatedmlmc_schwinger_tpu.trace.mlmc")
mlmc_mod = importlib.import_module("deflatedmlmc_schwinger_tpu_torch.trace.mlmc")

MASS16, BETA16, SEED16 = -0.29, 5.0, 1
LEVELS16 = dict(matrix=f"generated:16x16:beta={BETA16}:seed={SEED16}", mass=MASS16,
                latt_dims=(16, 16), max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4),
                accuracy_mg_eigvs="low", test_vectors_type="RSVs", x_displacement=2,
                chebyshev_degree=40, subspace_iters=3, dtype=torch.complex128)
NT, NX = 32, 64
G301_SMALL = dict(latt_dims=(NT, NX), aggrs=(16, 4), probe_batch=8, max_nr_ests=200,
                  matrix=f"generated:{NX}x{NT}:beta=5.0:seed=8")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hiers16():
    """{use_permuted: (port hierarchy, JAX hierarchy)} of the 16^2 operator,
    and its dense complex128 matrix."""
    jop = jax_gauge.generate_operator(16, 16, MASS16, beta=BETA16, seed=SEED16)
    op = generate_operator(16, 16, MASS16, beta=BETA16, seed=SEED16, device="cpu")
    out = {}
    for use_permuted in (False, True):
        cfg = TraceConfig(use_permuted=use_permuted, **LEVELS16)
        jcfg = JaxTraceConfig(**dict(LEVELS16, dtype=jnp.complex128, use_permuted=use_permuted))
        out[use_permuted] = setup_hierarchy(op, cfg), jax_setup(jop, jcfg)
    return out, csr_from_stencil(op.host_coeffs()).toarray()


def perm_matrix(n: int, d: int) -> np.ndarray:
    """Pi as a dense matrix, (Pi x)[i] = x[(i + d) % n]."""
    return np.eye(n)[(np.arange(n) + d) % n]


@pytest.mark.parametrize("use_permuted", [False, True])
@pytest.mark.parametrize("skip_level", [False, True])
def test_telescoping_identity(hiers16, use_permuted, skip_level):
    """sum_l tr((A_l^-1 - P_l A_c^-1 P_l^H) B_l Pi_l^T) + tr(A_2^-1 B_2 Pi_2^T)
    = tr(A_0^-1 Pi_0^T) to 1e-9, over levels 0 and 1 or, with level 1
    skipped, level 0 against level 2 through P_0 P_1. Each term equals the
    JAX package's exact_difference_trace to 1e-8 relative."""
    (hs, D) = hiers16
    th, jh = hs[use_permuted]
    assert (th.levels[0].perm_shift > 0) == use_permuted
    invs = [np.linalg.inv(D)] + [np.linalg.inv(lev.op.complex_matrix())
                                 for lev in list(th.levels)[1:]]
    Ps = [lev.P.to_dense() for lev in list(th.levels)[:-1]]
    Pis = [perm_matrix(lev.n, lev.perm_shift) for lev in th.levels]
    Bs = [np.eye(th.levels[0].n)] + [mlmc_mod.bblock_matrix(th, l) for l in (1, 2)]
    if skip_level:
        terms = [(0, Ps[0] @ Ps[1], 2)]
    else:
        terms = [(0, Ps[0], 1), (1, Ps[1], 2)]
    total = 0.0 + 0.0j
    for l, P, c in terms:
        t = complex(np.trace((invs[l] - P @ invs[c] @ P.conj().T) @ Bs[l] @ Pis[l].T))
        ref = jax_mlmc_mod.exact_difference_trace(jh, l, skip_level, use_permuted)
        assert abs(t - ref) <= 1e-8 * max(abs(ref), 1.0), (l, t, ref)
        assert abs(mlmc_mod.exact_difference_trace(th, l, skip_level, use_permuted) - t) <= (
            1e-8 * max(abs(t), 1.0))
        total += t
    total += complex(np.trace(invs[2] @ Bs[2] @ Pis[2].T))
    exact = complex(np.trace(invs[0] @ Pis[0].T))
    assert abs(total - exact) < 1e-9


@pytest.mark.parametrize("level", [1, 2])
def test_bblock_matches_definition_host_form_and_jax(hiers16, level):
    """B_1 = P_0^H Pi_0^H P_0 Pi_1 and B_2 = P_1^H B_1 Pi_1^H P_1 Pi_2 (the
    lazy bblock_apply through bblock_matrix, and on vectors), the sparse
    host recursion, and the JAX package's B-block, to 1e-10."""
    (hs, _) = hiers16
    th, jh = hs[True]
    levels = list(th.levels)
    B = np.eye(levels[0].n)
    for l in range(1, level + 1):
        P = levels[l - 1].P.to_dense()
        B = (P.conj().T @ B @ perm_matrix(levels[l - 1].n, levels[l - 1].perm_shift).T
             @ P @ perm_matrix(levels[l].n, levels[l].perm_shift))
    got = mlmc_mod.bblock_matrix(th, level)
    np.testing.assert_allclose(got, B, atol=1e-10)
    np.testing.assert_allclose(mlmc_mod.bblock_matrix_host(th, level), B, atol=1e-10)
    np.testing.assert_allclose(np.asarray(jax_mlmc_mod.bblock_matrix(jh, level)), got,
                               atol=1e-10)
    rng = np.random.default_rng(level)
    v = rng.standard_normal((3, levels[level].n)) + 1j * rng.standard_normal((3, levels[level].n))
    np.testing.assert_allclose(mlmc_mod.bblock_apply(th, level, torch.from_numpy(v)).numpy(),
                               v @ B.T, atol=1e-10)


@pytest.mark.parametrize("enabled, checks, expected", [
    (False, [(True, 10)], [True]),                       # passthrough when disabled
    # the first crossing arms, the same count is no new batch, one batch later confirms
    (True, [(False, 10), (True, 20), (True, 20), (True, 28)], [False, False, False, True]),
    # a failing check disarms, so the next crossing arms again
    (True, [(True, 8), (False, 16), (True, 24), (True, 32)], [False, False, False, True]),
])
def test_confirmed_stop_matches_jax(enabled, checks, expected):
    port, ref = ConfirmedStop(enabled), JaxConfirmedStop(enabled)
    got = [port(ok, n) for ok, n in checks]
    assert got == [ref(ok, n) for ok, n in checks] == expected


@pytest.fixture(scope="module")
def g301_small():
    """The G301-shaped configuration in complex128 with the stopping rule in
    reach (at most 200 samples), one solver per package, and a result
    cache."""
    cfg = set_params("schwinger256").replace(dtype=torch.complex128, **G301_SMALL)
    jcfg = jax_set_params("schwinger256").replace(dtype=jnp.complex128, **G301_SMALL)
    jop = jax_gauge.generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8)
    op = generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8, device="cpu")
    th = setup_hierarchy(op, cfg)
    jh = jax_setup(jop, jcfg)
    return cfg, jcfg, op, jop, MGSolver(th, cfg.solver), JaxMGSolver(jh, jcfg.solver), {}


def stop_runs(g301_small, stop_confirm: bool, rough_batch_full: bool):
    """(port, JAX) Hutchinson results with these two switches, once each."""
    cfg, jcfg, op, jop, solver, jsolver, cache = g301_small
    key = stop_confirm, rough_batch_full
    if key not in cache:
        kw = dict(stop_confirm=stop_confirm, rough_batch_full=rough_batch_full)
        ref = jax_hutchinson(jop, jcfg.replace(**kw), solver=jsolver, probe_source="numpy",
                             verbose=False)
        res = hutchinson(op, cfg.replace(**kw), solver=solver, probe_source="numpy",
                         verbose=False)
        cache[key] = res, ref
    return cache[key]


@pytest.mark.parametrize("stop_confirm, rough_batch_full",
                         [(False, False), (True, False), (False, True)])
def test_stopping_switches_match_jax(g301_small, stop_confirm, rough_batch_full):
    """The run stops by its rule before max_nr_ests, meets the stderr
    target, and equals the JAX package: samples, iterations, rough trace and
    trace (1e-8 relative). With stop_confirm it takes exactly one batch more
    than without; rough_batch_full averages all probe_batch rough probes."""
    cfg = g301_small[0]
    res, ref = stop_runs(g301_small, stop_confirm, rough_batch_full)
    assert res["nr_ests"] == ref["nr_ests"] < cfg.max_nr_ests
    assert res["function_iters"] == ref["function_iters"]
    for key in ("trace", "rough_trace"):
        assert abs(res[key] - ref[key]) <= 1e-8 * abs(ref[key]), key
    target = cfg.stop_safety * abs(cfg.trace_tol * res["rough_trace"])
    assert res["std_dev"] / np.sqrt(res["nr_ests"]) < target
    base, _ = stop_runs(g301_small, False, False)
    if stop_confirm:
        assert res["nr_ests"] == base["nr_ests"] + cfg.probe_batch
    if rough_batch_full:
        assert res["rough_trace"] != base["rough_trace"]


def test_check_quality_g3_compatibility_on_real_hierarchies(hiers16, g301_small):
    """0 (<= 1e-12) on every level of the 16^2 hierarchies and of the
    G301-shaped one; every other entry equals the JAX package's check of its
    hierarchy of the same operator (absolute 1e-10, relative 1e-8)."""
    (hs, _) = hiers16
    cfg, jcfg, _, _, solver, jsolver, _ = g301_small
    pairs = list(hs.values()) + [(solver.hier, jsolver.hier)]
    for th, jh in pairs:
        q, jq = check_quality(th), jax_check_quality(jh)
        assert q.keys() == jq.keys()
        for name, val in q.items():
            if name.startswith("g3-compatibility"):
                assert val <= 1e-12, (name, val)
            assert abs(val - jq[name]) <= 1e-10 + 1e-8 * abs(jq[name]), (name, val, jq[name])


@pytest.mark.parametrize("move", ["roll half", "one block"])
def test_g3_compatibility_fails_on_a_misplaced_prolongator(hiers16, move):
    """A prolongator whose blocks were moved across the spin halves reads
    >= 0.1: all of them (the rows rolled by half the fine size) or only
    aggregate 0's block (moved to aggregate na/2's rows)."""
    (hs, _) = hiers16
    P_op = hs[False][0].levels[0].P
    na, L, _ = P_op.blocks.shape
    P = P_op.to_dense()
    assert g3_compatibility(P, na) <= 1e-12
    if move == "roll half":
        bad = np.roll(P, P.shape[0] // 2, axis=0)
    else:
        bad = P.copy()
        j = na // 2
        bad[j * L:(j + 1) * L] += bad[:L]
        bad[:L] = 0
    assert g3_compatibility(bad, na) >= 0.1


@pytest.mark.parametrize("lattice", ["16x16", "64x32"])
def test_block_stencil_from_dense_matches_jax(hiers16, g301_small, lattice):
    """On a level-1 Galerkin matrix: equal offsets and packing, blocks and
    packed bands to 1e-12, the matvec equal to the dense product and to the
    JAX package's; None for a dense random matrix in both packages."""
    th = hiers16[0][False][0] if lattice == "16x16" else g301_small[4].hier
    C = th.levels[1].op.complex_matrix()
    dc = th.levels[0].P.blocks.shape[2]
    got = block_stencil_from_dense(C, dc, torch.complex128)
    ref = jax_block_stencil_from_dense(C, dc, jnp.float64)
    assert got.offsets == ref.offsets
    np.testing.assert_allclose(got.blocks.numpy(), cplx.to_complex(ref.blocks), atol=1e-12)
    assert (got.gmat is None) == (ref.gmat is None)
    if got.gmat is not None:
        np.testing.assert_allclose(got.gmat.numpy(), cplx.to_complex(ref.gmat), atol=1e-12)
        np.testing.assert_array_equal(got.gwin.numpy(), np.asarray(ref.gwin))
    np.testing.assert_allclose(got.complex_matrix(), C, atol=1e-12)
    rng = np.random.default_rng(7)
    v = rng.standard_normal((2, C.shape[0])) + 1j * rng.standard_normal((2, C.shape[0]))
    want = v @ C.T
    np.testing.assert_allclose(got.matvec(torch.from_numpy(v)).numpy(), want, atol=1e-10)
    np.testing.assert_allclose(cplx.to_complex(ref.matvec(cplx.from_complex(v))), want,
                               atol=1e-10)
    dense = rng.standard_normal(C.shape) + 1j * rng.standard_normal(C.shape)
    assert block_stencil_from_dense(dense, dc, torch.complex128) is None
    assert jax_block_stencil_from_dense(dense, dc, jnp.float64) is None


def test_prolongator_sizes_match_jax(hiers16, g301_small):
    (hs, _) = hiers16
    for th, jh in list(hs.values()) + [(g301_small[4].hier, g301_small[5].hier)]:
        for lev, jlev in zip(list(th.levels)[:-1], jh.levels[:-1]):
            assert (lev.P.n_fine, lev.P.n_coarse) == (jlev.P.n_fine, jlev.P.n_coarse)
            assert (lev.P.n_fine, lev.P.n_coarse) == lev.P.to_dense().shape


def test_phase_timer_reset_and_text_match_jax():
    """The same phases print the same text as the JAX package's timer;
    reset empties both."""
    port, ref = PhaseTimer(), JaxPhaseTimer(sync=False)
    for t in (port, ref):
        for name in ("sampling", "mg_setup", "sampling"):
            with t.phase(name):
                pass
        t.totals.update(sampling=1.25, mg_setup=0.5)
    assert port.counts == ref.counts == {"sampling": 2, "mg_setup": 1}
    assert str(port) == str(ref)
    assert "sampling : 1.2500 s (2 calls)" in str(port)
    # no counted host read in these phases: nothing is printed beside them
    assert port.host_read == {"sampling": 0.0, "mg_setup": 0.0}
    port.reset()
    ref.reset()
    assert not port.totals and not port.counts and not port.transport and not port.host_read
    assert str(port) == str(ref) == ("\nTimings specific to computations:\n"
                                     " -- accumulated time : 0.0000 s")
