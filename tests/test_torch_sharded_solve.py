"""The port's lattice-sharded solve (parallel/sharded_solve.py) and the
estimators over a mesh, on gloo ranks, against the port's replicated
MGSolver and the JAX package, complex128, on generated:16x16:beta=5.0:seed=1
at mass -0.29 (3 levels, aggrs (4, 4)); the solves also on a non-square
lattice (X = 24, T = 16). The hierarchy is the JAX package's, carried over
through its checkpoint file.

Tolerances (the JAX package's own gates, tests/test_sharded_solve.py): equal
iteration counts; x within 1e-9 absolute of the replicated solve at a solve
tolerance of 1e-10; a trace over 4 sample ranks within 1e-9 relative of the
one-rank run (the same rows solved in the same steps) and its std_dev within
1e-7; over a (2, 2) mesh within 1e-6 relative (per-probe estimates agree to
the solve tolerance).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.parallel import ShardedMGSolver as JaxShardedMGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace import hutchinson as jax_hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace import mlmc as jax_mlmc  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import (  # noqa: E402
    BlockProlongator,
    DenseOperator,
    Hierarchy,
    MGLevel,
)
from deflatedmlmc_schwinger_tpu_torch.parallel import ShardedMGSolver, make_mesh  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import load_hierarchy  # noqa: E402

import torch_parallel_setup as tps  # noqa: E402
import torch_rank_fns as rf  # noqa: E402

SOLVE_TOL = 1e-10
SOLVE_CASES = [((2, 2), ("samples", "x"), "poly"), ((1, 4), ("samples", "x"), "poly"),
               ((2, 2), ("samples", "x"), "gmres"), ((1, 4), ("samples", "x"), "gmres")]
LATTICES = {"16x16": tps.SQUARE, "24x16": tps.OBLONG}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    return {name: tps.build(tmp, lattice) for name, lattice in LATTICES.items()}


@pytest.fixture(scope="module")
def solves(built):
    """{lattice: the 4 ranks' results of every solve case}."""
    return {name: tps.run_ranks("solve_cases", 4, SOLVE_CASES, s["hier_path"],
                                s["data_path"], SOLVE_TOL)
            for name, s in built.items()}


@pytest.mark.parametrize("lattice", list(LATTICES))
@pytest.mark.parametrize("case", SOLVE_CASES, ids=[f"{c[0]}-{c[2]}" for c in SOLVE_CASES])
def test_sharded_solve_equals_replicated(built, solves, lattice, case):
    """Same iteration counts as the port's MGSolver, solutions equal far
    below the solve tolerance, every rank holding the whole result."""
    shape, _, smoother = case
    per_rank = solves[lattice]
    ref = per_rank[0]["replicated"][smoother]
    for results in per_rank:
        got = results[(shape, smoother)]
        assert np.array_equal(got["iters"], ref["iters"])
        assert got["cycles"] == ref["cycles"]
        assert np.abs(got["x"] - ref["x"]).max() < 1e-9
        assert (got["resnorm"] / got["bnorm"]).max() < SOLVE_TOL
        np.testing.assert_allclose(got["bnorm"], ref["bnorm"], rtol=1e-13)
        assert not got["stalled"].any()
        assert np.array_equal(got["x"], per_rank[0][(shape, smoother)]["x"])


@pytest.mark.parametrize("shape,smoother", [((2, 2), "poly"), ((1, 4), "gmres")])
def test_sharded_solve_matches_jax_sharded_solve(built, solves, shape, smoother):
    """The JAX package's ShardedMGSolver on the same mesh shape, hierarchy
    and right-hand sides: equal iteration counts, x within 1e-9."""
    s = built["16x16"]
    scfg = JaxSolverConfig(smoother=smoother)
    jres = JaxShardedMGSolver(s["jh"], jax_make_mesh(shape, ("samples", "x")), scfg).solve(
        cplx.from_complex(s["v"]), SOLVE_TOL)
    got = solves["16x16"][0][(shape, smoother)]
    assert np.array_equal(got["iters"], np.asarray(jres.iters))
    assert np.abs(got["x"] - cplx.to_complex(jres.x)).max() < 1e-9


def test_checks_and_error_texts(built):
    s = built["16x16"]
    hier = load_hierarchy(s["hier_path"], "cpu", torch.complex128)
    mesh = make_mesh((1, 1), ("samples", "x"), device="cpu")
    # one rank: the sharded solver is the replicated one
    b = torch.from_numpy(s["v"][:2])
    one = ShardedMGSolver(hier, mesh).solve(b, SOLVE_TOL)
    ref = MGSolver(hier).solve(b, SOLVE_TOL)
    assert torch.equal(one.iters, ref.iters) and float((one.x - ref.x).abs().max()) < 1e-9
    lev0 = hier.levels[0]
    blocks = lev0.P.blocks
    # aggregates of 32 sites on a lattice with T = 16: no t-strips inside one
    # (spin, x) row
    na, L, dc = blocks.shape
    bad = Hierarchy([MGLevel(lev0.op, BlockProlongator(blocks.reshape(na // 8, 8 * L, dc))),
                     *list(hier.levels)[1:]], hier.coarsest_inv)
    with pytest.raises(ValueError, match="aggregates must be contiguous t-strips"):
        ShardedMGSolver(bad, mesh)
    dense = Hierarchy([MGLevel(DenseOperator(torch.eye(4, dtype=torch.complex128)), lev0.P),
                       *list(hier.levels)[1:]], hier.coarsest_inv)
    with pytest.raises(TypeError, match="needs a StencilOperator fine level"):
        ShardedMGSolver(dense, mesh)
    with pytest.raises(ValueError, match="smoother must be"):
        ShardedMGSolver(hier, mesh, dataclasses.replace(MGSolver(hier).cfg, smoother="sor"))


def _quick(cfg, **kw):
    """Two batches of 8 with the rule out of reach: every mesh sees the same
    16 probes, so the test measures invariance and not convergence."""
    return cfg.replace(**{**dict(max_nr_ests=16, trace_tol=1e-8, nr_deflat_vctrs=4), **kw})


@pytest.fixture(scope="module")
def estimates(built):
    """Per rank: hutchinson on no mesh, 4 sample ranks and a (2, 2) mesh
    (counter-keyed probes, k = 4); the same three without deflation on the
    shared numpy probe stream (for the JAX package); mlmc likewise."""
    s = built["16x16"]
    cfg = s["cfg"]
    hq = rf.cfg_fields(_quick(cfg))
    mq = rf.cfg_fields(_quick(cfg, max_nr_ests=8))
    h0 = rf.cfg_fields(_quick(cfg, nr_deflat_vctrs=0, function_tol=1e-10))
    m0 = rf.cfg_fields(_quick(cfg, max_nr_ests=8, nr_deflat_vctrs=0, function_tol=1e-10))
    sx = ("samples", "x")
    cases = [("hutchinson", None, None, hq, "torch"),
             ("hutchinson", (4,), ("samples",), hq, "torch"),
             ("hutchinson", (2, 2), sx, hq, "torch"),
             ("mlmc", None, None, mq, "torch"),
             ("mlmc", (2, 2), sx, mq, "torch"),
             ("hutchinson", (2, 2), sx, h0, "numpy"),
             ("mlmc", (2, 2), sx, m0, "numpy"),
             ("mlmc", (4,), ("samples",), dict(mq, mlmc_schedule="adaptive", max_nr_ests=24), "torch")]
    per_rank = tps.run_ranks("estimator_cases", 4, cases, s["hier_path"], s["data_path"])
    return per_rank


def test_hutchinson_mesh_invariance(estimates):
    for results in estimates:
        r0, r_dp, r_xs = results[0], results[1], results[2]
        assert r_dp["nr_ests"] == r0["nr_ests"] == r_xs["nr_ests"] == 16
        assert r_dp["function_iters"] == r0["function_iters"] == r_xs["function_iters"]
        assert abs(r_dp["trace"] - r0["trace"]) < 1e-9 * abs(r0["trace"])
        assert abs(r_dp["std_dev"] - r0["std_dev"]) < 1e-7
        assert abs(r_xs["trace"] - r0["trace"]) < 1e-6 * abs(r0["trace"])
        assert abs(r_dp["rough_trace"] - r0["rough_trace"]) < 1e-9 * abs(r0["rough_trace"])
    # every rank holds the identical result
    assert all(results[:3] == estimates[0][:3] for results in estimates)


def test_mlmc_lattice_sharded(estimates):
    for results in estimates:
        r0, r_xs = results[3], results[4]
        assert r_xs["nr_ests"] == r0["nr_ests"] == [8, 8, 1]
        assert r_xs["function_iters"] == r0["function_iters"]
        assert abs(r_xs["trace"] - r0["trace"]) < 1e-6 * abs(r0["trace"])
    assert all(results[3:5] == estimates[0][3:5] for results in estimates)


def test_mlmc_adaptive_schedule_agrees_on_every_rank(estimates):
    """The greedy schedule reads batch times; over a mesh all ranks take the
    slowest rank's, or they would send the next batch to different levels."""
    first = estimates[0][7]
    assert first["nr_ests"] == [24, 24, 1]     # the rule is out of reach: every level fills
    assert all(results[7] == first for results in estimates)


def test_estimators_over_a_mesh_match_jax(built, estimates):
    """Both estimators over the (2, 2) mesh against the JAX package's runs
    of the same configuration on the shared numpy probe stream, without
    deflation (the packages draw their eigensolver start blocks apart):
    equal sample and iteration counts, traces within 1e-6 relative."""
    s = built["16x16"]
    jq = s["jcfg"].replace(max_nr_ests=16, trace_tol=1e-8, nr_deflat_vctrs=0,
                           function_tol=1e-10)
    jh_run = jax_hutchinson(s["jop"], jq, hier=s["jh"], verbose=False, probe_source="numpy")
    got = estimates[0][5]
    assert got["nr_ests"] == jh_run["nr_ests"] == 16
    assert got["function_iters"] == jh_run["function_iters"]
    assert abs(got["trace"] - jh_run["trace"]) < 1e-6 * abs(jh_run["trace"])
    jm_run = jax_mlmc(s["jop"], jq.replace(max_nr_ests=8), hier=s["jh"], verbose=False,
                      probe_source="numpy")
    got = estimates[0][6]
    assert got["nr_ests"] == [r["nr_ests"] for r in jm_run["results"]]
    assert got["function_iters"] == [r["function_iters"] for r in jm_run["results"]]
    assert abs(got["trace"] - jm_run["trace"]) < 1e-6 * abs(jm_run["trace"])


def test_sharded_deflation_basis_matches_replicated(built):
    """The deflation-basis solves through the lattice-sharded solver (basis
    rows over 'samples', lattice over 'x') give the same smallest
    eigenvalues and the same exact tr1 as the replicated path, to basis
    accuracy; the sharded basis pads its buffer to a shard multiple."""
    s = built["16x16"]
    cfg = s["cfg"].replace(nr_deflat_vctrs=8, defl_eigvs_tol_Hutch=1e-6,
                           defl_subspace_rounds=12)
    per_rank = tps.run_ranks("deflation_basis", 4, (2, 2), ("samples", "x"),
                             rf.cfg_fields(cfg), s["hier_path"], s["data_path"])
    for got in per_rank:
        rep, sh = got["replicated"], got["sharded"]
        assert rep["shape"] == sh["shape"] == (s["n"], 8)
        np.testing.assert_allclose(np.sort(np.abs(sh["values"]))[:4],
                                   np.sort(np.abs(rep["values"]))[:4], rtol=1e-2)
        assert abs(sh["tr1"] - rep["tr1"]) < 5e-2 * max(abs(rep["tr1"]), 1.0)
        assert sh["tr1"] == per_rank[0]["sharded"]["tr1"]
