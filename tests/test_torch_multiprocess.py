"""The port's multi-rank entry on gloo ranks on the CPU: what a rank started
by ``gateway.G302(devices=N)`` runs (parallel/worker.py ``run_entry`` through
``launch``), with a small 16^2 profile in the place of 'schwinger512'. The
three checks of the JAX package's tests/test_multiprocess.py: two ranks
return identical results; they equal the one-rank run; ``allgather_moments``
across ranks equals the host Chan merge. Then 4 ranks with DMLMC_X_SHARDS=2
and 3 ranks, which the probe batch does not divide over. (The estimators
over a mesh are held to the JAX package's in tests/test_torch_sharded_solve.py:
the entry draws its probes from each package's own generator.)

Tolerances: ranks among themselves bit-identical; the 2-rank trace within
1e-9 relative of the one-rank run (same rows, same steps), the (2, 2) run
within 1e-6 (per-probe estimates agree to the solve tolerance); moments
1e-12.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.parallel import make_mesh  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.stats import RunningMoments  # noqa: E402

import torch_parallel_setup as tps  # noqa: E402
import torch_rank_fns as rf  # noqa: E402


def small_profile():
    """16 probes in two batches, the rule out of reach, no deflation (as in
    the generated profiles), polynomial smoother: the hierarchy is built by
    rank 0 inside the entry and broadcast."""
    cfg, _ = tps.configs(tps.SQUARE, trace_tol=1e-8, max_nr_ests=16, nr_deflat_vctrs=0,
                         chebyshev_degree=8, subspace_iters=2, function_tol=1e-10)
    return cfg.replace(solver=SolverConfig(restart=40, smoother="poly"))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def two_ranks():
    return tps.run_ranks("gateway_g302", 2, rf.cfg_fields(small_profile()), 1)


@pytest.fixture(scope="module")
def one_rank():
    """The one-rank run on the loop the mesh runs take (a mesh of one)."""
    cfg = small_profile()
    op = generate_operator(cfg.nx, cfg.nt, cfg.mass, beta=tps.BETA, seed=tps.SQUARE["seed"],
                           device="cpu")
    return hutchinson(op, cfg, mesh=make_mesh((1,), device="cpu"), verbose=False)


KEYS = ("trace", "std_dev", "nr_ests", "function_iters", "rough_trace", "stalled_rows",
        "total_complexity")


def test_two_rank_estimator_bit_identical(two_ranks):
    r0, r1 = two_ranks
    assert r0["nr_ests"] == r1["nr_ests"] == 16
    for k in KEYS:
        assert r0[k] == r1[k], k
    assert r0["ranks_agree"] and r1["ranks_agree"] and r0["ranks_differ_in"] == []
    assert r0["backend"] == "gloo"
    # rank 0 built the hierarchy and the others received it
    assert r0["phase_seconds"]["mg_setup"] > 0 and r1["transport_seconds"]["sampling"] > 0
    # host reads are counted per phase beside transport; over a mesh the loop
    # predicates are any-reduced in transport, not read on one rank
    for r in (r0, r1):
        assert set(r["host_read_seconds"]) == set(r["phase_seconds"])
        assert all(0 <= s <= r["phase_seconds"][k] for k, s in r["host_read_seconds"].items())
    assert r0["kernel_launches"] == {"stencil_matvec": 0, "stencil_residual": 0,
                                     "stencil_poly_smooth": 0}      # CPU ranks: plain versions


def test_two_ranks_match_single_rank(two_ranks, one_rank):
    r0 = two_ranks[0]
    assert r0["nr_ests"] == one_rank["nr_ests"] == 16
    assert r0["function_iters"] == one_rank["function_iters"]
    assert abs(r0["trace"] - one_rank["trace"]) < 1e-9 * abs(one_rank["trace"])
    assert abs(r0["std_dev"] - one_rank["std_dev"]) < 1e-7
    assert r0["total_complexity"] == one_rank["total_complexity"]


def test_allgather_moments_across_ranks(two_ranks):
    expect = RunningMoments()
    expect.update_batch(np.arange(4, dtype=float) + 1j)
    other = RunningMoments()
    other.update_batch(np.arange(4, dtype=float) + 2j)
    expect = expect.merge(other)
    for r in two_ranks:
        n, mean, m2 = r["merged"]
        assert n == expect.count
        assert abs(mean - expect.mean) < 1e-12 and abs(m2 - expect.m2) < 1e-12 * expect.m2


def test_four_ranks_with_the_lattice_cut_in_two(one_rank):
    """DMLMC_X_SHARDS=2 on 4 ranks: mesh (2, 2), lattice-sharded solves."""
    ranks = tps.run_ranks("gateway_g302", 4, rf.cfg_fields(small_profile()), 2)
    for r in ranks:
        assert r["ranks_agree"] and r["nr_ests"] == one_rank["nr_ests"] == 16
        assert r["function_iters"] == one_rank["function_iters"]
        assert abs(r["trace"] - one_rank["trace"]) < 1e-6 * abs(one_rank["trace"])
        assert all(r[k] == ranks[0][k] for k in KEYS)


def test_probe_batch_rounds_to_the_sample_shards():
    """3 ranks, probe_batch 8: the entry rounds the batch down to 6, as the
    JAX package's G302 does, and the run still ends at max_nr_ests."""
    cfg = small_profile().replace(max_nr_ests=12)
    ranks = tps.run_ranks("gateway_g302", 3, rf.cfg_fields(cfg), 1)
    assert all(r["ranks_agree"] and r["nr_ests"] == 12 for r in ranks)


def test_indivisible_probe_batch_is_refused():
    cfg = small_profile()
    op = generate_operator(cfg.nx, cfg.nt, cfg.mass, beta=tps.BETA, seed=tps.SQUARE["seed"],
                           device="cpu")
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import Group
    from deflatedmlmc_schwinger_tpu_torch.parallel.mesh import Mesh

    three = Group(None, (0,), 0)
    mesh = Mesh(shape={"samples": 3}, axis_names=("samples",), coords={"samples": 0},
                groups={"samples": three}, world=three, device=torch.device("cpu"))
    from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, setup_hierarchy

    solver = MGSolver(setup_hierarchy(op, cfg), cfg.solver)
    with pytest.raises(ValueError, match="probe_batch 8 not divisible by mesh axis 3"):
        hutchinson(op, cfg, solver=solver, mesh=mesh, verbose=False)
