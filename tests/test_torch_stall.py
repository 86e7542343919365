"""The stall policy of the port's estimators against the JAX package
(counterpart of tests/test_stall.py, which needs schwinger128.mat).

The operator is the G301-shaped generated 64 x 32 lattice in complex128
(the schwinger256 profile cut to latt_dims (32, 64), aggregates (16, 4),
8-probe batches, at most 24 samples) with a crippled solver: 4 Arnoldi
steps and one cycle against function_tol 1e-13, so every probe row ends
above its tolerance and is flagged as stalled. Both packages run on the
same operator with the "numpy" probe stream and one solver each for the
module:

  * ``check_stalled`` at its threshold, case for case as the JAX test;
  * under the default ``max_stalled_frac`` both ``hutchinson`` and ``mlmc``
    raise in the same phase as the JAX package;
  * with ``max_stalled_frac=1.0`` the runs finish and report the same
    stalled rows (per level for MLMC), samples and iterations as the JAX
    package, and the same trace to 1e-8 relative;
  * the host-gathered sampling loop of a checkpointed run counts the same
    stalled rows as the device-resident loop.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deflatedmlmc_schwinger_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import MGSolver as JaxMGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy as jax_setup  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace import hutchinson as jax_hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace.stats import check_stalled as jax_check_stalled  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, setup_hierarchy  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.stats import check_stalled  # noqa: E402

# each package's trace/__init__ exports the function mlmc under the module's name
jax_mlmc = importlib.import_module("deflatedmlmc_schwinger_tpu.trace.mlmc").mlmc
mlmc = importlib.import_module("deflatedmlmc_schwinger_tpu_torch.trace.mlmc").mlmc

NT, NX = 32, 64
CRIPPLED = dict(latt_dims=(NT, NX), aggrs=(16, 4), probe_batch=8, max_nr_ests=24,
                function_tol=1e-13, matrix=f"generated:{NX}x{NT}:beta=5.0:seed=8")
ESTIMATORS = {"hutchinson": (hutchinson, jax_hutchinson), "mlmc": (mlmc, jax_mlmc)}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def crippled():
    """Both packages' configurations, operators and solvers (one each, so
    the JAX package compiles its solve programs once for the module)."""
    cfg = set_params("schwinger256").replace(
        dtype=torch.complex128, solver=SolverConfig(restart=4, max_restarts=1, smoother="poly"),
        **CRIPPLED)
    jcfg = jax_set_params("schwinger256").replace(
        dtype=jnp.complex128, solver=JaxSolverConfig(restart=4, max_restarts=1, smoother="poly"),
        **CRIPPLED)
    jop = jax_gauge.generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8)
    op = generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8, device="cpu")
    solver = MGSolver(setup_hierarchy(op, cfg), cfg.solver)
    jsolver = JaxMGSolver(jax_setup(jop, jcfg), jcfg.solver)
    return cfg, jcfg, op, jop, solver, jsolver, {}


def relaxed_runs(crippled, name):
    """(port, JAX) results of ``name`` with max_stalled_frac=1.0, computed
    once for the module."""
    cfg, jcfg, op, jop, solver, jsolver, cache = crippled
    if name not in cache:
        port_fn, jax_fn = ESTIMATORS[name]
        ref = jax_fn(jop, jcfg.replace(max_stalled_frac=1.0), solver=jsolver,
                     probe_source="numpy", verbose=False)
        res = port_fn(op, cfg.replace(max_stalled_frac=1.0), solver=solver,
                      probe_source="numpy", verbose=False)
        cache[name] = res, ref
    return cache[name]


@pytest.mark.parametrize("nstalled, nsamples, raises", [
    (0, 100, False),      # no stalls
    (5, 100, False),      # exactly at the threshold
    (3, 0, False),        # no samples yet
    (6, 100, True),
])
def test_check_stalled_threshold(nstalled, nsamples, raises):
    for fn in (check_stalled, jax_check_stalled):
        if raises:
            with pytest.raises(RuntimeError, match="stalled"):
                fn(nstalled, nsamples, 0.05, "x")
        else:
            fn(nstalled, nsamples, 0.05, "x")


@pytest.mark.parametrize("name", ["hutchinson", "mlmc"])
def test_default_policy_raises_in_the_jax_phase(crippled, name):
    """Under the default max_stalled_frac (0.05) both packages abort, and
    in the same phase: the message starts with the phase's name."""
    cfg, jcfg, op, jop, solver, jsolver, _ = crippled
    port_fn, jax_fn = ESTIMATORS[name]
    assert cfg.max_stalled_frac == jcfg.max_stalled_frac == 0.05
    with pytest.raises(RuntimeError, match="stalled") as ref:
        jax_fn(jop, jcfg, solver=jsolver, probe_source="numpy", verbose=False)
    with pytest.raises(RuntimeError, match="stalled") as res:
        port_fn(op, cfg, solver=solver, probe_source="numpy", verbose=False)
    phase = str(ref.value).split(":")[0]
    assert str(res.value).split(":")[0] == phase == f"{name} rough trace"


def test_relaxed_hutchinson_counts_match_jax(crippled):
    """With the policy relaxed the run finishes and reports every
    under-solved row, the rough batch's included (the JAX test's count)."""
    cfg = crippled[0]
    res, ref = relaxed_runs(crippled, "hutchinson")
    rough_rows = max(cfg.nr_rough_iters, cfg.probe_batch)
    assert res["nr_ests"] == ref["nr_ests"] == cfg.max_nr_ests
    assert res["function_iters"] == ref["function_iters"]
    assert res["stalled_rows"] == ref["stalled_rows"] == res["nr_ests"] + rough_rows
    assert abs(res["trace"] - ref["trace"]) <= 1e-8 * abs(ref["trace"])


def test_relaxed_mlmc_counts_match_jax(crippled):
    """Per level: samples, iterations and stalled rows equal, and every
    sampled row of a difference level stalled; the exact coarsest level
    stalls nothing."""
    res, ref = relaxed_runs(crippled, "mlmc")
    assert res["nr_levels"] == ref["nr_levels"] == 3
    for r, j in zip(res["results"], ref["results"]):
        assert r["nr_ests"] == j["nr_ests"]
        assert r["function_iters"] == j["function_iters"]
        assert r["stalled_rows"] == j["stalled_rows"]
    assert [r["stalled_rows"] for r in res["results"]] == [24, 24, 0]
    assert res["stalled_rows"] == ref["stalled_rows"] == 48
    assert abs(res["trace"] - ref["trace"]) <= 1e-8 * abs(ref["trace"])


@pytest.mark.parametrize("name", ["hutchinson", "mlmc"])
def test_host_loop_counts_stalls_as_device_loop(crippled, name, tmp_path):
    """A checkpointed run samples on the host loop (sample_to_stop_host);
    its stalled rows, samples and iterations equal the device loop's
    (sample_to_stop) and so the JAX package's."""
    cfg, _, op, _, solver, _, _ = crippled
    device_run, ref = relaxed_runs(crippled, name)
    host_run = ESTIMATORS[name][0](op, cfg.replace(max_stalled_frac=1.0), solver=solver,
                                   probe_source="numpy", verbose=False,
                                   checkpoint_dir=str(tmp_path))
    assert host_run["stalled_rows"] == device_run["stalled_rows"] == ref["stalled_rows"] > 0
    if name == "mlmc":
        host_run, device_run = host_run["results"], device_run["results"]
    else:
        host_run, device_run = [host_run], [device_run]
    for h, d in zip(host_run, device_run):
        assert h["nr_ests"] == d["nr_ests"]
        assert h["function_iters"] == d["function_iters"]
        assert h["stalled_rows"] == d["stalled_rows"]
