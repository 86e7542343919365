"""The port's MLMC layer vs the JAX package, complex128, on the permuted
flagship-shaped 4-level hierarchy (generated non-square 32x64 lattice,
4096 -> 1024 -> 256 -> 64, displaced trace with x_displacement 2):

  * the building blocks: BlockProlongator.to_dense, bblock_apply,
    bblock_matrix(_host), dense_level_inverse, exact_difference_trace,
    make_diff_op and make_diff_op_Q, to 1e-10;
  * mlmc_step_batch on a basis carried over from the JAX package;
  * mlmc_level_deflation for the 'exact', 'inexact_01' and 'inexact_03'
    deflation types ('inexact_02' raises in both);
  * full MLMC runs in the 128^2 profile's pattern (level 1 skipped, level 2
    dense-exact, fine-level deflation with k = 16 from one start block,
    numpy probe streams) under both schedules, and one with every coarse
    solve iterative: equal per-level counts, traces to 1e-8 relative;
  * the "mlmc" report and the EXAMPLE_002 entry on a generated lattice.
"""

import functools
import importlib
import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import deflatedmlmc_schwinger_tpu.solvers.eigs as jax_eigs  # noqa: E402
from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import MGSolver as JaxMGSolver  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import diff_op as jax_diff_op  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy as jax_setup  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.reporting import result_to_json as jax_result_to_json  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace import deflation as jax_defl  # noqa: E402
from deflatedmlmc_schwinger_tpu.utils.checkpoint import (  # noqa: E402
    save_hierarchy as jax_save_hierarchy,
)
from deflatedmlmc_schwinger_tpu_torch import examples, gateway  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, diff_op  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.reporting import result_to_json  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.solvers import eigs  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import deflation  # noqa: E402

# the packages' trace/__init__ export the function mlmc under the module's name
jax_mlmc_mod = importlib.import_module("deflatedmlmc_schwinger_tpu.trace.mlmc")
mlmc_mod = importlib.import_module("deflatedmlmc_schwinger_tpu_torch.trace.mlmc")

NT, NX = 32, 64
MASS, BETA, SEED = -0.15, 5.0, 11
K = 16
SMALL = dict(latt_dims=(NT, NX), aggrs=(16, 4, 4), mass=MASS, probe_batch=8,
             nr_deflat_vctrs=K, defl_buffer=K, mlmc_exact_dense_max_n=256,
             matrix=f"generated:{NX}x{NT}:beta={BETA}:seed={SEED}")


def flagship_cfgs(**kw):
    """The schwinger128 profile of both packages, cut to the small lattice
    with level 2 (n = 256) dense-exact."""
    port = set_params("schwinger128").replace(dtype=torch.complex128, **SMALL, **kw)
    ref = jax_set_params("schwinger128").replace(dtype=jnp.complex128, **SMALL, **kw)
    return port, ref


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import load_hierarchy

    cfg, jcfg = flagship_cfgs()
    jop = jax_gauge.generate_operator(NX, NT, MASS, beta=BETA, seed=SEED)
    op = generate_operator(NX, NT, MASS, beta=BETA, seed=SEED, device="cpu")
    jh = jax_setup(jop, jcfg)
    path = tmp_path_factory.mktemp("hier") / "hierarchy.npz"
    jax_save_hierarchy(jh, str(path))
    th = load_hierarchy(str(path), "cpu", torch.complex128)
    assert th.sizes() == (4096, 1024, 256, 64)
    assert [lev.perm_shift for lev in th.levels] == [lev.perm_shift for lev in jh.levels]
    assert th.levels[0].perm_shift == 2 * NT * 2
    return cfg, jcfg, jop, op, jh, th


@pytest.fixture(scope="module")
def solvers(built):
    cfg, jcfg, _, _, jh, th = built
    return MGSolver(th, cfg.solver), JaxMGSolver(jh, jcfg.solver)


def randc(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_building_blocks_match_jax(built):
    _, _, _, _, jh, th = built
    rng = np.random.default_rng(1)
    for l in range(3):
        assert rel(th.levels[l].P.to_dense(), jh.levels[l].P.to_dense()) < 1e-15
    for l in (1, 2, 3):
        v = randc(rng, 2, th.sizes()[l])
        got = mlmc_mod.bblock_apply(th, l, torch.from_numpy(v)).numpy()
        assert rel(got, cplx.to_complex(jax_mlmc_mod.bblock_apply(jh, l, cplx.from_complex(v)))) < 1e-12
    for l in (2, 3):
        Bh = mlmc_mod.bblock_matrix_host(th, l)
        assert rel(Bh, jax_mlmc_mod.bblock_matrix_host(jh, l)) < 1e-14
        assert rel(mlmc_mod.bblock_matrix(th, l), Bh) < 1e-12
    for l in (1, 2, 3):
        assert rel(mlmc_mod.dense_level_inverse(th, l),
                   jax_mlmc_mod.dense_level_inverse(jh, l)) < 1e-10


@pytest.mark.parametrize("level,skip", [(1, False), (2, True), (2, False)])
@pytest.mark.parametrize("use_permuted", [False, True])
def test_exact_difference_trace_matches_jax(built, level, skip, use_permuted):
    _, _, _, _, jh, th = built
    got = mlmc_mod.exact_difference_trace(th, level, skip, use_permuted)
    ref = jax_mlmc_mod.exact_difference_trace(jh, level, skip, use_permuted)
    assert abs(got - ref) <= 1e-10 * abs(ref)


@pytest.mark.parametrize("level,skip", [(0, True), (1, False), (2, True)])
def test_diff_ops_match_jax(built, solvers, level, skip):
    """f_l and f_l o gamma3, including the composite skip-level-1 form."""
    _, _, _, _, jh, th = built
    rng = np.random.default_rng(40 + level)
    v = randc(rng, 8, th.sizes()[level])       # the sampling batch shape
    assert (diff_op.level_structure(solvers[0], level, skip)[:2]
            == jax_diff_op.level_structure(solvers[1], level, skip)[:2])
    for port_fn, jax_fn in ((diff_op.make_diff_op, jax_diff_op.make_diff_op),
                            (diff_op.make_diff_op_Q, jax_diff_op.make_diff_op_Q)):
        got = port_fn(solvers[0], level, 1e-8, skip)(torch.from_numpy(v)).numpy()
        ref = cplx.to_complex(jax_fn(solvers[1], level, 1e-8, skip)(cplx.from_complex(v)))
        assert rel(got, ref) < 1e-8


@pytest.mark.parametrize("level,dense", [(0, True), (2, False)])
def test_mlmc_step_batch_on_carried_basis(built, solvers, level, dense):
    """The JAX package's Deflation carried over; level 0 with the dense
    level-2 inverse as its coarse apply, level 2 against the coarsest."""
    cfg, jcfg, _, _, jh, th = built
    rng = np.random.default_rng(50 + level)
    n = th.sizes()[level]
    U, _ = np.linalg.qr(randc(rng, n, 4))
    jd = jax_defl.Deflation(U=cplx.from_complex(U), tr1=0.5 + 0.5j)
    d = deflation.Deflation.from_numpy(cplx.to_complex(jd.U), jd.tr1, device="cpu",
                                       dtype=torch.complex128)
    X = np.sign(rng.standard_normal((8, n))) + 0j
    jcdi = tcdi = None
    if dense:
        inv = mlmc_mod.dense_level_inverse(th, 2)
        jcdi, tcdi = cplx.from_complex(inv), torch.from_numpy(inv)
    got = mlmc_mod.mlmc_step_batch(solvers[0], cfg, level, d, torch.from_numpy(X), True,
                                   coarse_dense_inv=tcdi)
    ref = jax_mlmc_mod.mlmc_step_batch(solvers[1], jcfg, level, jd, cplx.from_complex(X), True,
                                       coarse_dense_inv=jcdi)
    assert rel(got[0], np.asarray(ref[0])) < 1e-9
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("defl_type", ["exact", "inexact_01", "inexact_03", "inexact_02"])
def test_mlmc_level_deflation_matches_jax(built, solvers, defl_type):
    cfg, jcfg, _, _, _, _ = built
    cfg, jcfg = (c.replace(defl_type=defl_type) for c in (cfg, jcfg))
    if defl_type == "inexact_02":
        with pytest.raises(NotImplementedError):
            deflation.mlmc_level_deflation(solvers[0], 1, 4, cfg, True, rounds=3)
        return
    got = deflation.mlmc_level_deflation(solvers[0], 1, 4, cfg, True, rounds=3)
    ref = jax_defl.mlmc_level_deflation(solvers[1], 1, 4, jcfg, True, rounds=3)
    assert rel(got.values, ref.values) < 1e-9
    assert abs(got.tr1 - ref.tr1) <= 1e-8 * max(abs(ref.tr1), 1e-12)
    X = randc(np.random.default_rng(3), th_n := got.U.shape[0], 2)
    Uj = cplx.to_complex(ref.U)
    assert th_n == Uj.shape[0]
    assert rel(got.U.numpy() @ (got.U.numpy().conj().T @ X), Uj @ (Uj.conj().T @ X)) < 1e-8
    if defl_type == "inexact_03":
        # (U^H A V)^{-1} depends on the basis phases: check it inverts the
        # port's own projection instead
        AV = eigs._apply_cols(solvers[0].matvec(1), got.U.numpy(), torch.complex128, "cpu")
        small = got.aux_V.numpy().conj().T @ AV
        assert rel(got.proj_B.numpy() @ small, np.eye(4)) < 1e-10


def _patched_v0(monkeypatch, n, m, seed=4):
    rng = np.random.default_rng(seed)
    V0 = randc(rng, n, m)
    monkeypatch.setattr(jax_eigs, "inverse_iteration_smallest_device",
                        functools.partial(jax_eigs.inverse_iteration_smallest_device, V0=V0))
    monkeypatch.setattr(deflation, "inverse_iteration_smallest_device",
                        functools.partial(eigs.inverse_iteration_smallest_device, V0=V0))


def _compare_runs(res, ref):
    assert res["nr_levels"] == ref["nr_levels"] == 4
    for r, j in zip(res["results"], ref["results"]):
        assert r["nr_ests"] == j["nr_ests"]
        assert r["function_iters"] == j["function_iters"]
        assert r["stalled_rows"] == j["stalled_rows"] == 0
        assert abs(r["ests_avg"] - j["ests_avg"]) <= 1e-8 * max(abs(j["ests_avg"]), 1e-12)
        assert r["ests_dev"] == pytest.approx(j["ests_dev"], rel=1e-8, abs=1e-12)
    assert abs(res["rough_trace"] - ref["rough_trace"]) <= 1e-8 * abs(ref["rough_trace"])
    assert abs(res["trace"] - ref["trace"]) <= 1e-8 * abs(ref["trace"])
    assert res["std_dev"] == pytest.approx(ref["std_dev"], rel=1e-8)


@pytest.mark.parametrize("schedule", ["sequential", "adaptive"])
def test_mlmc_flagship_pattern_matches_jax(built, solvers, monkeypatch, schedule):
    """Level 1 skipped, level 2 dense-exact, fine deflation k = 16."""
    cfg, jcfg, jop, op, jh, th = built
    cfg, jcfg = (c.replace(mlmc_schedule=schedule, max_nr_ests=16) for c in (cfg, jcfg))
    _patched_v0(monkeypatch, op.n, K)
    ref = jax_mlmc_mod.mlmc(jop, jcfg, solver=solvers[1], probe_source="numpy", verbose=False)
    stencil_kernels.reset_launch_counts()
    res = mlmc_mod.mlmc(op, cfg, solver=solvers[0], probe_source="numpy", verbose=False)
    assert sum(stencil_kernels.launch_counts().values()) == 0
    _compare_runs(res, ref)
    assert [r["nr_ests"] for r in res["results"]][1:] == [0, 1, 1]
    assert set(res["timer"].totals) == {"dense_setup", "defl_setup", "rough_trace",
                                         "exact_levels", "sampling", "coarsest"}
    # the dense-exact level 2 is charged its own 256^3 inverse only: the
    # coarsest inverse is charged once, on the coarsest level
    assert res["results"][2]["level_complexity"] == 256.0 ** 3
    assert ref["results"][2]["level_complexity"] == 256.0 ** 3 + 64.0 ** 3
    out = json.loads(result_to_json(cfg, res, "mlmc"))
    assert set(out) == (set(json.loads(jax_result_to_json(jcfg, ref, "mlmc")))
                        | {"std_dev", "host_read_seconds"})
    assert set(out["host_read_seconds"]) == set(out["phase_seconds"])
    assert out["host_read_seconds"]["sampling"] > 0     # the sampling loop's reads


def test_mlmc_iterative_coarse_solves_match_jax(built, solvers, monkeypatch):
    """mlmc_exact_dense_max_n = 0: level 0's coarse solve runs at level 2,
    and level 2 is sampled against the coarsest."""
    cfg, jcfg, jop, op, jh, th = built
    cfg, jcfg = (c.replace(mlmc_exact_dense_max_n=0, max_nr_ests=16) for c in (cfg, jcfg))
    _patched_v0(monkeypatch, op.n, K)
    ref = jax_mlmc_mod.mlmc(jop, jcfg, solver=solvers[1], probe_source="numpy", verbose=False)
    res = mlmc_mod.mlmc(op, cfg, solver=solvers[0], probe_source="numpy", verbose=False)
    _compare_runs(res, ref)
    assert res["results"][2]["nr_ests"] > 1 and res["results"][2]["function_iters"] > 0


def test_example_002_and_gateway_entries(capsys):
    assert {"G102", "G202", "G301"} <= set(gateway.ENTRIES)
    cfg = set_params("schwinger128").replace(
        latt_dims=(16, 32), aggrs=(16, 4), dof=(2, 8, 8), max_nr_levels=3,
        mlmc_exact_dense_max_n=0, mlmc_levels_to_skip=(), nr_deflat_vctrs=8,
        defl_buffer=8, probe_batch=8, max_nr_ests=16, dtype=torch.complex128,
        matrix="generated:32x16:beta=5.0:seed=3", mass=-0.3)
    r = examples.EXAMPLE_002(cfg, device="cpu")
    assert np.isfinite(complex(r["trace"]))
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["example"] == "mlmc"
    assert "Example 02" in "\n".join(lines)
