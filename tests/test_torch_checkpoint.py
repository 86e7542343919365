"""The port's checkpoints: hierarchy npz and estimator-state JSON in the JAX
package's formats, and resumed estimator runs.

  * a hierarchy saved by the port loads back bit-exactly, loads in the JAX
    package, and a JAX-saved one loads in the port (arrays, offsets, shifts
    and smoother roots equal);
  * ``EstimatorState`` crosses between the packages in both directions;
  * a Hutchinson run and an MLMC run (both schedules) cut by ``max_nr_ests``
    with a checkpoint directory and then resumed equal the uninterrupted run:
    same sample counts and iteration counts, trace to round-off. The probes
    are the counter-keyed ``"torch"`` source, which any start index may draw
    from (the numpy stream is sequential only).
"""

import importlib
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy as jax_setup  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace.stats import RunningMoments as JaxMoments  # noqa: E402
from deflatedmlmc_schwinger_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver, setup_hierarchy  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.stats import (  # noqa: E402
    RunningMoments,
    sample_to_stop_host,
)
from deflatedmlmc_schwinger_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

# the package's trace/__init__ exports the function mlmc under the module's name
mlmc = importlib.import_module("deflatedmlmc_schwinger_tpu_torch.trace.mlmc").mlmc

NT, NX = 16, 32
SMALL = dict(latt_dims=(NT, NX), aggrs=(16, 4), probe_batch=4,
             matrix=f"generated:{NX}x{NT}:beta=5.0:seed=3")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built():
    cfg = set_params("schwinger256").replace(
        dtype=torch.complex128, use_permuted=True, x_displacement=2, **SMALL)
    op = generate_operator(NX, NT, cfg.mass, beta=5.0, seed=3, device="cpu")
    return cfg, op, setup_hierarchy(op, cfg)


def _level_tensors(h):
    out = [h.coarsest_inv]
    for lev in h.levels:
        op = lev.op
        out.append(op.coeffs if hasattr(op, "coeffs") else
                   op.blocks if hasattr(op, "blocks") else op.mat)
        if lev.P is not None:
            out.append(lev.P.blocks)
    return out


def test_hierarchy_round_trip(built, tmp_path):
    _, _, h = built
    path = str(tmp_path / "hierarchy.npz")
    ckpt.save_hierarchy(h, path)
    h2 = ckpt.load_hierarchy(path, "cpu", torch.complex128)
    assert h2.sizes() == h.sizes()
    assert [l.perm_shift for l in h2.levels] == [l.perm_shift for l in h.levels]
    assert h2.levels[0].perm_shift == 2 * NT * 2
    assert h2.poly_roots == h.poly_roots and h2.poly_roots_extra == h.poly_roots_extra
    assert h2.levels[1].op.offsets == h.levels[1].op.offsets
    for a, b in zip(_level_tensors(h2), _level_tensors(h)):
        assert torch.equal(a, b)
    h32 = ckpt.load_hierarchy(path, "cpu", torch.complex64)
    assert h32.coarsest_inv.dtype == torch.complex64


def test_port_saved_hierarchy_loads_in_jax(built, tmp_path):
    _, _, h = built
    path = str(tmp_path / "hierarchy.npz")
    ckpt.save_hierarchy(h, path)
    jh = jax_ckpt.load_hierarchy(path, jnp.float64)
    assert jh.sizes() == h.sizes()
    assert [l.perm_shift for l in jh.levels] == [l.perm_shift for l in h.levels]
    assert jh.poly_roots == h.poly_roots
    np.testing.assert_array_equal(cplx.to_complex(jh.levels[0].op.coeffs),
                                  h.levels[0].op.coeffs.numpy())
    for i in range(1, h.nr_levels):
        np.testing.assert_array_equal(jh.levels[i].op.complex_matrix(),
                                      h.levels[i].op.complex_matrix())
    for i in range(h.nr_levels - 1):
        np.testing.assert_array_equal(cplx.to_complex(jh.levels[i].P.blocks),
                                      h.levels[i].P.blocks.numpy())
    np.testing.assert_array_equal(cplx.to_complex(jh.coarsest_inv), h.coarsest_inv.numpy())
    assert jh.levels[1].op.offsets == h.levels[1].op.offsets


def test_jax_saved_hierarchy_loads_in_port_and_back(tmp_path):
    """JAX-saved -> port-loaded -> port-saved: the two files hold the same
    arrays and the same metadata."""
    jcfg = jax_set_params("schwinger128").replace(
        dtype=jnp.complex128, latt_dims=(NT, NX), aggrs=(16, 4), dof=(2, 8, 8),
        max_nr_levels=3, chebyshev_degree=20, subspace_iters=2)
    jh = jax_setup(jax_gauge.generate_operator(NX, NT, -0.1, beta=5.0, seed=3), jcfg)
    assert jh.poly_roots_extra is not None      # depth 16 and depth 4
    p1, p2 = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ckpt.save_hierarchy(jh, p1)
    h = ckpt.load_hierarchy(p1, "cpu", torch.complex128)
    assert h.poly_roots == jh.poly_roots and h.poly_roots_extra == jh.poly_roots_extra
    ckpt.save_hierarchy(h, p2)
    with np.load(p1) as z1, np.load(p2) as z2:
        assert sorted(z1.files) == sorted(z2.files)
        assert json.loads(str(z1["__meta__"])) == json.loads(str(z2["__meta__"]))
        for k in z1.files:
            if k != "__meta__":
                np.testing.assert_array_equal(z1[k], z2[k])


def test_estimator_state_crosses_packages(tmp_path):
    m = RunningMoments()
    m.update_batch(np.asarray([1 + 2j, 3 - 1j, 0.5 + 0.5j]))
    path = str(tmp_path / "state.json")
    ckpt.EstimatorState(moments={"level0": m}, next_index={"level0": 24},
                        iters={"level0": 310, "level2": 7}).save(path)
    assert not os.path.exists(path + ".tmp")
    for mod in (ckpt, jax_ckpt):
        st = mod.EstimatorState.load(path)
        m2 = st.moments["level0"]
        assert (m2.count, m2.mean, m2.m2) == (m.count, m.mean, m.m2)
        assert st.next_index == {"level0": 24}
        assert st.iters == {"level0": 310, "level2": 7}
    jm = JaxMoments()
    jm.update_batch(np.asarray([2 - 1j, 0.25j]))
    jax_ckpt.EstimatorState(moments={"hutchinson": jm}, next_index={"hutchinson": 8},
                            iters={"hutchinson": 99}).save(path)
    st = ckpt.EstimatorState.load(path)
    assert isinstance(st.moments["hutchinson"], RunningMoments)
    assert (st.moments["hutchinson"].count, st.moments["hutchinson"].mean,
            st.moments["hutchinson"].m2) == (jm.count, jm.mean, jm.m2)
    assert st.next_index == {"hutchinson": 8} and st.iters == {"hutchinson": 99}
    empty = ckpt.EstimatorState.load_or_empty(str(tmp_path / "none.json"))
    assert empty.moments == {} and empty.next_index == {}


@pytest.mark.parametrize("check_before_batch", [False, True])
def test_host_loop_stops_like_the_rule(check_before_batch):
    """Constant estimates: the rule holds from min_nr_ests on, and with
    stop_confirm the loop takes one more batch."""
    cfg = set_params("schwinger256").replace(probe_batch=4, max_nr_ests=40, stop_confirm=True)
    seen = []
    moments = RunningMoments()
    end = sample_to_stop_host(lambda s: (np.full(4, 2.0 + 0j),), cfg, 1e-3, moments, 0,
                              lambda batch, nxt: seen.append(nxt), check_before_batch)
    assert seen == [4, 8, 12] and end == 12 and moments.count == 12


def test_hutchinson_resume_equals_uninterrupted(built, tmp_path):
    cfg, op, _ = built
    # the plain trace to 3%: the rule stops it after a few batches
    cfg = cfg.replace(max_nr_ests=24, use_permuted=False, x_displacement=0,
                      trace_tol=3e-2)
    ck, ck_whole = str(tmp_path / "ck"), str(tmp_path / "whole")
    r1 = hutchinson(op, cfg.replace(max_nr_ests=4), verbose=False, checkpoint_dir=ck)
    assert r1["nr_ests"] == 4
    assert os.path.exists(os.path.join(ck, "hierarchy.npz"))
    saved = ckpt.EstimatorState.load(os.path.join(ck, "hutchinson_state.json"))
    assert saved.next_index == {"hutchinson": 4}
    assert saved.iters["hutchinson"] == r1["function_iters"]
    assert jax_ckpt.EstimatorState.load(
        os.path.join(ck, "hutchinson_state.json")).moments["hutchinson"].count == 4
    r2 = hutchinson(op, cfg, verbose=False, checkpoint_dir=ck)       # resumed
    r3 = hutchinson(op, cfg, verbose=False, checkpoint_dir=ck_whole)  # uninterrupted
    assert 4 < r2["nr_ests"] == r3["nr_ests"] < 24       # the rule stopped both
    assert r2["function_iters"] == r3["function_iters"]
    assert abs(r2["trace"] - r3["trace"]) <= 1e-12 * abs(r3["trace"])
    assert r2["std_dev"] == pytest.approx(r3["std_dev"], rel=1e-10)
    # (total_complexity is not compared: as in the JAX package, the solver's
    # count of coarsest-level applications is kept per process, not saved)


def test_hutchinson_resume_equals_device_loop(built, tmp_path):
    """With the rule out of reach every loop runs to max_nr_ests: the
    checkpointed host loop, cut and resumed, equals the device-resident one."""
    cfg, op, h = built
    cfg = cfg.replace(max_nr_ests=16, trace_tol=1e-9)
    solver = MGSolver(h, cfg.solver)
    ck = str(tmp_path / "ck")
    hutchinson(op, cfg.replace(max_nr_ests=8), solver=solver, verbose=False,
               checkpoint_dir=ck)
    assert not os.path.exists(os.path.join(ck, "hierarchy.npz"))   # solver was given
    r2 = hutchinson(op, cfg, solver=solver, verbose=False, checkpoint_dir=ck)
    r3 = hutchinson(op, cfg, solver=solver, verbose=False)
    assert r2["nr_ests"] == r3["nr_ests"] == 16
    assert r2["function_iters"] == r3["function_iters"]
    assert abs(r2["trace"] - r3["trace"]) <= 1e-10 * abs(r3["trace"])


@pytest.mark.parametrize("schedule", ["sequential", "adaptive"])
def test_mlmc_resume_equals_uninterrupted(built, tmp_path, schedule):
    cfg, op, h = built
    cfg = cfg.replace(mlmc_levels_to_skip=(), mlmc_deflat_vctrs=(0, 0),
                      mlmc_schedule=schedule, max_nr_ests=8 if schedule == "adaptive" else 24)
    solver = MGSolver(h, cfg.solver)
    ck, ck_whole = str(tmp_path / "ck"), str(tmp_path / "whole")
    r1 = mlmc(op, cfg.replace(max_nr_ests=4), solver=solver, verbose=False,
              checkpoint_dir=ck)
    assert [r["nr_ests"] for r in r1["results"]] == [4, 4, 1]
    saved = ckpt.EstimatorState.load(os.path.join(ck, "mlmc_state.json"))
    assert saved.next_index == {"level0": 4, "level1": 4}
    assert saved.iters["level0"] == r1["results"][0]["function_iters"]
    r2 = mlmc(op, cfg, solver=solver, verbose=False, checkpoint_dir=ck)
    r3 = mlmc(op, cfg, solver=solver, verbose=False, checkpoint_dir=ck_whole)
    for a, b in zip(r2["results"], r3["results"]):
        assert a["nr_ests"] == b["nr_ests"]
        assert a["function_iters"] == b["function_iters"]
        assert abs(a["ests_avg"] - b["ests_avg"]) <= 1e-12 * max(abs(b["ests_avg"]), 1e-12)
    assert r2["results"][0]["nr_ests"] > 4
    assert abs(r2["trace"] - r3["trace"]) <= 1e-12 * abs(r3["trace"])
    if schedule == "sequential":
        # the device-resident loop reads its flags two batches late, so it may
        # only have sampled more; up to max_nr_ests the streams are the same
        r4 = mlmc(op, cfg, solver=solver, verbose=False)
        assert all(a["nr_ests"] >= b["nr_ests"] for a, b in zip(r4["results"], r3["results"]))
