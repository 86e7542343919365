"""The 16^2 profile (``set_params("schwinger16")`` with function_tol 1e-12:
complex128, GMRES smoother, k = 64 deflation, MLMC with level 1 skipped and
16 deflation vectors per difference level) end to end against the JAX
package, on a generated 16 x 16 operator (``schwinger16.mat`` is not in the
repository) with the ``"numpy"`` probe stream and one shared start block for
the deflation eigensolver: G101 and G201 traces to 1e-8 with equal sample
counts, each within 5 of its own standard errors of the dense trace. Then
the gateway: G101 through its entry on a ``schwinger16.mat`` written from the
generated operator, the six entries, and what is rejected."""

import functools
import importlib
import json
import math

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import deflatedmlmc_schwinger_tpu.solvers.eigs as jax_eigs  # noqa: E402
from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace import hutchinson as jax_hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch import __main__ as cli  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch import gateway  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import csr_from_stencil, generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.solvers import eigs  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import deflation, hutchinson  # noqa: E402

jax_mlmc = importlib.import_module("deflatedmlmc_schwinger_tpu.trace.mlmc").mlmc
mlmc = importlib.import_module("deflatedmlmc_schwinger_tpu_torch.trace.mlmc").mlmc

# the generated stand-in for schwinger16.mat (PERF.md, section 4)
BETA, SEED, MASS = 5.0, 1, -0.29
GEN = dict(matrix=f"generated:16x16:beta={BETA}:seed={SEED}", mass=MASS, function_tol=1e-12)
SIGMAS = 5.0


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ops():
    jop = jax_gauge.generate_operator(16, 16, MASS, beta=BETA, seed=SEED)
    op = generate_operator(16, 16, MASS, beta=BETA, seed=SEED, device="cpu")
    D = csr_from_stencil(op.host_coeffs()).toarray()
    return jop, op, complex(np.trace(np.linalg.inv(D)))


def _shared_start_block(monkeypatch, n, m, seed=4):
    """Both packages' deflation eigensolvers draw their start block from
    their own device generator; give them one block."""
    rng = np.random.default_rng(seed)
    V0 = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    monkeypatch.setattr(jax_eigs, "inverse_iteration_smallest_device",
                        functools.partial(jax_eigs.inverse_iteration_smallest_device, V0=V0))
    monkeypatch.setattr(deflation, "inverse_iteration_smallest_device",
                        functools.partial(eigs.inverse_iteration_smallest_device, V0=V0))


def test_profile_is_the_jax_profile():
    cfg, jcfg = gateway.set_params("schwinger16"), jax_set_params("schwinger16")
    assert cfg.solver.smoother == jcfg.solver.smoother == "gmres"
    assert cfg.dtype == torch.complex128
    for f in ("mass", "latt_dims", "aggrs", "dof", "max_nr_levels", "nr_deflat_vctrs",
              "mlmc_deflat_vctrs", "mlmc_levels_to_skip", "test_vectors_type",
              "defl_eigvs_tol_Hutch", "probe_batch", "setup_backend", "use_permuted"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_g101_profile_matches_jax(ops, monkeypatch):
    jop, op, exact = ops
    cfg = gateway.set_params("schwinger16").replace(**GEN)
    jcfg = jax_set_params("schwinger16").replace(**GEN)
    _shared_start_block(monkeypatch, op.n, 80)
    ref = jax_hutchinson(jop, jcfg, probe_source="numpy", verbose=False)
    res = hutchinson(op, cfg, probe_source="numpy", verbose=False)
    assert res["nr_ests"] == ref["nr_ests"] >= 6
    assert res["function_iters"] == ref["function_iters"]
    assert res["stalled_rows"] == ref["stalled_rows"] == 0
    assert abs(res["trace"] - ref["trace"]) <= 1e-8 * abs(ref["trace"])
    assert abs(res["rough_trace"] - ref["rough_trace"]) <= 1e-8 * abs(ref["rough_trace"])
    stderr = res["std_dev"] / math.sqrt(res["nr_ests"])
    assert abs(res["trace"] - exact) <= SIGMAS * stderr
    assert len(res["deflation"].values) == 64


def test_g201_profile_matches_jax(ops, monkeypatch):
    jop, op, exact = ops
    cfg = gateway.set_params("schwinger16").replace(**GEN)
    jcfg = jax_set_params("schwinger16").replace(**GEN)
    _shared_start_block(monkeypatch, op.n, 80)
    ref = jax_mlmc(jop, jcfg, probe_source="numpy", verbose=False)
    res = mlmc(op, cfg, probe_source="numpy", verbose=False)
    assert res["nr_levels"] == ref["nr_levels"] == 3
    for r, j in zip(res["results"], ref["results"]):
        assert r["nr_ests"] == j["nr_ests"]
        assert abs(r["ests_avg"] - j["ests_avg"]) <= 1e-8 * max(abs(j["ests_avg"]), 1.0)
    assert [r["nr_ests"] for r in res["results"]][1:] == [0, 1]     # level 1 skipped
    assert abs(res["trace"] - ref["trace"]) <= 1e-8 * abs(ref["trace"])
    assert res["stalled_rows"] == 0
    assert abs(res["trace"] - exact) <= SIGMAS * res["std_dev"]


def test_g101_entry_on_a_written_mat_file(ops, tmp_path, monkeypatch, capsys):
    """gateway.G101 itself: the profile names schwinger16.mat, so one is
    written (gamma3 S, as the shipped file stores it) where the entry looks
    for it."""
    _, op, _ = ops
    A = sp.csr_matrix(csr_from_stencil(op.host_coeffs()))
    mass16 = gateway.set_params("schwinger16").mass
    S = A - MASS * sp.identity(op.n)            # the profile's own mass is added back
    S = S + (MASS - mass16) * sp.identity(op.n)
    sio.savemat(str(tmp_path / "schwinger16.mat"),
                {"S": sp.vstack([S[:256], -S[256:]]).tocsc()})
    monkeypatch.chdir(tmp_path)
    r = gateway.G101(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    exact = ops[2]
    stderr = r["std_dev"] / math.sqrt(r["nr_ests"])
    assert r["nr_ests"] >= 6 and r["stalled_rows"] == 0
    assert abs(r["trace"] - exact) <= SIGMAS * stderr
    assert json.loads(lines[-1])["example"] == "hutchinson"
    assert "Example 01" in "\n".join(lines)


def test_entries_and_rejections(monkeypatch):
    assert sorted(gateway.ENTRIES) == ["G101", "G102", "G201", "G202", "G301", "G302"]
    with pytest.raises(ValueError, match="unknown experiment"):
        gateway.set_params("no-such-experiment")
    with pytest.raises(SystemExit):
        cli.main(["G999"])
    # devices > 1 outside a process group: the entry starts that many ranks
    # itself and hands back rank 0's result
    from deflatedmlmc_schwinger_tpu_torch.parallel import worker

    started = {}
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(worker, "launch", lambda target, n, **kw: (
        started.update(target=target, n=n, **kw) or [{"rank": 0}, {"rank": 1}]))
    assert gateway.G302(device="cpu", devices=4) == {"rank": 0}
    assert started["n"] == 4 and started["args"] == ("G302", "cpu")
    assert started["target"].endswith("parallel.worker:run_entry")
    cli.main(["G302", "--device", "cpu", "--devices", "2"])
    assert started["n"] == 2 and started["device"] == "cpu"
    # one rank cannot cut the lattice in two: the one-device path runs
    monkeypatch.setenv("DMLMC_X_SHARDS", "2")
    seen = {}
    monkeypatch.setattr(gateway, "EXAMPLE_001",
                        lambda cfg, *, device: seen.update(cfg=cfg, device=device))
    gateway.G302(device="cpu")
    assert seen["cfg"] == gateway.set_params("schwinger512")
    with pytest.raises(SystemExit):
        cli.main(["G301", "--devices", "2"])


@pytest.mark.parametrize("entry,example,profile", [
    ("G101", "EXAMPLE_001", "schwinger16"), ("G201", "EXAMPLE_002", "schwinger16"),
    ("G302", "EXAMPLE_001", "schwinger512")])
def test_entry_runs_its_profile(monkeypatch, entry, example, profile):
    """Each new entry hands its example the JAX package's configuration and
    the device it was given."""
    seen = {}
    monkeypatch.setattr(gateway, example,
                        lambda cfg, *, device: seen.update(cfg=cfg, device=device))
    cli.main([entry, "--device", "cpu"])
    want = gateway.set_params(profile)
    if profile == "schwinger16":
        want = want.replace(function_tol=1e-12)
    assert seen["cfg"] == want and seen["device"] == "cpu"
    assert seen["cfg"].setup_backend == "host"
