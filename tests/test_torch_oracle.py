"""The port's estimators against the dense oracle of the generated 32^2
lattice (mirroring tests/test_generated_oracle.py): deflated Hutchinson
within 5 stderr of EXACT32, deflated MLMC within 5 x trace_tol.

The configuration is gen_cfg32 of that file with the port's polynomial
smoother (the GMRES smoother waits for its slice) and the flagship's loose
deflation basis (3 inverse-iteration rounds at 1e-2): tr1 is exact for any
basis, so only the variance depends on it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig, TraceConfig  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson, mlmc  # noqa: E402

EXACT32 = 355.550621261975     # tests/test_generated_oracle.py


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def gen32():
    op = generate_operator(32, 32, -0.22, beta=5.0, seed=11, device="cpu")
    cfg = TraceConfig(
        matrix="<generated>", mass=-0.22, latt_dims=(32, 32), max_nr_levels=3,
        aggrs=(4, 4), dof=(2, 4, 4), accuracy_mg_eigvs="low", test_vectors_type="RSVs",
        use_permuted=False, trace_tol=1e-2, nr_deflat_vctrs=24, mlmc_deflat_vctrs=(8, 8),
        defl_type="exact", chebyshev_degree=50, subspace_iters=4, probe_batch=8,
        mlmc_levels_to_skip=(), solver=SolverConfig(smoother="poly"),
        defl_eigvs_tol_Hutch=1e-2, defl_subspace_rounds=3)
    return op, cfg


def test_generated_32_hutchinson_vs_oracle(gen32):
    op, cfg = gen32
    r = hutchinson(op, cfg, verbose=False)
    stderr = max(r["std_dev"] / np.sqrt(r["nr_ests"]), 1e-12)
    assert abs(r["trace"] - EXACT32) < 5 * stderr + 1e-6, (r["trace"], stderr)


def test_generated_32_mlmc_vs_oracle(gen32):
    op, cfg = gen32
    r = mlmc(op, cfg, verbose=False)
    assert [x["nr_ests"] > 1 for x in r["results"]] == [True, True, False]
    assert abs(r["trace"] - EXACT32) < 5 * abs(cfg.trace_tol * EXACT32), r["trace"]
