"""The port's deflated Hutchinson slice end to end vs the JAX package:
a G301-shaped 3-level run (poly smoother, k = 0, numpy probe stream, capped
sample count) in complex128 on a non-square lattice, plus the probe
sources and the device moments it is built from."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace import hutchinson as jax_hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu.trace.probes import NumpyProbeStream as JaxStream  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.stats import (  # noqa: E402
    RunningMoments,
    device_moments_init,
    device_moments_to_host,
    device_moments_update,
)

NT, NX = 32, 64


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("use_permuted", [False, True])
def test_hutchinson_matches_jax(use_permuted):
    """(e) equal nr_ests and function_iters, trace to 1e-8 relative."""
    kw = dict(latt_dims=(NT, NX), aggrs=(16, 4), probe_batch=8, max_nr_ests=24,
              use_permuted=use_permuted, x_displacement=2 if use_permuted else 0,
              matrix=f"generated:{NX}x{NT}:beta=5.0:seed=8")
    cfg = set_params("schwinger256").replace(dtype=torch.complex128, **kw)
    jcfg = jax_set_params("schwinger256").replace(dtype=jnp.complex128, **kw)
    jop = jax_gauge.generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8)
    op = generate_operator(NX, NT, cfg.mass, beta=5.0, seed=8, device="cpu")
    ref = jax_hutchinson(jop, jcfg, probe_source="numpy", verbose=False)
    stencil_kernels.reset_launch_counts()
    res = hutchinson(op, cfg, probe_source="numpy", verbose=False)
    assert sum(stencil_kernels.launch_counts().values()) == 0
    assert res["nr_ests"] == ref["nr_ests"] == 24
    assert res["function_iters"] == ref["function_iters"]
    assert res["stalled_rows"] == ref["stalled_rows"] == 0
    assert abs(res["trace"] - ref["trace"]) <= 1e-8 * abs(ref["trace"])
    assert abs(res["rough_trace"] - ref["rough_trace"]) <= 1e-8 * abs(ref["rough_trace"])
    assert res["std_dev"] == pytest.approx(ref["std_dev"], rel=1e-8)
    assert res["total_complexity"] == ref["total_complexity"]
    assert set(res["timer"].totals) == {"mg_setup", "defl_setup", "rough_trace", "sampling"}


def test_numpy_probe_stream_matches_jax_and_is_sequential():
    ref = JaxStream(42)
    src = make_probe_source("numpy", 42, "cpu")
    a = src(0, 3, 50, torch.complex128).numpy()
    b = src(3, 2, 50, torch.complex128).numpy()
    np.testing.assert_array_equal(a, np.asarray(ref(3, 50, jnp.float64).re))
    np.testing.assert_array_equal(b, np.asarray(ref(2, 50, jnp.float64).re))
    with pytest.raises(ValueError, match="sequential"):
        src(0, 1, 50, torch.complex128)


def test_torch_probes_keyed_by_sample_index():
    """Probe s depends only on (seed, s): any batching gives the same
    probes, and they are Rademacher."""
    src = make_probe_source("torch", 7, "cpu")
    whole = src(0, 6, 40, torch.complex64)
    parts = torch.cat([src(0, 2, 40, torch.complex64), src(2, 4, 40, torch.complex64)])
    assert torch.equal(whole, parts)
    assert torch.equal(src(3, 1, 40, torch.complex64)[0], whole[3])
    assert set(whole.real.unique().tolist()) == {-1.0, 1.0}
    assert bool((whole.imag == 0).all())
    assert not torch.equal(whole, make_probe_source("torch", 8, "cpu")(0, 6, 40, torch.complex64))


def test_device_moments_match_running_moments():
    rng = np.random.default_rng(3)
    batches = [rng.standard_normal(5) + 1j * rng.standard_normal(5) for _ in range(4)]
    host = RunningMoments()
    dm = device_moments_init(torch.float64, "cpu")
    for es in batches:
        host.update_batch(es)
        dm = device_moments_update(dm, torch.from_numpy(es), torch.ones(5, dtype=torch.int32))
    got = device_moments_to_host(dm)
    assert got.count == host.count == 20
    assert abs(got.mean - host.mean) < 1e-14
    assert got.m2 == pytest.approx(host.m2, rel=1e-13)
    assert int(dm.iters.item()) == 20
