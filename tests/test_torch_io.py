"""Port operator and I/O layer vs the JAX package: generated coefficients
bit for bit, the CSR round trip, the 'generated:' spec, the gateway
configurations field by field, and the port's independence from jax."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deflatedmlmc_schwinger_tpu.gateway import set_params as jax_set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.io.stencil import (  # noqa: E402
    csr_from_stencil as jax_csr_from_stencil,
)
from deflatedmlmc_schwinger_tpu_torch.gateway import set_params  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import (  # noqa: E402
    csr_from_stencil,
    generate_operator,
    load_operator,
    stencil_from_csr,
)
from deflatedmlmc_schwinger_tpu_torch.io.gauge import sample_links  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import (  # noqa: E402
    gamma3,
    shift_rows_down,
    shift_rows_up,
    stencil_matvec_host,
)

PORT_DIR = Path(__file__).resolve().parent.parent / "deflatedmlmc_schwinger_tpu_torch"


@pytest.mark.parametrize("nx,nt,beta,seed", [(12, 20, 5.0, 3), (32, 16, 2.0, 8)])
def test_generated_coefficients_bit_identical(nx, nt, beta, seed):
    """(a) the same seed gives the same (2,2,5,X,T) coefficients, bit for bit."""
    mass = -0.1
    ref = np.asarray(jax_gauge.generate_operator(nx, nt, mass, beta=beta, seed=seed).coeffs)
    op = generate_operator(nx, nt, mass, beta=beta, seed=seed, device="cpu")
    assert op.coeffs.dtype == torch.complex128
    assert tuple(op.coeffs.shape) == (2, 2, 5, nx, nt)
    np.testing.assert_array_equal(op.host_coeffs(), ref)
    tt, tx = sample_links(nx, nt, beta, seed)
    jt, jx = jax_gauge.sample_links(nx, nt, beta, seed)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tx, jx)


def test_csr_round_trip_and_matvec():
    """CSR extraction and its inverse agree with the JAX package's, and the
    operator's matvec (plain K1 on the CPU) equals the CSR product on a
    non-square lattice."""
    op = generate_operator(10, 14, -0.2, beta=3.0, seed=1, device="cpu")
    C = op.host_coeffs()
    A = csr_from_stencil(C)
    assert abs(A - jax_csr_from_stencil(C)).max() == 0
    np.testing.assert_array_equal(stencil_from_csr(A, nt=14, nx=10), C)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((3, op.n)) + 1j * rng.standard_normal((3, op.n))
    y = op.matvec(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(y, (A @ z.T).T, atol=1e-12)
    np.testing.assert_allclose(stencil_matvec_host(C, z, 10, 14), y, atol=1e-12)


def test_load_operator_generated_spec():
    op, A = load_operator("generated:12x8:beta=4.0:seed=5", -0.3, device="cpu",
                          dtype=torch.complex64)
    assert A is None
    assert (op.nx, op.nt, op.dtype) == (12, 8, torch.complex64)
    ref = jax_gauge.generate_operator(12, 8, -0.3, beta=4.0, seed=5).coeffs
    np.testing.assert_array_equal(op.host_coeffs(), np.asarray(ref).astype(np.complex64))
    with pytest.raises(ValueError):
        load_operator("generated:12x8:gamma=1", -0.3, device="cpu")


def test_load_operator_mat_file(tmp_path):
    """A .mat file (key 'S', D = S + m I) loads to the same coefficients
    as the operator it was written from, in both packages."""
    import scipy.io as sio
    import scipy.sparse as sp

    from deflatedmlmc_schwinger_tpu.io import load_operator as jax_load_operator

    mass = -0.25
    C = jax_gauge.stencil_from_links(*jax_gauge.sample_links(8, 8, 4.0, 2), mass)
    A = jax_csr_from_stencil(C)
    path = str(tmp_path / "lattice8.mat")
    sio.savemat(path, {"S": (A - mass * sp.identity(A.shape[0])).tocsc()})
    op, A_port = load_operator(path, mass, latt_dims=(8, 8), device="cpu")
    jop, _ = jax_load_operator(path, mass, latt_dims=(8, 8))
    np.testing.assert_allclose(op.host_coeffs(), C, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(op.host_coeffs(), np.asarray(jop.coeffs))
    assert abs(A_port - A).max() < 1e-14


def test_generated_32_dense_trace_matches_pinned_oracle():
    """The port's generator reproduces the JAX package's pinned 32^2 dense
    trace (tests/test_generated_oracle.py EXACT32)."""
    op = generate_operator(32, 32, -0.22, beta=5.0, seed=11, device="cpu")
    A = csr_from_stencil(op.host_coeffs()).toarray()
    tr = np.trace(np.linalg.inv(A))
    assert abs(tr.real - 355.550621261975) < 1e-6
    assert abs(tr.imag) < 1e-6


def test_gamma3_and_shifts():
    from deflatedmlmc_schwinger_tpu.ops import dirac as jdirac

    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 24)) + 1j * rng.standard_normal((2, 24))
    t = torch.from_numpy(z)
    np.testing.assert_array_equal(gamma3(t).numpy(), np.asarray(jdirac.gamma3(jnp.asarray(z))))
    np.testing.assert_array_equal(shift_rows_up(t, 5).numpy(),
                                  np.asarray(jdirac.shift_rows_up(jnp.asarray(z), 5)))
    np.testing.assert_array_equal(shift_rows_down(t, 5).numpy(),
                                  np.asarray(jdirac.shift_rows_down(jnp.asarray(z), 5)))


_DTYPES = {torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}


def _same(port_val, jax_val) -> bool:
    if isinstance(port_val, torch.dtype):
        return jnp.dtype(_DTYPES[port_val]) == jnp.dtype(jax_val)
    if dataclasses.is_dataclass(port_val):
        return all(_same(getattr(port_val, f.name), getattr(jax_val, f.name))
                   for f in dataclasses.fields(port_val))
    if isinstance(port_val, tuple):
        return tuple(port_val) == tuple(jax_val)
    return port_val == jax_val


@pytest.mark.parametrize("name", ["schwinger16", "schwinger128", "schwinger128-parity",
                                  "schwinger256", "schwinger512"])
def test_set_params_field_by_field(name):
    """(f) every configuration equals the JAX package's, field by field (a
    None dtype there is its x64 default, complex128)."""
    port = set_params(name)
    ref = jax_set_params(name)
    port_fields = {f.name for f in dataclasses.fields(port)}
    assert port_fields == {f.name for f in dataclasses.fields(ref)}
    for f in sorted(port_fields):
        jv = ref.complex_dtype() if f == "dtype" else getattr(ref, f)
        assert _same(getattr(port, f), jv), (name, f, getattr(port, f), jv)


def test_port_never_imports_jax():
    """(g) no module of the port imports jax, or the JAX package (which
    imports jax itself)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|deflatedmlmc_schwinger_tpu)(\.|\s|$)",
                     re.MULTILINE)
    files = sorted(PORT_DIR.rglob("*.py"))
    assert files
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert offenders == []
