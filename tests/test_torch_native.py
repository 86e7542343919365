"""The port's copy of the native MAT5 reader (io/native.py over
native/libdmlmc_native.so) and its wiring into io/matio.py: a generated
16 x 16 Schwinger matrix written as 'S' with scipy.io.savemat, compressed and
not, is read bit-exactly, as the JAX package's reader and scipy read it; a
missing variable raises; NativeCSR.matvec agrees with scipy to 1e-14; and
load_matrix/load_operator give the same operator with and without the native
reader, including the gamma3 fix keyed on the file name schwinger16.mat."""

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deflatedmlmc_schwinger_tpu.io import matio as jax_matio  # noqa: E402
from deflatedmlmc_schwinger_tpu.io import native as jax_native  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import (  # noqa: E402
    csr_from_stencil,
    generate_operator,
    load_operator,
    matio,
    native,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built (make -C native)")

MASS = -0.29


@pytest.fixture(scope="module")
def S():
    """The massless generated 16 x 16 operator as a complex CSC matrix."""
    op = generate_operator(16, 16, 0.0, beta=5.0, seed=1, device="cpu")
    return sp.csc_matrix(csr_from_stencil(op.host_coeffs()))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "compressed"])
def mat_path(request, S, tmp_path_factory):
    path = tmp_path_factory.mktemp("mat") / "generated16.mat"
    sio.savemat(str(path), {"S": S, "other": np.arange(3.0)},
                do_compression=request.param)
    return str(path)


def test_reader_bit_exact(mat_path, S):
    got = native.load_mat_sparse(mat_path, "S")
    ref = sio.loadmat(mat_path)["S"].tocsc()
    assert got.shape == ref.shape == (512, 512)
    assert got.nnz == ref.nnz == S.nnz
    assert abs(got - ref).max() == 0.0
    assert abs(got - S).max() == 0.0
    theirs = jax_native.load_mat_sparse(mat_path, "S")
    assert abs(got - theirs).max() == 0.0


def test_reader_missing_variable(mat_path):
    with pytest.raises(RuntimeError, match="not found"):
        native.load_mat_sparse(mat_path, "NOPE")


def test_native_csr_matvec(S):
    A = sp.csr_matrix(S)
    csr = native.NativeCSR(A)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 512)) + 1j * rng.standard_normal((4, 512))
    np.testing.assert_allclose(csr.matvec(x), (A @ x.T).T, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(csr.matvec(x[0]), A @ x[0], rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(csr.matvec(x), jax_native.NativeCSR(A).matvec(x))


@pytest.mark.parametrize("native_io", ["1", "0"])
def test_load_matrix_with_and_without_native(mat_path, S, monkeypatch, native_io):
    monkeypatch.setenv("DMLMC_NATIVE_IO", native_io)
    A = matio.load_matrix(mat_path, MASS)
    assert abs(A - (S + MASS * sp.identity(512))).max() == 0.0
    assert abs(A - jax_matio.load_matrix(mat_path, MASS)).max() == 0.0
    op, A2 = load_operator(mat_path, MASS, device="cpu")
    ref = generate_operator(16, 16, MASS, beta=5.0, seed=1, device="cpu")
    assert op.dtype == torch.complex128 and (op.nx, op.nt) == (16, 16)
    np.testing.assert_allclose(op.coeffs.numpy(), ref.coeffs.numpy(), rtol=0, atol=1e-15)


def test_schwinger16_name_gets_gamma3(S, tmp_path):
    """The shipped schwinger16.mat stores gamma3 S: a file of that name has
    the lower half of its rows negated on loading, in both packages."""
    path = str(tmp_path / "schwinger16.mat")
    g3S = sp.vstack([S.tocsr()[:256], -S.tocsr()[256:]]).tocsc()
    sio.savemat(path, {"S": g3S})
    A = matio.load_matrix(path, MASS)
    assert abs(A - (S + MASS * sp.identity(512))).max() == 0.0
    assert abs(A - jax_matio.load_matrix(path, MASS)).max() == 0.0


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        matio.load_matrix(str(tmp_path / "absent.mat"), MASS)
