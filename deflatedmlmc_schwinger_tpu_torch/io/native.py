"""ctypes bindings to the native host library (counterpart of
deflatedmlmc_schwinger_tpu/io/native.py; numpy, scipy and ctypes only).

The library, ``native/libdmlmc_native.so`` at the repository root (source
``native/matio.cpp``, built by ``make -C native``), holds a C++ MAT5 sparse
reader and complex CSR kernels: a host-side stand-in for scipy.io and
scipy.sparse when reading the shipped ``.mat`` matrices. When the library
has not been built, ``available()`` is False and io/matio.py reads with
scipy.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import scipy.sparse as sp

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libdmlmc_native.so"),
]

_lib = None


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            lib = ctypes.CDLL(p)
            lib.dmlmc_open.restype = ctypes.c_void_p
            lib.dmlmc_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.dmlmc_error.restype = ctypes.c_char_p
            lib.dmlmc_error.argtypes = [ctypes.c_void_p]
            for fn in ("dmlmc_rows", "dmlmc_cols", "dmlmc_nnz"):
                getattr(lib, fn).restype = ctypes.c_int64
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            lib.dmlmc_is_complex.restype = ctypes.c_int
            lib.dmlmc_is_complex.argtypes = [ctypes.c_void_p]
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.dmlmc_copy_csc.restype = None
            lib.dmlmc_copy_csc.argtypes = [ctypes.c_void_p, i64p, i64p, f64p, f64p]
            lib.dmlmc_close.restype = None
            lib.dmlmc_close.argtypes = [ctypes.c_void_p]
            lib.dmlmc_csc_to_csr.restype = None
            lib.dmlmc_csc_to_csr.argtypes = [
                ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p, f64p,
                i64p, i64p, f64p, f64p,
            ]
            lib.dmlmc_csr_matvec.restype = None
            lib.dmlmc_csr_matvec.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                i64p, i64p, f64p, f64p, f64p, f64p, f64p, f64p,
            ]
            _lib = lib
            return _lib
    return None


def available() -> bool:
    return load_library() is not None


def load_mat_sparse(path: str, varname: str = "S") -> sp.csc_matrix:
    """Read a sparse complex matrix from a MAT5 file via the C++ reader."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    h = lib.dmlmc_open(path.encode(), varname.encode())
    try:
        err = lib.dmlmc_error(h)
        if err:
            raise RuntimeError(f"native mat reader: {err.decode()}")
        m, n, nnz = lib.dmlmc_rows(h), lib.dmlmc_cols(h), lib.dmlmc_nnz(h)
        jc = np.empty(n + 1, np.int64)
        ir = np.empty(max(nnz, 1), np.int64)
        pr = np.empty(max(nnz, 1), np.float64)
        pi = np.empty(max(nnz, 1), np.float64)
        lib.dmlmc_copy_csc(h, jc, ir, pr, pi)
        data = pr[:nnz] + 1j * pi[:nnz]
        return sp.csc_matrix((data, ir[:nnz], jc), shape=(m, n))
    finally:
        lib.dmlmc_close(h)


class NativeCSR:
    """Complex CSR matrix with native multi-RHS SpMV (host oracle kernels)."""

    def __init__(self, A: sp.spmatrix):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library not built (make -C native)")
        self._lib = lib
        csc = sp.csc_matrix(A, dtype=np.complex128)
        m, n = csc.shape
        jc = csc.indptr.astype(np.int64)
        ir = csc.indices.astype(np.int64)
        pr = np.ascontiguousarray(csc.data.real)
        pi = np.ascontiguousarray(csc.data.imag)
        nnz = jc[-1]
        self.m, self.n, self.nnz = m, n, int(nnz)
        self.rowptr = np.empty(m + 1, np.int64)
        self.col = np.empty(max(nnz, 1), np.int64)
        self.vr = np.empty(max(nnz, 1), np.float64)
        self.vi = np.empty(max(nnz, 1), np.float64)
        lib.dmlmc_csc_to_csr(m, n, jc, ir, pr, pi,
                             self.rowptr, self.col, self.vr, self.vi)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A x for x of shape (n,) or (B, n) complex."""
        single = x.ndim == 1
        xb = np.atleast_2d(np.asarray(x, np.complex128))
        B = xb.shape[0]
        xr = np.ascontiguousarray(xb.real)
        xi = np.ascontiguousarray(xb.imag)
        yr = np.empty((B, self.m), np.float64)
        yi = np.empty((B, self.m), np.float64)
        self._lib.dmlmc_csr_matvec(
            self.m, self.n, B, self.rowptr, self.col, self.vr, self.vi,
            xr, xi, yr, yi,
        )
        y = yr + 1j * yi
        return y[0] if single else y
