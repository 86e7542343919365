"""Fine-level stencil kernels K1-K3 (CUDA C++, ``csrc/stencil.cu``), their
plain PyTorch versions, launch counters, and the build-and-load code.

Counterpart of ``deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py``:

  * K1 ``stencil_matvec``      y = D v
  * K2 ``stencil_residual``    r = b - D x, one pass
  * K3 ``stencil_poly_smooth`` x = p(D) r through the residual recurrence
    step_k = cur_k / theta_k, x += step_k, cur_{k+1} = cur_k - D step_k

The public functions take complex tensors: coefficients of shape
(2, 2, 5, X, T) and vectors of shape (..., 2*X*T). A CUDA tensor launches
the kernel (or raises); a CPU tensor takes the plain version. There is no
fallback from one to the other.

Build: the first launch compiles ``csrc/*.cu`` with ``nvcc`` for sm_90a into
a shared library with a plain C interface, under ``_build/<source hash>/``
beside this package's sources, and loads it with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

# (dx, dt) offsets; tap 0 is the on-site term (ops/dirac.py TAPS).
TAPS: Tuple[Tuple[int, int], ...] = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
_BUILD_ROOT = _PKG_DIR / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")
_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# ---- plain PyTorch versions --------------------------------------------------

def stencil_matvec_plain(coeffs: torch.Tensor, v: torch.Tensor, nx: int,
                         nt: int) -> torch.Tensor:
    """y[s,x,t] = sum_{s',k} C[s,s',k,x,t] v[s',(x+dx_k)%X,(t+dt_k)%T] with
    torch.roll (out[i] = v[(i+d) % n])."""
    g = v.reshape(v.shape[:-1] + (2, nx, nt))
    out = torch.zeros_like(g)
    for k, (dx, dt) in enumerate(TAPS):
        s = g
        if dx:
            s = torch.roll(s, shifts=-dx, dims=-2)
        if dt:
            s = torch.roll(s, shifts=-dt, dims=-1)
        for a in range(2):
            if k == 0:
                out[..., a, :, :] += coeffs[a, a, 0] * s[..., a, :, :]
            else:
                out[..., a, :, :] += (coeffs[a, 0, k] * s[..., 0, :, :]
                                      + coeffs[a, 1, k] * s[..., 1, :, :])
    return out.reshape(v.shape)


def stencil_residual_plain(coeffs: torch.Tensor, b: torch.Tensor,
                           x: torch.Tensor, nx: int, nt: int) -> torch.Tensor:
    return b - stencil_matvec_plain(coeffs, x, nx, nt)


def stencil_poly_smooth_plain(coeffs: torch.Tensor, r: torch.Tensor,
                              roots: Sequence[complex], nx: int, nt: int,
                              with_residual: bool = False):
    """The recurrence of mg/cycle.py poly_smoother on the plain matvec:
    D is applied m times with ``with_residual`` (returns (x, r - D x)),
    m - 1 times otherwise (returns (x, None))."""
    x = None
    cur = r
    for k, th in enumerate(roots):
        step = cur * (1.0 / complex(th))
        x = step if x is None else x + step
        if k == len(roots) - 1 and not with_residual:
            break
        cur = cur - stencil_matvec_plain(coeffs, step, nx, nt)
    return x, (cur if with_residual else None)


# ---- build and load ----------------------------------------------------------

def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the stencil kernels are built from "
                       f"{_CSRC} at first use and need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives (keyed by a hash of
    the sources and the compiler flags)."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libdmlmc_stencil.so"


def _build() -> Path:
    """Compile csrc/*.cu into the shared library unless it already exists.
    Writes to a temporary name and renames, so concurrent builds never
    load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            for sfx in _SUFFIX.values():
                fns = {
                    f"dmlmc_stencil_matvec_{sfx}": [P, P, P, I, I, I, P],
                    f"dmlmc_stencil_residual_{sfx}": [P, P, P, P, I, I, I, P],
                    f"dmlmc_stencil_poly_step_{sfx}":
                        [P, P, P, P, D, D, I, I, I, I, I, P],
                }
                for name, argtypes in fns.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_operands(coeffs: torch.Tensor, nx: int, nt: int,
                    *vecs: torch.Tensor) -> int:
    """Validate the operands of a CUDA launch; returns the batch size B."""
    if coeffs.dtype not in _SUFFIX:
        raise TypeError(f"stencil kernels take complex64/complex128, got {coeffs.dtype}")
    if tuple(coeffs.shape) != (2, 2, 5, nx, nt):
        raise ValueError(f"coefficients must be (2, 2, 5, {nx}, {nt}), "
                         f"got {tuple(coeffs.shape)}")
    n = 2 * nx * nt
    for t in (coeffs,) + vecs:
        if t.device != coeffs.device:
            raise ValueError("stencil operands must share one CUDA device")
        if t.dtype != coeffs.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {coeffs.dtype}")
        if not t.is_contiguous():
            raise ValueError("stencil operands must be contiguous")
    shape = vecs[0].shape
    for t in vecs:
        if t.shape != shape:
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs {tuple(shape)}")
    if not shape or shape[-1] != n:
        raise ValueError(f"vectors must be (..., {n}), got {tuple(shape)}")
    B = 1
    for s in shape[:-1]:
        B *= int(s)
    return B


def _dispatch(t: torch.Tensor) -> bool:
    """True -> launch the CUDA kernel; False -> plain version (CPU only)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no stencil kernel for device {t.device}")


# ---- public wrappers ---------------------------------------------------------

def stencil_matvec(coeffs: torch.Tensor, v: torch.Tensor, nx: int,
                   nt: int) -> torch.Tensor:
    """K1: y = D v for complex v of shape (..., 2*nx*nt)."""
    if not _dispatch(v):
        return stencil_matvec_plain(coeffs, v, nx, nt)
    B = _check_operands(coeffs, nx, nt, v)
    lib = load_library()
    y = torch.empty_like(v)
    fn = getattr(lib, f"dmlmc_stencil_matvec_{_SUFFIX[v.dtype]}")
    with torch.cuda.device(v.device):
        _check(fn(coeffs.data_ptr(), v.data_ptr(), y.data_ptr(), B, nx, nt,
                  _stream(v.device)), "stencil_matvec")
    stencil_matvec.launches += 1
    return y


def stencil_residual(coeffs: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                     nx: int, nt: int) -> torch.Tensor:
    """K2: r = b - D x in one pass."""
    if not _dispatch(b):
        return stencil_residual_plain(coeffs, b, x, nx, nt)
    B = _check_operands(coeffs, nx, nt, b, x)
    lib = load_library()
    r = torch.empty_like(b)
    fn = getattr(lib, f"dmlmc_stencil_residual_{_SUFFIX[b.dtype]}")
    with torch.cuda.device(b.device):
        _check(fn(coeffs.data_ptr(), b.data_ptr(), x.data_ptr(), r.data_ptr(), B,
                  nx, nt, _stream(b.device)), "stencil_residual")
    stencil_residual.launches += 1
    return r


def stencil_poly_smooth(coeffs: torch.Tensor, r: torch.Tensor,
                        roots: Sequence[complex], nx: int, nt: int, *,
                        with_residual: bool = False):
    """K3: x = p(D) r, one fused launch per root. Returns (x, r - D x) with
    ``with_residual`` (m applications of D), else (x, None) (m - 1)."""
    roots = tuple(complex(t) for t in roots)
    if not _dispatch(r):
        return stencil_poly_smooth_plain(coeffs, r, roots, nx, nt, with_residual)
    if not roots:
        raise ValueError("the polynomial smoother needs at least one root")
    B = _check_operands(coeffs, nx, nt, r)
    lib = load_library()
    fn = getattr(lib, f"dmlmc_stencil_poly_step_{_SUFFIX[r.dtype]}")
    x = torch.empty_like(r)
    bufs = (torch.empty_like(r), torch.empty_like(r))  # ping-pong for cur
    cur = r
    with torch.cuda.device(r.device):
        stream = _stream(r.device)
        for k, th in enumerate(roots):
            inv = 1.0 / th
            apply = k < len(roots) - 1 or with_residual
            out = bufs[k % 2]
            _check(fn(coeffs.data_ptr(), cur.data_ptr(), x.data_ptr(),
                      out.data_ptr(), inv.real, inv.imag, int(k == 0), int(apply),
                      B, nx, nt, stream), "stencil_poly_smooth")
            stencil_poly_smooth.launches += 1
            if apply:
                cur = out
    return x, (cur if with_residual else None)


KERNELS = (stencil_matvec, stencil_residual, stencil_poly_smooth)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
