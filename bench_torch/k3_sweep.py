"""K3 on the card: the tiled kernel's plans swept at the cells' shapes.

    python bench_torch/k3_sweep.py

A plan is the window (WX x WT sites a block), the strip (S adjacent t-sites
a thread, whose coefficients it keeps in registers) and the probes a block
runs through the roots together (PB), fixed per instantiation of
csrc/stencil.cu poly_tiled_kernel; the roots a launch takes (the depth) are
an argument. The script compiles every plan of VARIANTS into its own
library (a source that includes stencil.cu and adds one C entry, built in
parallel beside the port's library) and prints what ptxas reported for each
(registers, spill bytes). Then, at the cells' shapes (128^2, 128 probes, the
flagship operator: complex64 at depths 16 and 4, complex128 at depth 4;
with and without the residual), it times each plan at each depth by
CUDA-graph replay (device ms a call), checks it against the plain recurrence
(1e-5 complex64, 1e-12 complex128), and prints the per-root yardstick and
the port's own plan beside them. The port's plan (ops/stencil_kernels.py
WINDOW, STRIP, PROBES_PER_PASS, FUSE_DEPTH) is chosen from this output.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

# (vector type, WX, WT, S, PB)
VARIANTS = (
    ("float2", 24, 40, 1, 1), ("float2", 24, 40, 2, 1), ("float2", 24, 40, 1, 2),
    ("float2", 40, 24, 1, 1), ("float2", 24, 32, 1, 1), ("float2", 24, 32, 1, 2),
    ("float2", 24, 32, 2, 2), ("float2", 16, 40, 1, 2), ("float2", 24, 40, 4, 1),
    ("double2", 16, 32, 1, 1), ("double2", 16, 32, 2, 1), ("double2", 20, 20, 1, 1),
    ("double2", 20, 20, 2, 1), ("double2", 12, 36, 2, 1), ("double2", 24, 16, 1, 1),
)
DEPTHS = {torch.complex64: (3, 4), torch.complex128: (2, 3, 4)}
# (dtype, polynomial depths) of the cells: schwinger128's depth-16
# smoother and depth-4 set-up solver, schwinger128-parity's depth 4
CELLS = ((torch.complex64, (16, 4)), (torch.complex128, (4,)))
B = 128

ENTRY = """
extern "C" int k3_variant(const void* C, const void* cur_in, void* x, void* cur_out,
                          const double* inv, int nroots, int halo, int first,
                          int apply_last, int B, int X, int T, void* stream) {
  return launch_poly_tiled<%s, %d, %d, %d, %d>(C, cur_in, x, cur_out, inv, nroots,
                                               halo, first, apply_last, B, X, T, stream);
}
"""


def _build_variant(sk, nvcc: str, out_dir: Path, v) -> tuple:
    """Compile plan ``v`` into its own library; (library, ptxas lines)."""
    name = "k3_" + "_".join(str(a) for a in v)
    src = out_dir / f"{name}.cu"
    src.write_text(f'#include "{(sk._CSRC / "stencil.cu").as_posix()}"\n' + ENTRY % v)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([nvcc, *sk._NVCC_FLAGS, "-I", str(sk._CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {v}:\n{proc.stdout}\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def ptxas_report(log: str) -> dict:
    """{(vector, WX, WT, S, PB): (registers, spill store bytes, spill load
    bytes)} of the poly_tiled_kernel instantiations in an `nvcc -Xptxas -v`
    log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"poly_tiled_kernelI(\d+)(\w+?)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                          m.group(1))
            cur = None if k is None else (k.group(2)[:int(k.group(1))],
                                          *(int(g) for g in k.groups()[2:]))
            if cur is not None:
                out[cur] = [None, None, None]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k3_sweep: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    sk.load_library()
    for k, (regs, st, ld) in ptxas_report(
            sk.library_path().with_name("build.log").read_text()).items():
        print(f"[ptxas port] poly_tiled_kernel<{', '.join(map(str, k))}>: {regs} registers, "
              f"spill stores {st} B, loads {ld} B")
    out_dir = sk.library_path().parent / "k3_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = sk._nvcc()
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = list(pool.map(lambda v: _build_variant(sk, nvcc, out_dir, v), VARIANTS))
    entries = {}
    for v, (lib, log) in zip(VARIANTS, built):
        regs, st, ld = ptxas_report(log).get(v, (None, None, None))
        print(f"[ptxas] poly_tiled_kernel<{', '.join(map(str, v))}>: {v[1] * v[2] // v[3]} "
              f"threads, {regs} registers, spill stores {st} B, loads {ld} B")
        fn = ctypes.CDLL(str(lib)).k3_variant
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[v] = fn

    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(7)
    cfg = cs.flagship_cfg()
    for dtype, depths in CELLS:
        vec = "float2" if dtype == torch.complex64 else "double2"
        tol = cs.TOL_C64 if dtype == torch.complex64 else cs.TOL_C128
        op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims, dtype=dtype,
                              device=device)
        r = torch.randn((B, op.n), dtype=dtype, generator=gen, device=device)
        port = (vec, *sk.WINDOW[dtype], sk.STRIP[dtype], sk.PROBES_PER_PASS[dtype])
        for m in depths:
            roots = cs._roots(op, m)
            croots = tuple(complex(t) for t in roots)
            for wr in (True, False):
                head = f"[{str(dtype)[6:]} B={B} {op.nx}x{op.nt} m={m} residual={wr}]"
                plain = sk.stencil_poly_smooth_plain(op.coeffs, r, croots, op.nx, op.nt, wr)
                ref = cs._flat(plain if wr else plain[0])

                def per_root():
                    out = sk.stencil_poly_smooth_per_root(op.coeffs, r, roots, op.nx, op.nt,
                                                          with_residual=wr)
                    return out if wr else out[0]

                def port_call():
                    out = sk.stencil_poly_smooth(op.coeffs, r, roots, op.nx, op.nt,
                                                 with_residual=wr)
                    return out if wr else out[0]

                err = cs._rel_err(cs._flat(port_call()), ref)
                print(f"{head} port {port} depth {sk.FUSE_DEPTH[dtype]}: "
                      f"{cs._graph_ms(port_call):.4f} ms, rel err {err:.2e}; per-root "
                      f"{cs._graph_ms(per_root):.4f} ms, {m} launches")
                for v, fn in entries.items():
                    if v[0] != vec:
                        continue
                    for d in DEPTHS[dtype]:
                        if 2 * sk.poly_launches(m, d, wr)[1] >= min(v[1], v[2]):
                            continue

                        def call(fn=fn, d=d):
                            out = sk._poly_tiled(op.coeffs, r, croots, op.nx, op.nt, wr, B,
                                                 d, fn=fn)
                            return out if wr else out[0]

                        got = cs._flat(call())
                        torch.cuda.synchronize()
                        err = cs._rel_err(got, ref)
                        if not (torch.isfinite(got).all() and err <= tol):
                            raise RuntimeError(f"{head} {v} d={d}: rel err {err:.3e}")
                        print(f"{head} {v} depth {d}: {cs._graph_ms(call):.4f} ms, "
                              f"{len(sk.fused_passes(m, d))} launches, rel err {err:.2e}")
        del op, r
    print("plans", sk.stencil_poly_smooth.plans)


if __name__ == "__main__":
    main()
