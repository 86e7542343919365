"""K3 on the card: the tiled kernel with at most 2, 3 or 4 roots per launch
(the port uses 4) beside the per-root kernel, at the G102 and G301 shapes.

    python bench_torch/k3_sweep.py

For each shape (G102: 128 probes, 128^2; G301: 64 probes, 256^2; complex64,
the profile's own operator and smoother roots), each polynomial depth of the
profile and both forms (with and without the residual) it prints one line
per variant: milliseconds per call (CUDA events, 50 calls after warm-up),
the relative error against the per-root kernel's result, and the launches
per call. The per-root kernel is timed before and after the tiled variants.
Also prints what ptxas reported for the tiled kernel (registers, spills).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

FUSE_DEPTHS = (2, 3, 4)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k3_sweep: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from deflatedmlmc_schwinger_tpu_torch.gateway import set_params
    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    sk.load_library()
    log = sk.library_path().with_name("build.log")
    for line in log.read_text().splitlines():
        if "poly_tiled" in line or "registers" in line or "spill" in line:
            print("[ptxas]", line.strip())
    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(7)
    for label, cfg in (("G102", cs.flagship_cfg()), ("G301", set_params("schwinger256"))):
        op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                              dtype=torch.complex64, device=device)
        depths = {cfg.solver.smooth_iters}
        if cfg.defl_solver is not None:
            depths.add(cfg.defl_solver.smooth_iters)
        r = torch.randn((cfg.probe_batch, op.n), dtype=torch.complex64,
                        generator=gen, device=device)
        for m in sorted(depths, reverse=True):
            roots = cs._roots(op, m)
            for wr in (True, False):
                head = f"[{label} B={cfg.probe_batch} {op.nx}x{op.nt} m={m} residual={wr}]"

                def per_root():
                    out = sk.stencil_poly_smooth_per_root(op.coeffs, r, roots, op.nx,
                                                          op.nt, with_residual=wr)
                    return out if wr else out[0]

                ref = cs._flat(per_root())
                print(f"{head} per-root: {cs._time_ms(per_root):.4f} ms, {m} launches")
                croots, B = sk._poly_operands(op.coeffs, r, roots, op.nx, op.nt)
                for d in FUSE_DEPTHS:

                    def tiled():
                        out = sk._poly_tiled(op.coeffs, r, croots, op.nx, op.nt, wr, B, d)
                        return out if wr else out[0]

                    got = cs._flat(tiled())
                    torch.cuda.synchronize()
                    err = cs._rel_err(got, ref)
                    if not err <= cs.TOL_C64:
                        raise RuntimeError(f"{head} tiled d={d}: rel err {err:.3e}")
                    print(f"{head} tiled fuse_depth={d}: {cs._time_ms(tiled):.4f} ms, "
                          f"{len(sk.fused_passes(m, d))} launches, rel err {err:.2e}")
                print(f"{head} per-root again: {cs._time_ms(per_root):.4f} ms")
        del op, r


if __name__ == "__main__":
    main()
