"""K4 on the card: the block-sparse coarse kernel at the 128^2 flagship's
coarse levels, by probes a thread, beside the einsum path it replaced.
The kernel is built for 2 x 2 sub-blocks and 8 warps a block; PERF.md has
the sweep that also built sub-blocks of 1, 4 and 8 and 4 or 16 warps.

    python bench_torch/k4_sweep.py

Builds the schwinger128 hierarchy on the generated flagship operator
(chip_smoke.flagship_cfg, complex64) on the card. For levels 1 and 2 it
checks K4's three forms against the plain version at B = 128 (relative
error), then prints the device milliseconds (a CUDA graph of 50 calls
replayed, as chip_smoke._graph_ms) of one root (cur, x -> x, cur') for 4
and 8 probes a thread, and of a matvec, a residual and the whole depth-16
smoothing with its residual at ``launch_plan``'s choice; the same for the
einsum path (the gather, the batched product and the elementwise passes
of mg/cycle.py poly_smoother on the grouped band, packed on the host).
Also prints each root's bound (bytes of cur and x in and out and of the
nonzero sub-blocks at 3.35 TB/s, or the nonzero flops at 67 TFLOP/s) and
what ptxas reported for the kernel.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

PROBES = (4, 8)
B = 128


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k4_sweep: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from deflatedmlmc_schwinger_tpu_torch.config import pin_full_precision_matmuls
    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.mg import setup_hierarchy
    from deflatedmlmc_schwinger_tpu_torch.mg.cycle import poly_smoother
    from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import BlockStencilOperator, pack_grouped
    from deflatedmlmc_schwinger_tpu_torch.ops import block_kernels as bk
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    pin_full_precision_matmuls()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    sk.load_library()
    log = sk.library_path().with_name("build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "coarse_bsr" in line and "Compiling" in line:
            print("[ptxas]", line.strip(), "|", " ".join(x.strip() for x in log[i + 1:i + 3]))
    device = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = cs.flagship_cfg()
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims, dtype=cfg.dtype,
                          device=device)
    hier = setup_hierarchy(op, cfg)
    gen = torch.Generator(device=device).manual_seed(11)
    for lvl in (1, 2):
        bop = hier.levels[lvl].op
        band = pack_grouped(BlockStencilOperator(bop.blocks.cpu(), bop.offsets)).to(device)
        roots = hier.poly_roots[lvl]
        v = torch.randn((B, bop.n), dtype=cfg.dtype, generator=gen, device=device)
        w = torch.randn((B, bop.n), dtype=cfg.dtype, generator=gen, device=device)
        inv = 1.0 / complex(roots[0])
        nnz = int((bop.blocks != 0).sum())
        head = f"[level {lvl} n={bop.n} blocks={tuple(bop.blocks.shape)} B={B}]"

        def old_root():
            step = v * inv
            x = w + step
            return x, v - band.einsum_matvec(step)

        def old_smooth():
            return poly_smoother(band.einsum_matvec, v, roots, with_residual=True)

        print(f"{head} einsum path (grouped band: {band.gmat is not None}): root "
              f"{cs._graph_ms(old_root):.5f} ms, matvec "
              f"{cs._graph_ms(lambda: band.einsum_matvec(v)):.5f} ms, residual "
              f"{cs._graph_ms(lambda: w - band.einsum_matvec(v)):.5f} ms, depth-16 smoothing "
              f"{cs._graph_ms(old_smooth, reps=10):.5f} ms; nonzero entries {nnz}")
        lay = bop.layout
        stored = lay.vals.numel()
        bound, by = cs._k4_root_bound(lay, B, nnz, v.element_size())
        errs = dict(
            matvec=cs._rel_err(bk.block_matvec(lay, v), bk.block_matvec_plain(lay, v)),
            residual=cs._rel_err(bk.block_residual(lay, w, v),
                                 bk.block_residual_plain(lay, w, v)),
            smooth=cs._rel_err(torch.cat(bk.block_poly_smooth(lay, v, roots, True)),
                               torch.cat(bk.block_poly_smooth_plain(lay, v, roots, True))),
            vs_einsum=cs._rel_err(bk.block_matvec(lay, v), band.einsum_matvec(v)))
        print(f"{head} s={lay.size}: {lay.cols.numel()} sub-blocks, {stored} stored entries "
              f"({nnz / stored:.1%} nonzero); root bound {bound:.5f} ms ({by}); rel err "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        x0, out = torch.empty_like(v), torch.empty_like(v)
        for probes in PROBES:
            def root():
                bk._launch("k4", lay, "root", B, v, x=x0, out=out, inv=inv, probes=probes)

            ms = cs._graph_ms(root)
            print(f"{head} probes a thread {probes}: root {ms:.5f} ms ({bound / ms:.1%} of "
                  f"bound)")
        t_mv = cs._graph_ms(lambda: bk.block_matvec(lay, v))
        t_res = cs._graph_ms(lambda: bk.block_residual(lay, w, v))
        t_sm = cs._graph_ms(lambda: bk.block_poly_smooth(lay, v, roots, True), reps=10)
        print(f"{head} launch_plan picks {bk.launch_plan(bop.n, B, sms)} probes a thread: "
              f"matvec {t_mv:.5f}, residual {t_res:.5f}, depth-16 smoothing {t_sm:.5f} ms")
        # complex128 at a smaller batch: the kernel's double2 path
        lay = bk.block_layout(bop.blocks.to(torch.complex128), bop.offsets)
        v2 = v[:32].to(torch.complex128)
        smooth = torch.cat(bk.block_poly_smooth(lay, v2, roots, True))
        smooth_plain = torch.cat(bk.block_poly_smooth_plain(lay, v2, roots, True))
        print(f"{head} complex128 B=32: rel err matvec "
              f"{cs._rel_err(bk.block_matvec(lay, v2), bk.block_matvec_plain(lay, v2)):.3e}, "
              f"smoothing {cs._rel_err(smooth, smooth_plain):.3e}")
    torch.cuda.synchronize()
    print("k4_sweep done")


if __name__ == "__main__":
    main()
