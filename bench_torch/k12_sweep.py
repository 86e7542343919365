"""K1/K2 on the card: the row kernel under other launch plans (rows per
tile R, probes per block, stages) beside the per-site kernel, at the G102,
G301, G302, G101 and padded-block shapes.

    python bench_torch/k12_sweep.py [shape label ...]   # e.g. G102 "x4 B8"; default: all

For each shape (random seeded coefficients and vectors: the time does not
depend on the values) and each kernel it prints the per-site kernel's device
time, the eager-loop and host times of both wrappers, then one line per
plan: device milliseconds per call (CUDA graph of 50 launches replayed,
chip_smoke._graph_ms), the share of the byte bound, and whether it is the
plan ``launch_plan`` picks. R x probes per block is swept at the module's
stages, then the stages at the module's R and chunking. Each plan's result
is held to the plain version first. At the G101 shape it also splits one
wrapper call's host time into its steps. Prints what ptxas reported for
each instantiation of the row kernel (registers, spills) and the card's
name and power limit.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch

# (label, B, X, T, dtype)
SHAPES = (("G102", 128, 128, 128, torch.complex64), ("G301", 64, 256, 256, torch.complex64),
          ("G302", 16, 512, 512, torch.complex64), ("G302 B8", 8, 512, 512, torch.complex64),
          ("G101", 8, 16, 16, torch.complex128), ("x2 B8", 8, 258, 512, torch.complex64),
          ("x4 B8", 8, 130, 512, torch.complex64), ("x4 B16", 16, 130, 512, torch.complex64))
ROWS = (1, 2, 4, 8, 16)
CHUNKS = (1, 2, 4, 8, 16, 32)
STAGES = (1, 2, 3, 4, 6, 8)


def ptxas_report(sk) -> None:
    """Registers and spills of each stencil_rows_kernel instantiation."""
    lines = sk.library_path().with_name("build.log").read_text().splitlines()
    name = None
    for line in lines:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"stencil_rows_kernelI(\d+)(float2|double2)Lb(\d)ELb(\d)E", m.group(1))
            name = (f"stencil_rows_kernel<{t.group(2)}, residual={t.group(3)}, "
                    f"bulk={t.group(4)}>") if t else None
        elif name and ("spill" in line or "registers" in line):
            print(f"[ptxas] {name}: {line.split(':', 1)[-1].strip()}")


def host_split(sk, name, C, b, v, nx, nt, calls: int = 2000) -> None:
    """Host microseconds of each step of a wrapper call, each timed alone
    over ``calls`` repetitions (the launch itself is the whole call less
    the rest)."""
    import time

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        return us

    vecs = (v,) if b is None else (b, v)
    sfx, isz, B = sk._check_operands(C, nx, nt, *vecs)
    dev = v.device.index
    wrapper = getattr(sk, name)
    steps = {
        "whole call": lambda: wrapper(C, *vecs, nx, nt),
        "validation": lambda: sk._check_operands(C, nx, nt, *vecs),
        "empty_like": lambda: torch.empty_like(v),
        "plan lookup": lambda: sk._plan_for(b is not None, B, nx, nt, isz, True, dev),
        "stream": lambda: sk._raw_stream(dev),
        "data_ptr x3": lambda: (C.data_ptr(), v.data_ptr(), v.data_ptr()),
    }
    print(f"[host split {name}] " + ", ".join(
        f"{k} {per_call(fn):.2f} us" for k, fn in steps.items()), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k12_sweep: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    sk.load_library()
    ptxas_report(sk)
    device = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(12)
    wanted = set(sys.argv[1:])
    for label, B, nx, nt, dtype in SHAPES:
        if wanted and label not in wanted:
            continue
        n = 2 * nx * nt
        C = torch.randn((2, 2, 5, nx, nt), dtype=dtype, generator=gen, device=device)
        v = torch.randn((B, n), dtype=dtype, generator=gen, device=device)
        b = torch.randn((B, n), dtype=dtype, generator=gen, device=device)
        out = torch.empty_like(v)
        isz = C.element_size()
        sfx = "c64" if dtype == torch.complex64 else "c128"
        tol = cs.TOL_C64 if dtype == torch.complex64 else cs.TOL_C128
        for name, residual, blocks, flops in (("stencil_matvec", False, 2, cs.FLOPS_D),
                                              ("stencil_residual", True, 3, cs.FLOPS_K2)):
            bound, _ = cs._bound(blocks, flops, B, nx, nt, isz)
            head = f"[{label} {name} B={B} {nx}x{nt} {sfx}]"
            if residual:
                ref = sk.stencil_residual_plain(C, b, v, nx, nt)
                per_site = lambda: sk.stencil_residual_per_site(C, b, v, nx, nt)  # noqa: E731
            else:
                ref = sk.stencil_matvec_plain(C, v, nx, nt)
                per_site = lambda: sk.stencil_matvec_per_site(C, v, nx, nt)  # noqa: E731
            if residual:
                wrapper = lambda: sk.stencil_residual(C, b, v, nx, nt)  # noqa: E731
            else:
                wrapper = lambda: sk.stencil_matvec(C, v, nx, nt)  # noqa: E731
            ps = cs._graph_ms(per_site)
            print(f"{head} per-site kernel {ps:.4f} ms, {bound / ps:.1%} of the "
                  f"{bound:.4f} ms bound; eager loop: row kernel {cs._time_ms(wrapper):.4f} ms, "
                  f"per-site {cs._time_ms(per_site):.4f} ms; host per call: row kernel "
                  f"{cs._host_us(wrapper):.2f} us, per-site {cs._host_us(per_site):.2f} us",
                  flush=True)
            if label == "G101":
                host_split(sk, name, C, b if residual else None, v, nx, nt)
            chosen = sk.launch_plan(B, nx, nt, isz, sms, residual=residual)
            plans = []
            for R in ROWS:
                for chunks in CHUNKS:
                    if chunks <= B:
                        plans.append(dict(rows=R, probes_per_block=-(-B // chunks)))
            for S in STAGES:
                plans.append(dict(rows=chosen.rows, probes_per_block=chosen.probes_per_block,
                                  stages=S))
            seen = set()
            for kw in plans:
                try:
                    plan = sk.launch_plan(B, nx, nt, isz, sms, residual=residual, **kw)
                except ValueError:
                    continue
                if plan in seen or plan.rows > nx:
                    continue
                seen.add(plan)

                def run(plan=plan):
                    sk._launch_rows(name, sfx, isz, C, b if residual else None, v, out,
                                    B, nx, nt, plan)

                run()
                torch.cuda.synchronize()
                err = cs._rel_err(out, ref)
                if not err <= tol:
                    raise RuntimeError(f"{head} {plan}: rel err {err:.3e}")
                ms = cs._graph_ms(run)
                print(f"{head} R={plan.rows} ppb={plan.probes_per_block} S={plan.stages} "
                      f"blocks={plan.tiles * plan.chunks} smem={plan.smem} bulk={plan.bulk}: "
                      f"{ms:.4f} ms, {bound / ms:.1%} of bound"
                      f"{' (module plan)' if plan == chosen else ''}", flush=True)
        del C, v, b, out, ref


if __name__ == "__main__":
    main()
