"""The Arnoldi step tail kernel on the card (ops/krylov_kernels.py
step_tail, csrc/krylov.cu): its plans, by CTAs a probe (the cluster size C)
and ring slots, beside the plain tail.

    python bench_torch/krylov_sweep.py

At the cells' shape (B = 128 probes of n = 32768, complex64, restart 40)
it times, for every plan of C in {2, 4, 8} and 3 or 4 ring slots (the
on-chip form where its ring fits a block's shared memory, else the
device-memory form), and for the device-memory form at C = 4 and 8, the
tail of steps j = 0..10 (device ms: a CUDA graph of 50 launches replayed,
as chip_smoke._graph_ms), summed over j, beside the byte bound ((j + 3)
blocks at 3.35 TB/s) and the plain tail's time; then the device-memory
form at C in {2, 4, 8} at G301's (64 probes of 131072) and G302's (16 of
524288) shapes. Each plan is first checked against the plain tail at
j = 10. Prints what ptxas reported for the kernel and which plan
``launch_plan`` picks.
"""

from __future__ import annotations

import subprocess
import sys
import types
from pathlib import Path

import torch

M = 40
FIELDS = ("V", "H", "g", "cs", "sn", "res", "tol_abs", "iters", "w")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("krylov_sweep: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from deflatedmlmc_schwinger_tpu_torch.ops import krylov_kernels as kk
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    sk.load_library()
    log = sk.library_path().with_name("build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "krylov_tail" in line and "Compiling" in line:
            print("[ptxas]", line.strip().split("'")[1], "|",
                  " ".join(x.strip() for x in log[i + 2:i + 4]))
    device = torch.device("cuda:0")
    tiny = torch.finfo(torch.float32).tiny

    def sweep(label, B, n, plans):
        ws = cs._tail_workspace(B, n, M, torch.complex64, device, 7)
        start = {f: getattr(ws, f).clone() for f in FIELDS}
        ref = types.SimpleNamespace(**{f: t.clone() for f, t in start.items()})
        kk.step_tail_plain(ref, 10, tiny)
        bound = sum(cs._tail_bound_ms(B, n, j, 8) for j in cs.KRYLOV_STEPS)
        plain = sum(cs._graph_ms(lambda j=j: kk.step_tail_plain(ws, j, tiny), reps=10)
                    for j in cs.KRYLOV_STEPS)
        print(f"[{label}] B={B} n={n}: bound {bound:.4f} ms over j = 0..10; plain tail "
              f"{plain:.4f} ms; launch_plan picks {tuple(kk.launch_plan(n, M, 8))}")
        for plan in plans:
            for f in FIELDS:
                getattr(ws, f).copy_(start[f])
            kk.step_tail(ws, 10, tiny, plan)
            err = max(cs._rel_err(getattr(ws, f), getattr(ref, f))
                      for f in ("V", "H", "g", "cs", "sn", "res"))
            ms = [cs._graph_ms(lambda j=j: kk.step_tail(ws, j, tiny, plan))
                  for j in cs.KRYLOV_STEPS]
            form = "on-chip" if plan.on_chip else "device-memory"
            print(f"[{label}] C={plan.clusters} per thread {plan.per_thread} stages "
                  f"{plan.stages} ({form}, smem {kk.smem_bytes(plan, M, 8)} B): "
                  f"{sum(ms):.4f} ms, {bound / sum(ms):.1%} of bound, {plain / sum(ms):.2f}x "
                  f"plain; rel err {err:.2e}; by j " + " ".join(f"{t:.4f}" for t in ms))
        del ws, ref, start
        torch.cuda.empty_cache()

    n = 32768
    plans = [kk.launch_plan(n, M, 8, clusters=c, stages=s) for c in (2, 4, 8) for s in (3, 4)]
    plans += [kk.TailPlan(c, -(-n // (c * kk.THREADS)), 0) for c in (4, 8)]
    sweep("cells", 128, n, list(dict.fromkeys(plans)))
    for label, B, n in (("G301", 64, 131072), ("G302", 16, 524288)):
        sweep(label, B, n, [kk.TailPlan(c, -(-n // (c * kk.THREADS)), 0) for c in (2, 4, 8)])
    torch.cuda.synchronize()
    print("krylov_sweep done")


if __name__ == "__main__":
    main()
