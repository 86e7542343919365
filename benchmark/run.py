#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload hutch128.b128 --seed 7 --seconds 51 --trace 0

From the root of a checkout that holds the port
(deflatedmlmc_schwinger_tpu_torch/) and BENCHMARK.json, on a machine with
an NVIDIA card. ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (a stretch of batches after the window
runs under torch.profiler). The last line of standard output is one JSON
object: correct, attempted, failed, metrics, device, [breakdown], checks.
The numbers the reference compared are also the last lines of standard
error, each beside its limit.

Exit codes: 0 with a result; 2 without a usable card; 3 when jax, jaxlib,
flax or the JAX package is loaded in this process once the window has
closed; anything else when the run failed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deflatedmlmc_schwinger_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package
    (whole names: the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every kernel and compiler cache at a fixed path inside the checkout;
    # the port builds its kernels into deflatedmlmc_schwinger_tpu_torch/_build
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))

    import torch

    import core

    spec = core.load_cell(args.workload, ROOT)
    chips = int(spec["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload}: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tdir:
        result = core.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                               "cuda:0", T_START, tdir,
                               log=lambda *a: print(*a, file=sys.stderr))
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
