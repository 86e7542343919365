#!/usr/bin/env python3
"""Run one cell's set-up, warm-up and timed window as benchmark/run.py does,
with the program's host-read counters taken around the window, then the span
pass (benchmark/spantrace.py), and print the host and span metrics as one
JSON line; the span pass's two tables go to standard error.

    python3 benchmark/span_run.py --workload hutch128.b128 --seed 7 --seconds 51

The metrics are those of benchmark/metrics/ named in ``METRICS``, read from
a context shaped as run.py's: the window's ``host_reads`` (reads and seconds
blocked during ``Window.run``) and the pass under ``trace["spans"]``.
benchmark/run.py reports them once benchmark/core.py takes the counters
around ``win.run`` and calls ``spantrace.span_pass`` after its traced
stretch. Exit codes as run.py's: 2 without a usable card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
METRICS = ("host.syncs_per_iter", "host.busy_ms_per_iter", "fgmres.own_ms_per_batch",
           "vcycle.fine_ms_per_batch", "vcycle.coarse_ms_per_batch", "est.own_ms_per_batch")


def span_run(spec: dict, seed: int, seconds: float, device, trace_dir: str) -> dict:
    """The window with its host-read counts, the span pass, and the
    metrics of ``METRICS`` read from them."""
    import torch

    import core
    import gauge
    import spantrace
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk
    from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator
    from deflatedmlmc_schwinger_tpu_torch.utils.timer import PhaseTimer, host_reads
    from window import Window

    device = torch.device(device)
    if device.type == "cuda":
        torch.empty(0, device=device)
        sk.load_library()
    traffic, config = spec["traffic"], spec["config"]
    cfg = core.trace_config(config["trace_config"]).replace(
        probe_batch=int(traffic["probe_batch"]))
    op = StencilOperator.from_numpy(gauge.coefficients(config["operator"]), device=device,
                                    dtype=cfg.dtype)
    est = importlib.import_module(f"estimators.{traffic['estimator']}").setup(
        op, cfg, traffic, int(seed), PhaseTimer(device))
    win = Window(est, cfg, device)
    t_batch = win.warm_up(int(traffic["warmup_batches"]))

    before = {site: list(c) for site, c in host_reads.items()}
    win.run(seconds, t_batch)
    sites = {site: dict(reads=c[0] - before.get(site, [0, 0])[0],
                        seconds=1e-9 * (c[1] - before.get(site, [0, 0])[1]))
             for site, c in host_reads.items()}
    es, batch_iters, _, _ = win.host_arrays()
    window = dict(samples=int(es.size), seconds=win.seconds, batch_iters=batch_iters,
                  host_reads=dict(reads=sum(s["reads"] for s in sites.values()),
                                  seconds=sum(s["seconds"] for s in sites.values())))
    spans = spantrace.span_pass(win, int(traffic["trace_batches"]), trace_dir)
    ctx = dict(window=window, phases={}, trace=dict(spans=spans))
    metrics = {m: core.load_metric(m).read(ctx) for m in METRICS}
    iters = sum(batch_iters)
    return dict(samples_per_s=window["samples"] / win.seconds, outer_iters=iters,
                window=window, host_read_sites=sites, metrics=metrics, spans=spans,
                host_wait_ms_per_iter=1e3 * window["host_reads"]["seconds"] / iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))

    import torch

    import core
    import spantrace

    spec = core.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print(f"{args.workload}: needs a CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tdir:
        out = span_run(spec, args.seed, args.seconds, "cuda:0", tdir)
    if out["spans"]:
        for line in spantrace.tables(out["spans"]):
            print(line, file=sys.stderr)
    out.update(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
