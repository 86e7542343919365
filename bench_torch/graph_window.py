#!/usr/bin/env python3
"""benchmark/span_run.py with the graph counters (utils/timer.py
``graph_calls``: ``vcycle.graph``, the V-cycle's, and ``fgmres.graph``,
FGMRES's step tails and cycle ends) taken around the timed window: how
often the coarse sub-cycle and FGMRES's own work replayed, captured or ran
eagerly while the cell sampled, beside the window's host busy and blocked
milliseconds per outer iteration and the span pass's device milliseconds by
layer.

    python3 bench_torch/graph_window.py --workload hutch128.b128 --seed 7 --seconds 51

Prints span_run.py's JSON line with ``graph_calls`` and
``fgmres_graph_calls`` (the window's counts) and ``graph_hit_share`` and
``fgmres_graph_hit_share`` (replays / (replays + eager)) added; the span
pass's tables go to standard error. Needs a CUDA card (exit 2 without one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT))

    import torch

    import core
    import span_run
    import spantrace
    import window
    from deflatedmlmc_schwinger_tpu_torch.utils.timer import graph_calls

    if not torch.cuda.is_available():
        print(f"{args.workload}: needs a CUDA device", file=sys.stderr)
        return 2
    counters = dict(graph_calls=graph_calls["vcycle.graph"],
                    fgmres_graph_calls=graph_calls["fgmres.graph"])
    counts = {name: {} for name in counters}
    run = window.Window.run

    def counted_run(self, *a, **k):
        before = {name: dict(c) for name, c in counters.items()}
        try:
            return run(self, *a, **k)
        finally:
            for name, c in counters.items():
                counts[name].update({n: v - before[name][n] for n, v in c.items()})

    window.Window.run = counted_run
    spec = core.load_cell(args.workload, ROOT)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tdir:
        out = span_run.span_run(spec, args.seed, args.seconds, "cuda:0", tdir)
    if out["spans"]:
        for line in spantrace.tables(out["spans"]):
            print(line, file=sys.stderr)
    out.update(workload=args.workload, seed=args.seed, device=torch.cuda.get_device_name(0))
    for name, c in counts.items():
        hits = c["replays"] + c["eager"]
        out[name] = c
        out[name.replace("calls", "hit_share")] = c["replays"] / hits if hits else None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
