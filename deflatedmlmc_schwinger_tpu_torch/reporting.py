"""Result reporting (counterpart of deflatedmlmc_schwinger_tpu/reporting.py;
only the Hutchinson report is ported)."""

from __future__ import annotations

import json
from typing import Dict

from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig


def print_post_results(cfg: TraceConfig, result: Dict, example: str) -> None:
    if example != "hutchinson":
        raise NotImplementedError(f"report {example!r} waits for its slice")
    n = 2 * cfg.nt * cfg.nx
    print(" -- matrix : " + cfg.matrix)
    print(f" -- matrix size : {n}x{n}")
    print(" -- tr(A^{-1}) = " + str(result["trace"]))
    print(f" -- total MG complexity = {result['total_complexity']/1e6} MFLOPS")
    print(" -- std dev = " + str(result["std_dev"]))
    print(" -- var = " + str(result["std_dev"] * result["std_dev"]))
    print(" -- number of estimates = " + str(result["nr_ests"]))
    print(" -- function iters = " + str(result["function_iters"]))


def result_to_json(cfg: TraceConfig, result: Dict, example: str) -> str:
    """One JSON line of metrics."""
    if example != "hutchinson":
        raise NotImplementedError(f"report {example!r} waits for its slice")
    out = dict(
        example=example,
        matrix=cfg.matrix,
        trace_re=float(result["trace"].real),
        trace_im=float(result["trace"].imag),
        total_complexity=float(result["total_complexity"]),
        stalled_rows=int(result["stalled_rows"]),
        std_dev=float(result["std_dev"]),
        nr_ests=int(result["nr_ests"]),
        function_iters=int(result["function_iters"]),
    )
    if "timer" in result:
        out["phase_seconds"] = dict(result["timer"].totals)
    return json.dumps(out)
