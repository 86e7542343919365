"""Result reporting (counterpart of deflatedmlmc_schwinger_tpu/reporting.py)."""

from __future__ import annotations

import json
from typing import Dict

from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig


def print_post_results(cfg: TraceConfig, result: Dict, example: str) -> None:
    if example not in ("hutchinson", "mlmc"):
        raise ValueError(f"unknown example {example!r}")
    n = 2 * cfg.nt * cfg.nx
    print(" -- matrix : " + cfg.matrix)
    print(f" -- matrix size : {n}x{n}")
    print(" -- tr(A^{-1}) = " + str(result["trace"]))
    print(f" -- total MG complexity = {result['total_complexity']/1e6} MFLOPS")
    if example == "mlmc":
        print(" -- std dev = ---")
        for i in range(result["nr_levels"]):
            r = result["results"][i]
            print(" -- level : " + str(i))
            print(" \t-- number of estimates = " + str(r["nr_ests"]))
            print(" \t-- function iters = " + str(r["function_iters"]))
            print(" \t-- trace = " + str(r["ests_avg"]))
            print(" \t-- std dev = " + str(r["ests_dev"]))
            print(" \t-- var = " + str(r["ests_dev"] * r["ests_dev"]))
            print(f"\t-- level MG complexity = {r['level_complexity']/1e6} MFLOPS")
        return
    print(" -- std dev = " + str(result["std_dev"]))
    print(" -- var = " + str(result["std_dev"] * result["std_dev"]))
    print(" -- number of estimates = " + str(result["nr_ests"]))
    print(" -- function iters = " + str(result["function_iters"]))


def result_to_json(cfg: TraceConfig, result: Dict, example: str) -> str:
    """One JSON line of metrics."""
    if example not in ("hutchinson", "mlmc"):
        raise ValueError(f"unknown example {example!r}")
    out = dict(
        example=example,
        matrix=cfg.matrix,
        trace_re=float(result["trace"].real),
        trace_im=float(result["trace"].imag),
        total_complexity=float(result["total_complexity"]),
        stalled_rows=int(result["stalled_rows"]),
        std_dev=float(result["std_dev"]),
    )
    if example == "hutchinson":
        out.update(nr_ests=int(result["nr_ests"]),
                   function_iters=int(result["function_iters"]))
    else:
        out["levels"] = [
            dict(
                nr_ests=int(r["nr_ests"]),
                function_iters=int(r["function_iters"]),
                trace_re=float(complex(r["ests_avg"]).real),
                trace_im=float(complex(r["ests_avg"]).imag),
                std_dev=float(r["ests_dev"]),
                level_complexity=float(r["level_complexity"]),
                stalled_rows=int(r["stalled_rows"]),
            )
            for r in result["results"]
        ]
    if "timer" in result:
        # each phase's seconds, the seconds of it spent blocked in host
        # reads of device values (utils/timer.py host_read), its V-cycle
        # graph calls (captures, replays, eager; mg/cycle.py CycleGraphs) and
        # its FGMRES graph calls (solvers/fgmres.py KrylovWorkspace)
        out["phase_seconds"] = dict(result["timer"].totals)
        out["host_read_seconds"] = dict(result["timer"].host_read)
        out["graph_calls"] = {k: dict(v) for k, v in result["timer"].graphs.items()}
        out["fgmres_graph_calls"] = {k: dict(v)
                                     for k, v in result["timer"].fgmres_graphs.items()}
    return json.dumps(out)
