#!/usr/bin/env python3
"""The readings that the limits of a cell's check are set from: the
program's numbers on many seeds, and the control's (the reference one
precision down, reference.Control) on a few, in one process with one
set-up, each seed a short stretch of the cell's own loop with as many
checked batches as a run has.

    python3 benchmark/readings.py --workload hutch128.b128 --seeds 12 --control-seeds 3

Prints one line per seed and a JSON summary; with ``--out FILE`` the
summary and every seed's numbers are also written to FILE. Not run by
benchmark/run.py.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 33 + 17)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None, help="JSON file for the summary and every seed's numbers")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import torch

    import core

    spec = core.load_cell(args.workload, ROOT)
    return readings(spec, args.workload, args.seeds, args.control_seeds, args.first_seed,
                    torch.device(args.device), args.out)


def readings(spec, name, nseeds, ncontrol, first_seed, device, out=None):
    import importlib
    import json

    import torch

    import core
    import gauge
    import reference
    from window import Window
    from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk
    from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator
    from deflatedmlmc_schwinger_tpu_torch.trace.probes import make_probe_source
    from deflatedmlmc_schwinger_tpu_torch.utils.timer import PhaseTimer

    traffic, config = spec["traffic"], spec["config"]
    names = list(spec["limits"])
    if device.type == "cuda":
        sk.load_library()
    cfg = core.trace_config(config["trace_config"]).replace(
        probe_batch=int(traffic["probe_batch"]))
    C = gauge.coefficients(config["operator"])
    op = StencilOperator.from_numpy(C, device=device, dtype=cfg.dtype)
    timer = PhaseTimer(device)
    est = importlib.import_module(f"estimators.{traffic['estimator']}").setup(
        op, cfg, traffic, first_seed, timer)
    win = Window(est, cfg, device)
    win.warm_up(int(traffic["warmup_batches"]))
    state = est.reference_state()
    ref = reference.Reference(C, state)
    nchk = int(traffic["check_batches"])
    nb = max(3, nchk)    # a short stretch: the first chunk of a 0-second window
    rows = {"program": [], "control": []}
    Zs = []
    for i in range(nseeds):
        seed = first_seed + 7919 * i
        est.probes = make_probe_source("torch", seed, device)
        win.reset()
        win.kept = {}
        win.keep = set()
        win.choose_checked(nchk, seed, 0.0, 1.0)
        win.chunk(nb)
        es = win.host_arrays()[0]
        _, outputs = core.checked_outputs(win, es)
        outputs.update(Z=reference.probe_rows(seed, outputs["samples"], outputs["X"].shape[1],
                                              device),
                       tr1=state["tr1"])
        got = reference.judge(ref, outputs, names)
        rows["program"].append(dict(seed=seed, **got))
        print(f"[program] seed {seed}: {got}", flush=True)
        if i < ncontrol:
            Zs.append((seed, outputs["Z"]))
    del win, est, op
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctrl = reference.Control(C, state)
    for seed, Z in Zs:
        got = reference.judge(ref, ctrl.outputs(Z), names)
        rows["control"].append(dict(seed=seed, **got))
        print(f"[control] seed {seed}: {got}", flush=True)
    summary = {k: dict(program_max=max(r[k] for r in rows["program"]),
                       control_min=min(r[k] for r in rows["control"]) if rows["control"] else None)
               for k in names}
    print(json.dumps(dict(workload=name, summary=summary), indent=1))
    if out:
        with open(out, "w") as f:
            json.dump(dict(workload=name, summary=summary, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
