"""The readings of a complex128 cell (benchmark/readings.py) with a second
control: the reference computed in complex64, the precision next below the
configuration's.

    python bench_torch/parity_readings.py --workload parity128.b128 --seeds 12 \
        --control-seeds 3 --out readings.json

Runs benchmark/readings.py unchanged (the program on ``--seeds`` seeds, the
bfloat16/TF32 control ``reference.Control`` on ``--control-seeds``), then
judges ``Control64`` on the same control seeds' probes with the same
program state, and prints its numbers and the summary. ``Control64`` is the
reference one precision down: the coefficients, the right-hand sides, the
sparse LU and its solutions, each estimate and each tr1 term in complex64
(matrix products in float32).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _c64(a):
    return np.asarray(a).astype(np.complex64)


def control64(reference):
    class Control64(reference.Reference):
        def __init__(self, C, state):
            super().__init__(_c64(C), state)
            self.A = self.A.astype(np.complex64)

        def outputs(self, Z):
            U = None if self.U is None else _c64(self.U)
            Zc = _c64(Z)
            B = Zc if U is None else Zc - (Zc @ U.conj()) @ U.T
            if self.shift:
                B = np.roll(B, self.shift, axis=-1)
            X = _c64(self.solve(_c64(B)))
            e = np.sum(Zc.conj() * X, axis=1, dtype=np.complex64)
            tr1 = 0.0 + 0.0j
            if U is not None:
                R = U.T
                Bu = np.roll(R, self.shift, axis=-1) if self.shift else R
                terms = np.sum(R.conj() * _c64(self.solve(_c64(Bu))), axis=1,
                               dtype=np.complex64)
                tr1 = complex(np.sum(terms, dtype=np.complex64))
            return dict(Z=Z, X=X.astype(np.complex128), e=e.astype(np.complex128), tr1=tr1)

    return Control64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 33 + 17)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "benchmark"))
    sys.path.insert(0, str(ROOT))
    import torch

    import core
    import readings
    import reference

    seen = {}
    Control = reference.Control

    class Recording(Control):
        def __init__(self, C, state):
            seen.update(C=C, state=state, Z=[])
            super().__init__(C, state)

        def outputs(self, Z):
            seen["Z"].append(Z)
            return super().outputs(Z)

    reference.Control = Recording
    spec = core.load_cell(args.workload, ROOT)
    rc = readings.readings(spec, args.workload, args.seeds, args.control_seeds,
                           args.first_seed, torch.device("cuda:0"), args.out)
    reference.Control = Control
    if rc or not seen:
        return rc or 1
    names = list(spec["limits"])
    ref = reference.Reference(seen["C"], seen["state"])
    ctrl = control64(reference)(seen["C"], seen["state"])
    rows = []
    for Z in seen["Z"]:
        got = reference.judge(ref, ctrl.outputs(Z), names)
        rows.append(got)
        print(f"[control64] {got}", flush=True)
    summary = {k: min(r[k] for r in rows) for k in names}
    print(json.dumps(dict(workload=args.workload, control64_min=summary), indent=1))
    if args.out:
        with open(args.out) as f:
            data = json.load(f)
        data.update(control64_min=summary, control64=rows)
        with open(args.out, "w") as f:
            json.dump(data, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
