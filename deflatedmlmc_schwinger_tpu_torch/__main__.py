"""Command line: ``python -m deflatedmlmc_schwinger_tpu_torch G301
[--device cuda:0]``; the entries are G101, G102, G201, G202, G301, G302.
``G302 --devices N`` starts N ranks on this host (with DMLMC_X_SHARDS=k the
lattice is cut over k of them); under ``torchrun`` G302 joins the ranks
torchrun started."""

from __future__ import annotations

import argparse

from deflatedmlmc_schwinger_tpu_torch.gateway import ENTRIES


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m deflatedmlmc_schwinger_tpu_torch")
    ap.add_argument("entry", choices=sorted(ENTRIES))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--devices", type=int, default=1,
                    help="number of ranks to start on this host (G302 only)")
    args = ap.parse_args(argv)
    if args.devices != 1:
        if args.entry != "G302":
            ap.error("--devices applies to G302 only")
        ENTRIES[args.entry](device=args.device, devices=args.devices)
    else:
        ENTRIES[args.entry](device=args.device)


if __name__ == "__main__":
    main()
