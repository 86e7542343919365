"""Command line: ``python -m deflatedmlmc_schwinger_tpu_torch G301
[--device cuda:0]``."""

from __future__ import annotations

import argparse

from deflatedmlmc_schwinger_tpu_torch.gateway import ENTRIES


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m deflatedmlmc_schwinger_tpu_torch")
    ap.add_argument("entry", choices=sorted(ENTRIES))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    ENTRIES[args.entry](device=args.device)


if __name__ == "__main__":
    main()
