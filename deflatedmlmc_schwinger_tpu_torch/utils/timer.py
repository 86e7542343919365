"""Phase timing (counterpart of deflatedmlmc_schwinger_tpu/utils/timer.py):
coarse host-visible phases (setup, deflation setup, rough trace, sampling)
on the host clock, with ``torch.cuda.synchronize`` at each phase edge when
a CUDA device is in use, so a phase's time includes its device work. Beside
each phase's seconds it keeps the seconds this process spent in the
transport helper of parallel/distributed.py during the phase (0 without a
process group)."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import torch


class PhaseTimer:
    def __init__(self, device: Optional[torch.device] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.transport: Dict[str, float] = defaultdict(float)
        self.device = None if device is None else torch.device(device)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def phase(self, name: str):
        # imported here: parallel/ imports the estimators, which import this
        from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import transport_stats

        self._sync()
        t0 = time.perf_counter()
        moved0 = transport_stats["seconds"]
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.transport[name] += transport_stats["seconds"] - moved0
            self.counts[name] += 1

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.transport.clear()

    def __str__(self) -> str:
        lines = ["\nTimings specific to computations:"]
        for name in sorted(self.totals):
            lines.append(
                f" -- {name} : {self.totals[name]:.4f} s ({self.counts[name]} calls)")
        lines.append(f" -- accumulated time : {sum(self.totals.values()):.4f} s")
        return "\n".join(lines)
