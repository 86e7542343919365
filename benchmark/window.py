"""The timed window: the estimator's own sampling loop, trace/stats.py
``sample_to_stop``, over the estimator's ``step``, in chunks.

The window is a closed loop: one caller waits for each batch, as the
estimator does, and the loop keeps its pipelining (it reads its stop and
stall flags two batches late). The stopping rule never ends it: its target
is 0. A chunk is one ``sample_to_stop`` call with ``max_nr_ests`` set to the
chunk's probes; the first chunk is sized from the warm-up to about 85% of
the window, the next ones to what is left, so the window ends at its
deadline with a host read only at the end of a chunk. The step wrapper
records a CUDA event before each batch (device-stream time between
batches), keeps the batch's device tensors, and offsets the probe index so
that the probe stream continues across chunks.

The program's solutions of the batches chosen for the check are kept by a
pass-through around the estimator's ``solver.solve`` (a copy of the
level-0 solution of that batch; nothing else changes).
"""

from __future__ import annotations

import time
from typing import List, Set

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.trace.stats import sample_to_stop


class Window:
    def __init__(self, est, cfg, device: torch.device):
        self.est, self.cfg, self.device = est, cfg, device
        self.B = est.B
        self.base = 0                  # global index of the next chunk's first probe
        self.keep: Set[int] = set()    # batch indices whose solutions are kept
        self.kept = {}
        self._batch = None
        self.reset()
        solve = est.solver.solve

        def kept_solve(b, tol, **kw):
            res = solve(b, tol, **kw)
            k = self._batch
            if k in self.keep and kw.get("level", 0) == 0 and k not in self.kept:
                self.kept[k] = res.x.clone()
            return res

        est.solver.solve = kept_solve

    def reset(self) -> None:
        self.marks: List = []
        self.starts: List[int] = []
        self.es: List[torch.Tensor] = []
        self.iters: List[torch.Tensor] = []
        self.stalls: List[torch.Tensor] = []

    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, start: int):
        s = self.base + start
        self.marks.append(self._mark())
        self.starts.append(s)
        self._batch = s // self.B
        try:
            e, it, st = self.est.step(s)
        finally:
            self._batch = None
        self.es.append(e)
        self.iters.append(it)
        self.stalls.append(st)
        return e, it, st

    def chunk(self, batches: int) -> None:
        cfg = self.cfg.replace(max_nr_ests=int(batches) * self.B)
        sample_to_stop(self.step, cfg, 0.0, self.est.where, self.est.rdtype, self.device)
        self.base += int(batches) * self.B

    def warm_up(self, batches: int) -> float:
        """Run ``batches`` batches; returns seconds per batch."""
        self._sync()
        t = time.perf_counter()
        self.chunk(batches)
        self._sync()
        dt = (time.perf_counter() - t) / batches
        self.reset()
        return dt

    def first_chunk(self, seconds: float, t_batch: float) -> int:
        """Batches of the window's first chunk: about 85% of the window at
        the warm-up's pace, and no fewer than the batches to be checked."""
        return max(3, len(self.keep), int(0.85 * seconds / t_batch))

    def choose_checked(self, count: int, seed: int, seconds: float, t_batch: float) -> None:
        """Keep the solutions of ``count`` batches drawn from ``seed`` among
        the next window's first chunk."""
        span = max(count, self.first_chunk(seconds, t_batch))
        first = self.base // self.B
        self.keep = {first + int(k) for k in
                     np.random.default_rng(seed).choice(span, size=count, replace=False)}

    def run(self, seconds: float, t_batch: float) -> None:
        """Sample for ``seconds``; ``t_batch`` is the warm-up's seconds per
        batch. Sets ``self.seconds`` (host clock, first enqueue to the
        synchronised end) and the end mark."""
        self.reset()
        self._sync()
        t0 = time.perf_counter()
        nb = self.first_chunk(seconds, t_batch)
        while True:
            self.chunk(nb)
            elapsed = time.perf_counter() - t0
            t_batch = elapsed / len(self.es)
            left = seconds - elapsed
            if left < 0.5 * t_batch:
                break
            nb = max(3, int(round(left / t_batch)))
        self.end_mark = self._mark()
        self._sync()
        self.seconds = time.perf_counter() - t0

    def batch_seconds(self) -> List[float]:
        marks = self.marks + [self.end_mark]
        if self.device.type == "cuda":
            return [1e-3 * a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        return [b - a for a, b in zip(marks[:-1], marks[1:])]

    def host_arrays(self):
        """(estimates complex128 (N,), per-batch max iterations, total
        iterations, stalled rows) of the window's batches."""
        es = torch.cat([e.reshape(-1) for e in self.es]).cpu().numpy().astype(np.complex128)
        its = torch.stack([i.max() for i in self.iters]).cpu().numpy()
        total = int(sum(int(i.sum()) for i in self.iters))
        stalled = int(sum(int(s.sum()) for s in self.stalls))
        return es, [int(v) for v in its], total, stalled
