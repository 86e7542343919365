"""Phase timing, program spans and host-read counters (the phase timer is
the counterpart of deflatedmlmc_schwinger_tpu/utils/timer.py).

``PhaseTimer``: coarse host-visible phases (setup, deflation setup, rough
trace, sampling) on the host clock, with ``torch.cuda.synchronize`` at each
phase edge when a CUDA device is in use, so a phase's time includes its
device work. Beside each phase's seconds it keeps the seconds this process
spent in the transport helper of parallel/distributed.py during the phase
(0 without a process group), the seconds it spent blocked in counted host
reads, its V-cycle graph calls (``graphs``) and its FGMRES graph calls
(``fgmres_graphs``).

``span(name)``: a range at a layer boundary of the sampling path
(estimator batch, FGMRES solve, cycle and Arnoldi step, V-cycle level, ...).
Spans are off by default, and then ``span`` returns one shared
``nullcontext`` and touches nothing else. ``set_spans(True)`` or
``with spans_on():`` makes each span a ``torch.profiler.record_function``
range, which lands in a profiler's trace on the clock of the device's
kernels. A span adds no host read, allocation, synchronisation or launch.

``host_read(site, read, *args)``: every host read of a device value on the
sampling path goes through it. It counts the read under ``site`` in
``host_reads`` with the nanoseconds the call blocked (always on), and is a
``host.read.<site>`` span when spans are on (a profiler's exported trace
keeps a range's name and drops its string argument, so the site is part of
the name).

``graph_calls``, the ``vcycle.graph`` counter: how often the coarse
V-cycle's CUDA graphs engage (mg/cycle.py ``CycleGraphs``): ``captures``,
``replays`` and ``eager`` calls, always on; the hit share is
replays / (replays + eager).

``fgmres_graph_calls``, the ``fgmres.graph`` counter: how often FGMRES's
step tails and cycle ends replay as CUDA graphs (solvers/fgmres.py
``KrylovWorkspace``): each call is one of ``captures``, ``replays`` and
``eager``, always on; the hit share is again replays / (replays + eager).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch

_NULL = nullcontext()
_spans = False

# site -> [reads, nanoseconds blocked] since the last reset_host_reads()
host_reads: Dict[str, List[int]] = defaultdict(lambda: [0, 0])

# the vcycle.graph counter: calls of a graphable V-cycle (mg/cycle.py
# CycleGraphs) that captured, replayed or ran eagerly, since the last
# reset_graph_calls()
graph_calls: Dict[str, int] = dict(captures=0, replays=0, eager=0)

# the fgmres.graph counter: FGMRES step tails and cycle ends (solvers/fgmres.py
# KrylovWorkspace) that captured, replayed or ran eagerly, since the last
# reset_fgmres_graph_calls()
fgmres_graph_calls: Dict[str, int] = dict(captures=0, replays=0, eager=0)


def set_spans(on: bool) -> None:
    """Turn the spans of this process on or off."""
    global _spans
    _spans = bool(on)


@contextmanager
def spans_on():
    """Spans on inside the block; the previous setting after it."""
    was = _spans
    set_spans(True)
    try:
        yield
    finally:
        set_spans(was)


def span(name: str):
    """A context manager around one layer's work: the shared nullcontext
    while spans are off, else a profiler range ``name``."""
    if not _spans:
        return _NULL
    return torch.profiler.record_function(name)


def host_read(site: str, read, *args):
    """``read(*args)``, a read that waits for the device, counted under
    ``site`` with the time it blocked."""
    t0 = time.perf_counter_ns()
    if _spans:
        with torch.profiler.record_function("host.read." + site):
            out = read(*args)
    else:
        out = read(*args)
    c = host_reads[site]
    c[0] += 1
    c[1] += time.perf_counter_ns() - t0
    return out


def reset_host_reads() -> None:
    host_reads.clear()


def host_read_totals() -> Dict[str, float]:
    """All sites together: {"reads": count, "seconds": seconds blocked}."""
    return dict(reads=sum(c[0] for c in host_reads.values()),
                seconds=1e-9 * sum(c[1] for c in host_reads.values()))


def reset_graph_calls() -> None:
    graph_calls.update(dict.fromkeys(graph_calls, 0))


def reset_fgmres_graph_calls() -> None:
    fgmres_graph_calls.update(dict.fromkeys(fgmres_graph_calls, 0))


class PhaseTimer:
    def __init__(self, device: Optional[torch.device] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.transport: Dict[str, float] = defaultdict(float)
        self.host_read: Dict[str, float] = defaultdict(float)
        self.graphs: Dict[str, Dict[str, int]] = defaultdict(
            lambda: dict.fromkeys(graph_calls, 0))
        self.fgmres_graphs: Dict[str, Dict[str, int]] = defaultdict(
            lambda: dict.fromkeys(fgmres_graph_calls, 0))
        self.device = None if device is None else torch.device(device)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def phase(self, name: str):
        # imported here: parallel/ imports the estimators, which import this
        from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import transport_stats

        with span("phase." + name):
            self._sync()
            t0 = time.perf_counter()
            moved0 = transport_stats["seconds"]
            read0 = host_read_totals()["seconds"]
            graphs0 = dict(graph_calls)
            fgmres0 = dict(fgmres_graph_calls)
            try:
                yield
            finally:
                self._sync()
                self.totals[name] += time.perf_counter() - t0
                self.transport[name] += transport_stats["seconds"] - moved0
                self.host_read[name] += host_read_totals()["seconds"] - read0
                for k, n in graph_calls.items():
                    self.graphs[name][k] += n - graphs0[k]
                for k, n in fgmres_graph_calls.items():
                    self.fgmres_graphs[name][k] += n - fgmres0[k]
                self.counts[name] += 1

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.transport.clear()
        self.host_read.clear()
        self.graphs.clear()
        self.fgmres_graphs.clear()

    def __str__(self) -> str:
        lines = ["\nTimings specific to computations:"]
        for name in sorted(self.totals):
            line = f" -- {name} : {self.totals[name]:.4f} s ({self.counts[name]} calls)"
            for what, calls in (("V-cycle", self.graphs), ("FGMRES", self.fgmres_graphs)):
                g = calls.get(name)
                if g and (g["captures"] or g["replays"]):
                    line += (f", {what} graphs {g['captures']} captured, {g['replays']} "
                             f"replayed, {g['eager']} eager")
            if self.host_read.get(name):
                line += f", {self.host_read[name]:.4f} s in host reads"
            lines.append(line)
        lines.append(f" -- accumulated time : {sum(self.totals.values()):.4f} s")
        return "\n".join(lines)
