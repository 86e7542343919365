"""The CUDA-graph cache of the port: the V-cycle's coarse sub-cycle
(mg/cycle.py ``CycleGraphs``) and FGMRES's step tails and cycle ends
(solvers/fgmres.py ``KrylovWorkspace``) replay through it.

A ``GraphCache`` decides each call one way, by its key:

  * eager: the key's first call, a call past ``max_keys`` captured graphs,
    and a call whose key is None (its owner cannot graph it: CPU tensors,
    or FGMRES buffers made fresh for one solve);
  * capture: the key's second call. The pool's side stream waits on the
    current stream and runs ``fn`` once, which is the call's application
    (its result is what the call returns, and it warms the side stream up),
    then ``fn`` is recorded there into the pool without being run, and the
    current stream waits on the side stream;
  * replay: every later call. Inside ``span(span_name)`` the call's inputs
    are copied into the graph's static inputs, the graph is replayed, and a
    clone of the recorded output is returned, so that the next replay
    cannot overwrite what a caller holds.

Each call adds 1 to exactly one of ``captures``, ``replays`` and ``eager``
of its counter in utils/timer.py ``graph_calls``. A graph holds the
pointers of every tensor it read: it lives in the cache, which the object
that holds those tensors owns.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional

import torch

from deflatedmlmc_schwinger_tpu_torch.utils.timer import graph_calls, span


class GraphPool:
    """The side stream and the device memory pool that the CUDA graphs of
    one owner share on ``device``; both are made at its first capture."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = None
        self.handle = None


class GraphCache:
    """CUDA graphs keyed by the caller's ``key``, captured into ``pool``, at
    most ``max_keys`` of them (None: as many as there are keys), counted
    under ``counter`` (a name of utils/timer.py ``graph_calls``)."""

    def __init__(self, counter: str, pool: GraphPool, max_keys: Optional[int]):
        self.calls = graph_calls[counter]
        self.pool = pool
        self.max_keys = max_keys
        self._seen = set()
        self._graphs: Dict[Hashable, tuple] = {}

    def _route(self, key) -> str:
        """What a call with this key does: "replay", "capture" or "eager"."""
        if key is None:
            return "eager"
        if key in self._graphs:
            return "replay"
        if key not in self._seen:
            self._seen.add(key)
            return "eager"
        if self.max_keys is not None and len(self._graphs) >= self.max_keys:
            return "eager"
        return "capture"

    def run(self, key, fn: Callable, span_name: str, *inputs: torch.Tensor):
        """``fn(*inputs)``, a tensor or None, applied once: eagerly, by a
        capturing call or by a replay of the key's graph."""
        route = self._route(key)
        self.calls["eager" if route == "eager" else route + "s"] += 1
        if route == "eager":
            return fn(*inputs)
        if route == "capture":
            out, self._graphs[key] = self._capture(fn, inputs)
            return out
        graph, static, recorded = self._graphs[key]
        with span(span_name):
            for s, t in zip(static, inputs):
                s.copy_(t)
            graph.replay()
            return None if recorded is None else recorded.clone()

    def _capture(self, fn: Callable, inputs: tuple):
        """PyTorch's side-stream recipe with the warm-up as the call's one
        application: returns (the warm-up's output, (graph, static inputs,
        recorded output)). The warm-up's output is made on the side stream;
        the side stream is next used by a capture, after it waits on the
        current stream, so its memory is not reused while the caller reads
        it."""
        pool = self.pool
        with torch.cuda.device(pool.device):
            if pool.stream is None:
                pool.stream = torch.cuda.Stream()
            static = tuple(t.clone(memory_format=torch.contiguous_format) for t in inputs)
            pool.stream.wait_stream(torch.cuda.current_stream())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(pool.stream):
                out = fn(*static)
                graph.capture_begin(pool=pool.handle)
                try:
                    recorded = fn(*static)
                finally:
                    graph.capture_end()
            torch.cuda.current_stream().wait_stream(pool.stream)
        if pool.handle is None:
            pool.handle = graph.pool()
        return out, (graph, static, recorded)
