"""Rademacher probe generation (counterpart of
deflatedmlmc_schwinger_tpu/trace/probes.py).

Two sources, both returning f(start, batch, n, dtype) -> (B, n) complex
tensor on the chosen device:
  * 'torch' (production): drawn on the device; probe s depends only on
    (seed, s), so estimates do not depend on the batch size;
  * 'numpy' (matched runs against the JAX package): the reference's exact
    sequential stream ``RandomState(seed).randint(2, size=n)*2-1``. It is
    sequential by nature, so a draw that does not continue where the last
    one ended raises instead of replaying the stream.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class NumpyProbeStream:
    """Sequential host-side Rademacher stream matching the reference."""

    def __init__(self, seed: int, device):
        self.state = np.random.RandomState(seed)
        self.device = torch.device(device)
        self.next_index = 0

    def __call__(self, start: int, batch: int, n: int,
                 dtype: torch.dtype) -> torch.Tensor:
        if start != self.next_index:
            raise ValueError(f"the numpy probe stream is sequential: asked for "
                             f"sample {start}, next is {self.next_index}")
        out = np.empty((batch, n), dtype=np.int64)
        for b in range(batch):
            out[b] = self.state.randint(2, size=n) * 2 - 1
        self.next_index += batch
        return torch.from_numpy(out).to(device=self.device, dtype=dtype)


class TorchProbeSource:
    """Counter-keyed device Rademacher probes: probe s comes from a
    generator seeded by a hash of (seed, s)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def __call__(self, start: int, batch: int, n: int,
                 dtype: torch.dtype) -> torch.Tensor:
        out = torch.empty((batch, n), dtype=torch.int8, device=self.device)
        for b in range(batch):
            key = np.random.SeedSequence([self.seed, start + b]).generate_state(1)
            self.gen.manual_seed(int(key[0]))
            torch.randint(0, 2, (n,), generator=self.gen, device=self.device,
                          dtype=torch.int8, out=out[b])
        return (out * 2 - 1).to(dtype)


def make_probe_source(source: str, seed: int, device) -> Callable:
    """Returns f(start, batch, n, dtype) -> (B, n) complex probe batch."""
    if source == "torch":
        return TorchProbeSource(seed, device)
    if source == "numpy":
        return NumpyProbeStream(seed, device)
    raise ValueError(f"unknown probe source {source!r}")
