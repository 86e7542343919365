"""Running sample statistics and the reference's stopping rule (counterpart
of deflatedmlmc_schwinger_tpu/trace/stats.py).

Population deviation dev = sqrt(mean |e - mean|^2); stop when n >= 6 and
dev/sqrt(n) < target. Batches merge with the Chan/Welford update, on the
host (RunningMoments) or as device scalars (DeviceMoments) so that the
sampling loop reads only one small flag tensor per batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass
class RunningMoments:
    count: int = 0
    mean: complex = 0.0 + 0.0j
    m2: float = 0.0  # sum |e - mean|^2

    def update_batch(self, es: np.ndarray) -> None:
        es = np.asarray(es).ravel()
        nb = es.size
        if nb == 0:
            return
        bmean = complex(es.mean())
        bm2 = float(np.sum(np.abs(es - bmean) ** 2))
        if self.count == 0:
            self.count, self.mean, self.m2 = nb, bmean, bm2
            return
        na = self.count
        delta = bmean - self.mean
        tot = na + nb
        self.mean = self.mean + delta * (nb / tot)
        self.m2 = self.m2 + bm2 + (abs(delta) ** 2) * na * nb / tot
        self.count = tot

    @property
    def std_dev(self) -> float:
        """Population standard deviation sqrt(m2/n)."""
        return float(np.sqrt(self.m2 / self.count)) if self.count else 0.0

    @property
    def error_est(self) -> float:
        """Standard error dev/sqrt(n)."""
        return self.std_dev / np.sqrt(self.count) if self.count else np.inf

    def merge(self, other: "RunningMoments") -> "RunningMoments":
        out = RunningMoments(self.count, self.mean, self.m2)
        if other.count:
            na, nb = out.count, other.count
            if na == 0:
                return RunningMoments(other.count, other.mean, other.m2)
            delta = other.mean - out.mean
            tot = na + nb
            out.mean = out.mean + delta * (nb / tot)
            out.m2 = out.m2 + other.m2 + (abs(delta) ** 2) * na * nb / tot
            out.count = tot
        return out


def should_stop(m: RunningMoments, tol_target: float, min_samples: int) -> bool:
    return bool(m.count >= min_samples and m.error_est < tol_target)


class ConfirmedStop:
    """Two-pass stopping guard (config stop_confirm): with ``enabled`` the
    loop stops only when the condition holds on two checks separated by at
    least one more batch; any failing check in between disarms it."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        self._armed_at: Optional[int] = None

    def __call__(self, condition_ok: bool, count: int) -> bool:
        if not condition_ok:
            self._armed_at = None
            return False
        if not self.enabled:
            return True
        if self._armed_at is None:
            self._armed_at = int(count)
            return False
        return int(count) > self._armed_at


def check_stalled(nstalled: int, nsamples: int, max_frac: float, where: str) -> None:
    """Raise when the running fraction of stalled (under-solved) probe rows
    exceeds ``max_frac``: they bias the trace in a way the stopping rule
    cannot see."""
    if nsamples > 0 and nstalled > max_frac * nsamples:
        raise RuntimeError(
            f"{where}: {nstalled}/{nsamples} probe solves stalled above the "
            f"requested tolerance (max_stalled_frac={max_frac}). The trace "
            "estimate would be biased by under-solved probes; loosen "
            "function_tol toward the dtype's attainable residual floor "
            "(SolverConfig.tol_floor), raise restart/max_restarts, or relax "
            "max_stalled_frac if the bias is separately bounded."
        )


class DeviceMoments(NamedTuple):
    count: torch.Tensor   # () real
    mean_re: torch.Tensor
    mean_im: torch.Tensor
    m2: torch.Tensor
    iters: torch.Tensor   # accumulated solver iterations


def device_moments_init(rdtype: torch.dtype, device) -> DeviceMoments:
    z = torch.zeros((), dtype=rdtype, device=device)
    return DeviceMoments(z, z, z, z, z)


def device_moments_update(dm: DeviceMoments, es: torch.Tensor,
                          iters: torch.Tensor) -> DeviceMoments:
    """Chan-merge a batch of complex estimates into the device moments
    (the arithmetic of RunningMoments.update_batch)."""
    es_re, es_im = es.real, es.imag
    bre = es_re.mean()
    # a fill, not a host->device copy: a copy from pageable host memory
    # would wait for the stream and break the sampling loop's lag
    nb = torch.full_like(bre, float(es_re.numel()))
    bim = es_im.mean()
    bm2 = ((es_re - bre) ** 2 + (es_im - bim) ** 2).sum()
    na = dm.count
    tot = na + nb
    dre = bre - dm.mean_re
    dim = bim - dm.mean_im
    first = na <= 0
    f = torch.where(first, torch.ones_like(tot), nb / tot)
    mean_re = torch.where(first, bre, dm.mean_re + dre * f)
    mean_im = torch.where(first, bim, dm.mean_im + dim * f)
    m2 = torch.where(first, bm2, dm.m2 + bm2 + (dre * dre + dim * dim) * na * nb / tot)
    return DeviceMoments(tot, mean_re, mean_im, m2,
                         dm.iters + iters.sum().to(dm.iters.dtype))


def device_should_stop(dm: DeviceMoments, tol_target: float,
                       min_samples: int) -> torch.Tensor:
    n = torch.clamp(dm.count, min=1.0)
    err = torch.sqrt(dm.m2 / n) / torch.sqrt(n)
    return (dm.count >= min_samples) & (err < tol_target)


def device_stop_and_stalled(dm: DeviceMoments, tol_target: float,
                            min_samples: int,
                            stalled_acc: torch.Tensor) -> torch.Tensor:
    """(2,) int32 [stop flag, stalled row count]: one host read per batch
    carries both the stopping decision and the stall-policy counter."""
    stop = device_should_stop(dm, tol_target, min_samples)
    return torch.stack([stop.to(torch.int32), stalled_acc.to(torch.int32)])


def device_moments_to_host(dm: DeviceMoments) -> RunningMoments:
    return RunningMoments(
        count=int(dm.count.item()),
        mean=complex(float(dm.mean_re.item()), float(dm.mean_im.item())),
        m2=float(dm.m2.item()),
    )
