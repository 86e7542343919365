"""Running sample statistics and the reference's stopping rule (counterpart
of deflatedmlmc_schwinger_tpu/trace/stats.py).

Population deviation dev = sqrt(mean |e - mean|^2); stop when n >= 6 and
dev/sqrt(n) < target. Batches merge with the Chan/Welford update, on the
host (RunningMoments) or as device scalars (DeviceMoments) so that the
sampling loop reads only one small flag tensor per batch. The two sampling
loops live here: ``sample_to_stop`` keeps the moments on the device, and
``sample_to_stop_host`` gathers every batch, which a checkpointed run needs
(its state is saved after each batch). ``sample_to_stop``'s host reads
count under the sites ``sample.flags`` (the lagged flags of each batch) and
``sample.end`` (the moments, iterations and stalled rows at the loop's end)
in utils/timer.py ``host_reads``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.utils.timer import host_read


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


class HostCopy:
    """A small device tensor copied to the host without waiting for work
    queued after it: pinned buffer + non-blocking copy + event."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def tolist(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


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


def sample_to_stop(step: Callable[[int], tuple], cfg, tol_target: float, where: str,
                   rdtype: torch.dtype, device):
    """Sample batches of ``cfg.probe_batch`` until the standard error falls
    below ``tol_target`` (with at least ``cfg.min_nr_ests`` samples) or
    ``cfg.max_nr_ests`` is reached. ``step(start)`` returns the batch's
    device tensors (estimates, solver iterations, stalled flags).

    The moments stay on the device. The [stop, stalled] flags are copied to
    the host asynchronously and read two batches late, so the host never
    holds up the batches in flight; consecutive reads are one batch apart,
    which is what ConfirmedStop (cfg.stop_confirm) expects, and a matched
    run stops at the same sample count as the JAX package. Raises when more
    than ``cfg.max_stalled_frac`` of the rows stalled. Returns (host
    RunningMoments, total iterations, stalled rows)."""
    B = int(cfg.probe_batch)
    dm = device_moments_init(rdtype, device)
    stall_acc = torch.zeros((), dtype=torch.int32, device=device)
    inflight = []
    stopper = ConfirmedStop(cfg.stop_confirm)
    start = 0
    while start < cfg.max_nr_ests:
        e, iters, stall = step(start)
        dm = device_moments_update(dm, e, iters)
        stall_acc = stall_acc + stall.sum().to(torch.int32)
        start += B
        flag = device_stop_and_stalled(dm, tol_target, cfg.min_nr_ests, stall_acc)
        inflight.append((start, HostCopy(flag)))
        if len(inflight) > 2:
            seen, pending = inflight.pop(0)
            stop, nstall = host_read("sample.flags", pending.tolist)
            check_stalled(nstall, seen, cfg.max_stalled_frac, where)
            if stopper(bool(stop), seen):
                break
    moments, iters, nstall = host_read("sample.end", _loop_end, dm, stall_acc)
    check_stalled(nstall, start, cfg.max_stalled_frac, where)
    return moments, iters, nstall


def _loop_end(dm: DeviceMoments, stall_acc: torch.Tensor):
    """The sampling loop's host numbers: (moments, iterations, stalled rows)."""
    nstall = int(stall_acc.item())
    return device_moments_to_host(dm), int(dm.iters.item()), nstall


def sample_to_stop_host(step: Callable[[int], tuple], cfg, tol_target: float,
                        moments: RunningMoments, start: int,
                        after_batch: Callable[[tuple, int], None],
                        check_before_batch: bool = False):
    """The host-gathered sampling loop, for runs that save their state after
    every batch: ``step(start)`` returns host arrays, the batch's estimates
    first; they are merged into ``moments`` (carried over from a resumed
    state), and ``after_batch(batch, next_start)`` does the estimator's
    bookkeeping (iteration counts, the stall policy, the state file). The
    stopping rule is read right after each batch or, with
    ``check_before_batch``, before the next one (the MLMC levels, whose
    resumed state may already meet the rule). Returns the next sample
    index."""
    B = int(cfg.probe_batch)
    stopper = ConfirmedStop(cfg.stop_confirm)

    def stop() -> bool:
        return stopper(should_stop(moments, tol_target, cfg.min_nr_ests), moments.count)

    while start < cfg.max_nr_ests:
        if check_before_batch and stop():
            break
        batch = step(start)
        moments.update_batch(batch[0])
        start += B
        after_batch(batch, start)
        if not check_before_batch and stop():
            break
    return start
