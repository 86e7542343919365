"""Process-group orchestration, the transport helper and the statistics
reductions (counterpart of deflatedmlmc_schwinger_tpu/parallel/distributed.py).

The JAX package is single-controller: one process sees a global array and
XLA inserts the collectives. Here every mesh position is one process (rank)
of ``torch.distributed``, so each function is described by what every rank
holds before and after the call.

Backend: ``nccl`` when every rank has a card of its own, else ``gloo``
(several ranks may then share one card). gloo moves host memory only, so
the transport helper stages CUDA tensors through the host explicitly and
sends complex tensors as (re, im) reals; all arithmetic stays on the
rank's device. The helper is the only place that touches
``torch.distributed`` collectives: sums, the any-reduce of the loop
predicates, rank-ordered all-gathers and the ring exchange of the halo rows.

Probes are counter-keyed (trace/probes.py), so every rank can make the full
batch and the estimate does not depend on the number of ranks.
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deflatedmlmc_schwinger_tpu_torch.trace.stats import RunningMoments
from deflatedmlmc_schwinger_tpu_torch.utils.timer import span


@dataclasses.dataclass(frozen=True)
class Group:
    """One communicator: the torch process group, its members' global ranks
    in group order, and this rank's position among them."""

    pg: object
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device="cuda",
    timeout_s: float = 1800.0,
) -> int:
    """Join the process group from the arguments or torch's standard
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    no-op for one process or when the group already exists. Returns the
    rank. ``device='cpu'`` keeps the ranks on the host (gloo); otherwise
    rank r works on ``cuda:{LOCAL_RANK % device_count}``, over nccl when
    every rank has a card of its own and over gloo when ranks share one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    world_size = int(world_size if world_size is not None else env.get("WORLD_SIZE", "1"))
    if world_size == 1:
        return 0
    rank = int(rank if rank is not None else env["RANK"])
    if init_method is None:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    backend = "gloo"
    if torch.device(device).type == "cuda":
        ncards = torch.cuda.device_count()
        if ncards == 0:
            raise RuntimeError("initialize(device='cuda'): no CUDA device found")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % ncards)
        if world_size <= ncards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        where = rank_device(device)
        shared = (", ranks share cards" if where.type == "cuda"
                  and world_size > torch.cuda.device_count() else "")
        print(f"process group: {world_size} ranks over {backend} on {where.type}{shared}",
              flush=True)
    return rank


def rank_device(device="cuda") -> torch.device:
    """The device this rank works on: the current CUDA device (set by
    ``initialize``) or the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def world_group() -> Group:
    n = dist.get_world_size()
    return Group(dist.group.WORLD, tuple(range(n)), dist.get_rank())


# ---- transport ---------------------------------------------------------------

# What this process has spent in the transport helper since the last reset:
# calls, payload bytes handed to the backend, and host seconds. Over gloo the
# seconds run from the moment the device has finished the work queued before
# the call (staging and communication, not a wait for earlier kernels). Over
# nccl a collective is ordered on the stream and the host does not wait for
# it, so the seconds are only the host's time to queue it.
transport_stats = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_transport_stats() -> None:
    transport_stats.update(calls=0, bytes=0, seconds=0.0)


class _Timed:
    """Times one transport call into ``transport_stats``, inside a
    ``transport.<op>`` span (utils/timer.py)."""

    def __init__(self, g: Group, op: str, *tensors: torch.Tensor):
        self.tensors = tensors
        self.gloo = dist.get_backend(g.pg) == "gloo"
        self.span = span("transport." + op)

    def __enter__(self):
        self.span.__enter__()
        # gloo's staging copy to the host waits for the device in any case;
        # waiting first keeps that wait out of the seconds. nccl gets no
        # wait: its collectives stay ordered on the stream.
        if self.gloo:
            for t in self.tensors:
                if t.is_cuda:
                    torch.cuda.current_stream(t.device).synchronize()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        transport_stats["calls"] += 1
        transport_stats["bytes"] += sum(t.numel() * t.element_size() for t in self.tensors)
        transport_stats["seconds"] += time.perf_counter() - self.t0
        self.span.__exit__(*exc)


def _stage(t: torch.Tensor, g: Group) -> torch.Tensor:
    """A real, contiguous copy of ``t`` that the group's backend can move
    and write into: on the host for gloo, on the device for nccl (a copy
    ordered on the stream, with no wait on the host)."""
    t = t.detach()
    r = torch.view_as_real(t.resolve_conj()) if t.is_complex() else t
    if t.is_cuda and dist.get_backend(g.pg) == "gloo":
        return r.contiguous().cpu()
    return r.clone(memory_format=torch.contiguous_format)


def _unstage(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    out = r.to(like.device)
    return torch.view_as_complex(out) if like.is_complex() else out


def all_sum(t: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """Sum of ``t`` over the group, on every member."""
    if g is None or g.size == 1:
        return t
    with _Timed(g, "all_sum", t):
        buf = _stage(t, g)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g.pg)
        return _unstage(buf, t)


def all_any(flag, g: Optional[Group]) -> bool:
    """True on every member when ``flag`` (a bool or a 0-dim tensor) is
    true on any member. Loop predicates must pass through this before they
    steer a loop with collectives inside: members that disagree on a trip
    count leave the others waiting in the next collective."""
    if g is None or g.size == 1:
        return bool(flag)
    mine = bool(flag)      # waits for the device where the flag lives there
    buf = torch.tensor([1 if mine else 0], dtype=torch.int32)
    with _Timed(g, "all_any", buf):
        if dist.get_backend(g.pg) == "nccl":
            buf = buf.cuda()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=g.pg)
        return bool(buf.item())


def all_gather_cat(t: torch.Tensor, g: Optional[Group], dim: int = 0) -> torch.Tensor:
    """The members' tensors (equal shapes) concatenated along ``dim`` in
    group order, on every member."""
    if g is None or g.size == 1:
        return t
    with _Timed(g, "all_gather_cat", t):
        buf = _stage(t, g)
        parts = [torch.empty_like(buf) for _ in range(g.size)]
        dist.all_gather(parts, buf, group=g.pg)
        d = dim if dim >= 0 else dim + t.dim()
        return torch.cat([_unstage(p, t) for p in parts], dim=d)


def ring_exchange(to_prev: torch.Tensor, to_next: torch.Tensor, g: Group):
    """Send ``to_prev`` to the previous member of the ring and ``to_next`` to
    the next; returns (what the next member sent back, what the previous
    member sent on), i.e. (from_next, from_prev)."""
    prev = g.ranks[(g.index - 1) % g.size]
    nxt = g.ranks[(g.index + 1) % g.size]
    with _Timed(g, "ring_exchange", to_prev, to_next):
        s_prev, s_next = _stage(to_prev, g), _stage(to_next, g)
        r_next, r_prev = torch.empty_like(s_prev), torch.empty_like(s_next)
        # tag 0 travels down the ring, tag 1 up; on a ring of two both peers
        # are the same rank, and the order of posting keeps the two messages
        # apart
        ops = [dist.P2POp(dist.isend, s_prev, prev, group=g.pg, tag=0),
               dist.P2POp(dist.isend, s_next, nxt, group=g.pg, tag=1),
               dist.P2POp(dist.irecv, r_next, nxt, group=g.pg, tag=0),
               dist.P2POp(dist.irecv, r_prev, prev, group=g.pg, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return _unstage(r_next, to_prev), _unstage(r_prev, to_next)


def broadcast_object(obj, g: Group, device, src: int = 0):
    """``obj`` of group member ``src`` (anything ``torch.save`` takes), on
    every member with its tensors on ``device``; the source keeps its own."""
    if g.size == 1:
        return obj
    me = g.index == src
    payload = b""
    if me:
        f = io.BytesIO()
        torch.save(obj, f)
        payload = f.getvalue()
    nccl = dist.get_backend(g.pg) == "nccl"
    size = torch.tensor([len(payload)], dtype=torch.int64)
    size = size.cuda() if nccl else size
    dist.broadcast(size, src=g.ranks[src], group=g.pg)
    if me:
        data = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    else:
        data = torch.empty(int(size.item()), dtype=torch.uint8)
    with _Timed(g, "broadcast_object", data):
        data = data.cuda() if nccl else data
        dist.broadcast(data, src=g.ranks[src], group=g.pg)
    if me:
        return obj
    return torch.load(io.BytesIO(data.cpu().numpy().tobytes()), map_location=device,
                      weights_only=False)


# ---- batches and statistics --------------------------------------------------

def global_values(a: torch.Tensor, mesh=None, axis: str = "samples") -> np.ndarray:
    """The full host value, in global sample order and on every rank, of a
    tensor whose leading dim is split over the mesh's ``axis`` (this rank
    holds its rows). Every rank sees the identical estimate stream, so
    moments, stopping decisions and logs agree with no further reduction.
    Without a mesh the tensor is whole and just pulled to the host."""
    if mesh is not None:
        a = all_gather_cat(a, mesh.groups[axis], dim=0)
    return a.detach().cpu().numpy()


def shard_global_batch(x: torch.Tensor, mesh, axis: str = "samples") -> torch.Tensor:
    """This rank's rows of a (B, ...) batch that every rank holds whole."""
    n = mesh.shape[axis]
    B = x.shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows not divisible by mesh axis {n}")
    i = mesh.coords[axis]
    return x[i * (B // n):(i + 1) * (B // n)]


def moments_parts(es: torch.Tensor):
    """Per-rank raw moment sums (count, sum_re, sum_im, sum |e|^2) of a batch
    of complex estimates: the additive form of RunningMoments."""
    rdt = es.real.dtype
    cnt = torch.tensor(float(es.numel()), dtype=rdt, device=es.device)
    return cnt, es.real.sum(), es.imag.sum(), (es.real ** 2 + es.imag ** 2).sum()


def psum_moments(es: torch.Tensor, group: Optional[Group]):
    """Moment reduction over a group: returns (count, mean_re, mean_im, m2)
    with m2 = sum |e - mean|^2 over all members' estimates. Raw sums are
    additive, so one sum of (n, sum, sum_sq) is the Chan merge of all."""
    parts = all_sum(torch.stack(moments_parts(es)), group)
    cnt, s_re, s_im, sq = parts.unbind(0)
    mean_re = s_re / cnt
    mean_im = s_im / cnt
    # sq - |mean|^2 n cancels in float32 when |mean| >> std; clamp so that a
    # later sqrt never sees a negative m2
    m2 = torch.clamp(sq - (mean_re * mean_re + mean_im * mean_im) * cnt, min=0.0)
    return cnt, mean_re, mean_im, m2


def allgather_moments(local: RunningMoments, group: Optional[Group] = None) -> RunningMoments:
    """Merge per-rank RunningMoments across the group (default: all ranks),
    on the host in float64. One process: returns ``local`` unchanged."""
    if not (dist.is_available() and dist.is_initialized()):
        return local
    group = group or world_group()
    if group.size == 1:
        return local
    n = float(local.count)
    s_re, s_im = local.mean.real * n, local.mean.imag * n
    sq = float(local.m2) + ((s_re ** 2 + s_im ** 2) / n if n else 0.0)
    parts = torch.tensor([n, s_re, s_im, sq], dtype=torch.float64)
    if dist.get_backend(group.pg) == "nccl":
        parts = parts.cuda()
    tot = all_gather_cat(parts[None], group, dim=0).sum(0).tolist()
    n = tot[0]
    if n == 0:
        return RunningMoments()
    mean = complex(tot[1] / n, tot[2] / n)
    return RunningMoments(count=int(n), mean=mean,
                          m2=max(float(tot[3] - (abs(mean) ** 2) * n), 0.0))
