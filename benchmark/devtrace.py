"""Reading a torch.profiler trace of a stretch of batches: the device's
busy union, its idle gaps and what the host was doing in them, device time
by kernel name, and the calls of the stencil kernels with their shapes.

The grouping of device time by substrings of kernel names and the busy
arithmetic follow bench_torch/g102_batch.py ``GROUPS``/``report_profile``,
frozen here; the busy time is the union of the device intervals, so that
work on overlapping streams is not counted twice.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

# (group, substrings of the kernel's name); the first match wins
GROUPS = (
    ("K3", ("poly_tiled", "poly_step")),
    ("K1 + K2", ("stencil_rows", "stencil_matvec", "stencil_residual")),
    ("GEMM", ("gemm", "cutlass", "gemv", "cublas")),
    ("gather (index)", ("index",)),
    ("copy", ("copy", "memcpy", "Memcpy", "memset", "Memset")),
    ("elementwise and reductions", ("elementwise", "reduce", "vectorized")),
)


def group_of(name: str) -> str:
    return next((g for g, keys in GROUPS if any(k in name for k in keys)), "other")


@contextmanager
def recorded_calls(sk, calls: List[tuple]):
    """Record each call of the stencil kernel wrappers of module ``sk`` on a
    CUDA tensor as (kind, B, nx, nt, itemsize, roots, with_residual). The
    program looks them up as module attributes; each wrapper's launch
    counter is carried over and back."""
    def wrap(kind, fn):
        def w(coeffs, *args, **kw):
            out = fn(coeffs, *args, **kw)
            v = args[0]
            if v.is_cuda:
                nx, nt = coeffs.shape[-2], coeffs.shape[-1]
                B = v.numel() // (2 * nx * nt)
                roots = len(args[1]) if kind == "poly" else 0
                calls.append((kind, B, nx, nt, v.element_size(), roots,
                              bool(kw.get("with_residual", False))))
            return out
        w.launches = fn.launches
        return w

    names = {"stencil_matvec": "matvec", "stencil_residual": "residual",
             "stencil_poly_smooth": "poly"}
    orig = {n: getattr(sk, n) for n in names}
    for n, kind in names.items():
        setattr(sk, n, wrap(kind, orig[n]))
    try:
        yield calls
    finally:
        for n, fn in orig.items():
            fn.launches = getattr(sk, n).launches
            setattr(sk, n, fn)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read_trace(path: str) -> Dict:
    """From an exported chrome trace: the stretch's span (s), the device
    events inside it, the busy union, and the idle gaps labelled by the
    innermost host event that covers each gap's middle."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == STRETCH
             and e.get("cat") == "user_annotation"]
    if spans:
        t0 = float(spans[0]["ts"])
        t1 = t0 + float(spans[0]["dur"])
    else:
        # a trace without host operators: the stretch spans the runtime
        # calls that enqueued it and the device work they enqueued
        ext = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS + ("cuda_runtime",)]
        if not ext:
            return {}
        t0, t1 = min(a for a, _ in ext), max(b for _, b in ext)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if b <= t0 or a >= t1:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((max(a, t0), min(b, t1), e.get("name", "")))
        elif e.get("cat") in HOST_CATS and e.get("name") != STRETCH:
            host.append((a, b, e.get("name", "")))
    busy = _merge([(a, b) for a, b, _ in dev])
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if prev < t1:
        gaps.append((prev, t1))
    idle_by = defaultdict(float)
    host.sort()
    active: List[tuple] = []
    i = 0
    for a, b in gaps:             # gaps and host events both in time order
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        label = min(active, key=lambda h: h[1] - h[0])[2] if active else "host Python"
        idle_by[label] += (b - a) * 1e-6
    by_name = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) * 1e-6
    return dict(
        window_s=(t1 - t0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=len(dev),
        by_name=dict(by_name),
        idle_by=dict(idle_by),
    )


def profile_stretch(run_batches, trace_dir: str, host: bool):
    """Run ``run_batches()`` under torch.profiler inside the stretch's
    annotation and return ``read_trace`` of it. ``host``: record the host's
    operators too, which the labels of the idle gaps need and which slows
    the host by several microseconds per operator, so that the device
    idles longer than it would; without it the trace holds the device's
    work and the runtime calls that enqueued it. The trace file lives in
    ``trace_dir`` only while it is read."""
    import torch

    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            run_batches()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=trace_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_trace(path)
    finally:
        os.unlink(path)


def group_seconds(by_name: Dict[str, float]) -> Dict[str, float]:
    out = defaultdict(float)
    for name, s in by_name.items():
        out[group_of(name)] += s
    return dict(out)


def top(d: Dict[str, float], k: int = 10) -> List[list]:
    return [[name[:160], s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
