"""The span pass: a stretch of batches under torch.profiler with host and
device activities and the program's spans on (deflatedmlmc_schwinger_tpu_torch
utils/timer.py), and its reading.

Every device operation (kernel, copy, fill) is attributed to the innermost
program span around the CUDA runtime or driver-API call that launched it;
the two are linked by the trace's ``correlation`` ids, and the span is found
on the launching thread. Every idle gap of the device is labelled by the innermost
program span over its middle on the thread that ran the stretch; aten
operators are not program spans and do not label. The device time is then
grouped by layer:

    vcycle.fine    under a ``vcycle.l0.*`` span
    vcycle.coarse  under ``vcycle.l{>=1}.*`` or ``vcycle.coarsest``
    fgmres.own     under ``fgmres.*`` and under no ``vcycle*`` span
    est.own        under ``est.*`` and under no ``fgmres.*`` span

and what none of them holds is the unattributed rest.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from devtrace import DEVICE_CATS, STRETCH, _merge

PROGRAM = ("est.", "fgmres.", "vcycle", "host.read.", "transport.", "phase.")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GROUPS = ("fgmres.own", "vcycle.fine", "vcycle.coarse", "est.own")
NO_SPAN = "(no span)"


def group_of(path: Sequence[str]) -> Optional[str]:
    """The layer group of a stack of program spans (outermost first)."""
    if any(n.startswith("vcycle.l0.") for n in path):
        return "vcycle.fine"
    if any(n == "vcycle.coarsest" or n.startswith("vcycle.l") for n in path):
        return "vcycle.coarse"
    if any(n.startswith("vcycle") for n in path):
        return None
    if any(n.startswith("fgmres.") for n in path):
        return "fgmres.own"
    if any(n.startswith("est.") for n in path):
        return "est.own"
    return None


def _stacks(spans: List[Tuple[float, float, str]], points: List[float]) -> List[tuple]:
    """For each time in ``points``, the names of the spans of one thread
    that hold it, outermost first (spans nest on a thread)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    order = sorted(range(len(points)), key=lambda k: points[k])
    out: List[tuple] = [()] * len(points)
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for k in order:
        t = points[k]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = tuple(s[2] for s in stack if s[1] >= t)
    return out


def read_spans(path: str) -> Dict:
    """From an exported chrome trace of the span pass: the stretch's window
    and busy seconds, the device seconds of each layer group, of each
    innermost span and unattributed, the idle seconds by innermost span,
    and how many device operations were linked to their launch."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    stretch = [e for e in events if e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        return {}
    t0 = float(stretch[0]["ts"])
    t1 = t0 + float(stretch[0]["dur"])
    main = stretch[0].get("tid")
    spans = defaultdict(list)          # tid -> [(start, end, name)]
    launches = {}                      # correlation -> (tid, ts)
    dev = []                           # (start, end, correlation)
    for e in events:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation" and name.startswith(PROGRAM):
            spans[e.get("tid")].append((a, b, name))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), a)
        elif cat in DEVICE_CATS and b > t0 and a < t1:
            dev.append((max(a, t0), min(b, t1), (e.get("args") or {}).get("correlation")))

    # the span stack over each launch, thread by thread
    by_tid = defaultdict(list)
    for k, (_, _, corr) in enumerate(dev):
        if corr in launches:
            tid, ts = launches[corr]
            by_tid[tid].append((k, ts))
    path_of: Dict[int, tuple] = {}
    for tid, items in by_tid.items():
        for (k, _), p in zip(items, _stacks(spans[tid], [ts for _, ts in items])):
            path_of[k] = p
    groups = dict.fromkeys(GROUPS, 0.0)
    by_span = defaultdict(float)
    unattributed = unlinked = 0.0
    for k, (a, b, _) in enumerate(dev):
        s = (b - a) * 1e-6
        if k not in path_of:
            unlinked += s
            unattributed += s
            continue
        p = path_of[k]
        by_span[p[-1] if p else NO_SPAN] += s
        g = group_of(p)
        if g is None:
            unattributed += s
        else:
            groups[g] += s

    busy = _merge([(a, b) for a, b, _ in dev])
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if prev < t1:
        gaps.append((prev, t1))
    idle_by = defaultdict(float)
    for (a, b), p in zip(gaps, _stacks(spans[main], [0.5 * (a + b) for a, b in gaps])):
        idle_by[p[-1] if p else NO_SPAN] += (b - a) * 1e-6
    return dict(
        window_s=(t1 - t0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=len(dev),
        linked_ops=len(path_of),
        groups=groups,
        unattributed_s=unattributed,
        unlinked_s=unlinked,
        by_span=dict(by_span),
        idle_by_span=dict(idle_by),
    )


def span_pass(win, batches: int, trace_dir: str) -> Dict:
    """Run ``batches`` batches of the window's loop with the program's
    spans on under torch.profiler (host and device activities), after one
    such batch that takes the first-use cost, and return ``read_spans`` of
    the stretch with its batches and outer iterations."""
    import torch

    from deflatedmlmc_schwinger_tpu_torch.utils.timer import spans_on

    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with spans_on():
        for n in (1, batches):
            win.reset()
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(STRETCH):
                    win.chunk(n)
                    if cuda:
                        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=trace_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        read = read_spans(path)
    finally:
        os.unlink(path)
    if read:
        read.update(batches=batches, outer_iters=int(sum(int(i.max()) for i in win.iters)))
    return read


def group_ms_per_batch(ctx: Dict, group: str) -> Optional[float]:
    """Device ms per batch of one layer group in the span pass that a
    metric's context holds under ``ctx["trace"]["spans"]``; None where there
    was no such pass or it read no device operation."""
    sp = (ctx.get("trace") or {}).get("spans")
    if not sp or not sp.get("device_ops"):
        return None
    return 1e3 * sp["groups"][group] / sp["batches"]


def tables(sp: Dict) -> List[str]:
    """The pass's two tables as text: the share of busy time in each layer
    group and unattributed, and idle ms per batch by innermost span."""
    nb, busy = sp["batches"], sp["busy_s"]
    lines = [f"span pass: {nb} batches, busy {1e3 * busy / nb:.3f} ms/batch, window "
             f"{1e3 * sp['window_s'] / nb:.3f} ms/batch, {sp['linked_ops']} of "
             f"{sp['device_ops']} device operations linked to their launch",
             f"{'group':<24}{'ms/batch':>12}{'% of busy':>12}"]
    rows = list(sp["groups"].items()) + [("unattributed", sp["unattributed_s"])]
    for name, s in rows:
        lines.append(f"{name:<24}{1e3 * s / nb:>12.3f}{100 * s / busy:>12.2f}")
    lines.append(f"{'idle under':<40}{'ms/batch':>12}")
    for name, s in sorted(sp["idle_by_span"].items(), key=lambda kv: -kv[1]):
        lines.append(f"{name:<40}{1e3 * s / nb:>12.3f}")
    return lines
