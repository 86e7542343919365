"""The span pass's arithmetic (benchmark/spantrace.py) and the host and span
metrics' readers against hand-worked cases: a synthetic chrome trace with
nested program spans, CUDA runtime and driver-API launches linked to their device
operations by correlation ids, and idle gaps; a given window context for the
host counters; and the whole span run of each cell on the CPU at 32^2."""

from __future__ import annotations

import json

import pytest
import torch

import core
import span_run
import spantrace
from conftest import ROOT, small_spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid, args=args)


def _trace(tmp_path):
    """One batch, 0..200 us, spans and launches on thread 1. Launch (host)
    -> device operation, and the group it falls in:
      est.deflate                          5 -> k1 [10, 20]    est.own
      fgmres.step > vcycle > vcycle.l0.down, by the CUDA driver API
                                          32 -> k2 [40, 60]    vcycle.fine
      ... vcycle > vcycle.l1.down         52 -> k3 [60, 70]    vcycle.coarse
      ... vcycle > vcycle.coarsest        62 -> k4 [75, 80]    vcycle.coarse
      fgmres.step > fgmres.mgs            82 -> k5 [100, 130]  fgmres.own
      fgmres.step > host.read.fgmres.step 95 -> m6 [130, 131]  fgmres.own
      est.batch, outside the solve       150 -> k7 [160, 170]  est.own
      no span                            185 -> k8 [186, 190]  unattributed
      no launch event for it                    k9 [192, 194]  unattributed
    Idle gaps and the innermost program span over their middle: [0, 10]
    est.deflate; [20, 40] fgmres.step (an aten operator over it is no
    label); [70, 75] vcycle.coarsest; [80, 100] fgmres.mgs; [131, 160]
    est.batch; [170, 186], [190, 192], [194, 200] no span."""
    ev = [
        _x("user_annotation", "bench.stretch", 0, 200),
        _x("user_annotation", "est.batch", 0, 175),
        _x("user_annotation", "est.deflate", 0, 15),
        _x("user_annotation", "fgmres.solve", 20, 120),
        _x("user_annotation", "fgmres.cycle", 20, 115),
        _x("user_annotation", "fgmres.step", 25, 100),
        _x("user_annotation", "vcycle", 31, 47),
        _x("user_annotation", "vcycle.l0.down", 31, 10),
        _x("user_annotation", "vcycle.l1.down", 50, 10),
        _x("user_annotation", "vcycle.coarsest", 60, 16),
        _x("user_annotation", "fgmres.mgs", 80, 12),
        _x("user_annotation", "host.read.fgmres.step", 93, 32),
        _x("cpu_op", "aten::mul", 22, 20),
        _x("gpu_user_annotation", "vcycle", 40, 40, tid=7),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 2, correlation=1),
        _x("cuda_driver", "cuLaunchKernel", 32, 2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 52, 2, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 62, 2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 82, 2, correlation=5),
        _x("cuda_runtime", "cudaMemcpyAsync", 95, 30, correlation=6),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 2, correlation=7),
        _x("cuda_runtime", "cudaLaunchKernel", 185, 1, correlation=8),
        _x("kernel", "k1", 10, 10, tid=7, correlation=1),
        _x("kernel", "k2", 40, 20, tid=7, correlation=2),
        _x("kernel", "k3", 60, 10, tid=7, correlation=3),
        _x("kernel", "k4", 75, 5, tid=7, correlation=4),
        _x("kernel", "k5", 100, 30, tid=7, correlation=5),
        _x("gpu_memcpy", "Memcpy DtoH", 130, 1, tid=7, correlation=6),
        _x("kernel", "k7", 160, 10, tid=7, correlation=7),
        _x("kernel", "k8", 186, 4, tid=7, correlation=8),
        _x("kernel", "k9", 192, 2, tid=7, correlation=99),
        _x("kernel", "after", 250, 10, tid=7, correlation=9),
    ]
    p = tmp_path / "spans.json"
    p.write_text(json.dumps(dict(traceEvents=ev)))
    return str(p)


def test_device_time_by_layer_group(tmp_path):
    r = spantrace.read_spans(_trace(tmp_path))
    assert r["window_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx(92e-6)       # 10+20+10+5+30+1+10+4+2
    assert r["device_ops"] == 9 and r["linked_ops"] == 8
    g = r["groups"]
    assert g["est.own"] == pytest.approx(20e-6)       # k1, k7
    assert g["vcycle.fine"] == pytest.approx(20e-6)   # k2, by the CUDA driver API
    assert g["vcycle.coarse"] == pytest.approx(15e-6)  # k3, k4
    assert g["fgmres.own"] == pytest.approx(31e-6)    # k5 and the read's copy
    assert r["unattributed_s"] == pytest.approx(6e-6)  # k8 (no span), k9 (no launch)
    assert r["unlinked_s"] == pytest.approx(2e-6)
    assert sum(g.values()) + r["unattributed_s"] == pytest.approx(r["busy_s"])
    assert r["by_span"]["host.read.fgmres.step"] == pytest.approx(1e-6)
    assert r["by_span"]["vcycle.coarsest"] == pytest.approx(5e-6)
    assert r["by_span"][spantrace.NO_SPAN] == pytest.approx(4e-6)


def test_idle_by_innermost_program_span(tmp_path):
    idle = spantrace.read_spans(_trace(tmp_path))["idle_by_span"]
    want = {"est.deflate": 10, "fgmres.step": 20, "vcycle.coarsest": 5, "fgmres.mgs": 20,
            "est.batch": 29, spantrace.NO_SPAN: 16 + 2 + 6}
    assert set(idle) == set(want)
    for k, us in want.items():
        assert idle[k] == pytest.approx(us * 1e-6), k
    assert sum(idle.values()) == pytest.approx(200e-6 - 92e-6)


def test_group_of_a_span_stack():
    assert spantrace.group_of(("est.batch", "fgmres.solve", "fgmres.cycle", "fgmres.step",
                               "vcycle", "vcycle.l0.up")) == "vcycle.fine"
    assert spantrace.group_of(("est.batch", "est.coarse", "fgmres.solve", "fgmres.cycle",
                               "fgmres.step", "vcycle", "vcycle.l2.down")) == "vcycle.coarse"
    assert spantrace.group_of(("est.batch", "est.coarse")) == "est.own"
    assert spantrace.group_of(("est.batch", "est.coarse", "fgmres.solve")) == "fgmres.own"
    assert spantrace.group_of(("fgmres.solve", "fgmres.cycle", "vcycle")) is None
    assert spantrace.group_of(("phase.sampling",)) is None
    assert spantrace.group_of(()) is None


def test_span_metrics_read_the_pass(tmp_path):
    sp = dict(spantrace.read_spans(_trace(tmp_path)), batches=2, outer_iters=3)
    ctx = dict(window={}, phases={}, trace=dict(spans=sp))
    got = {m: core.load_metric(m).read(ctx) for m in span_run.METRICS[2:]}
    assert got == pytest.approx({"fgmres.own_ms_per_batch": 31e-3 / 2,
                                 "vcycle.fine_ms_per_batch": 20e-3 / 2,
                                 "vcycle.coarse_ms_per_batch": 15e-3 / 2,
                                 "est.own_ms_per_batch": 20e-3 / 2})
    text = "\n".join(spantrace.tables(sp))
    assert "unattributed" in text and "fgmres.mgs" in text
    # no span pass, or one without device work (a parent without spans): no reading
    for trace in (None, {}, dict(spans={}), dict(spans=dict(sp, device_ops=0))):
        ctx = dict(window={}, phases={}, trace=trace)
        assert all(core.load_metric(m).read(ctx) is None for m in span_run.METRICS[2:])


def test_host_metrics_from_the_window_context():
    w = dict(seconds=2.0, batch_iters=[10, 11, 9, 10],
             host_reads=dict(reads=520, seconds=0.4))
    ctx = dict(window=w, phases={}, trace=None)
    assert core.load_metric("host.syncs_per_iter").read(ctx) == pytest.approx(520 / 40)
    assert core.load_metric("host.busy_ms_per_iter").read(ctx) == pytest.approx(1.6e3 / 40)
    # a window without the counters (a program that has none) reads nothing
    ctx["window"] = dict(seconds=2.0, batch_iters=[10])
    assert core.load_metric("host.syncs_per_iter").read(ctx) is None
    assert core.load_metric("host.busy_ms_per_iter").read(ctx) is None


@pytest.mark.parametrize("cell", CELLS)
def test_span_run_on_the_cpu(cell, tmp_path):
    """The whole span run of a cell at 32^2 on the CPU: the window's host
    reads per outer iteration, the pass's spans (no device work on the CPU,
    so no span metric)."""
    torch.set_num_threads(2)
    out = span_run.span_run(small_spec(cell), 12345678901, 1.0, "cpu", str(tmp_path))
    m, w = out["metrics"], out["window"]
    iters = sum(w["batch_iters"])
    sites = out["host_read_sites"]
    assert set(sites) >= {"fgmres.cycle", "fgmres.step", "fgmres.stall", "sample.flags",
                          "sample.end"}
    # one predicate read per Arnoldi step at least, and one more per solve
    assert sites["fgmres.step"]["reads"] >= iters
    assert m["host.syncs_per_iter"] == pytest.approx(w["host_reads"]["reads"] / iters)
    assert 0 < m["host.busy_ms_per_iter"] < 1e3 * w["seconds"] / iters
    assert out["spans"]["device_ops"] == 0 and out["spans"]["batches"] > 0
    assert all(m[k] is None for k in span_run.METRICS[2:])
