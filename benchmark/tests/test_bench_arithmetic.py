"""The benchmark's frozen arithmetic against hand-worked cases: roofline
bounds at the G102 and G302 shapes (the bounds PERF.md's kernel table
gives), percentiles over all batches, the stopping target and the time to
it, and the reading of a profiler trace."""

from __future__ import annotations

import json
import math

import pytest

import devtrace
import roofline
import stats


@pytest.mark.parametrize("kind, B, X, roots, with_res, bound_us, by", [
    # G102: 128 probes on 128^2, complex64
    ("matvec", 128, 128, 0, False, 20.737, "bytes"),      # (4 B + 18) 16384 * 8 B
    ("residual", 128, 128, 0, False, 30.753, "bytes"),    # (6 B + 18) 16384 * 8 B
    ("poly", 128, 128, 16, True, 82.133, "flops"),        # 16 * 164 * 16384 * 128 flop
    # G302: 16 probes on 512^2, complex64
    ("matvec", 16, 512, 0, False, 51.333, "bytes"),
    ("residual", 16, 512, 0, False, 71.366, "bytes"),
    ("poly", 16, 512, 4, True, 71.366, "bytes"),          # 4 * 164 flop: 41.1 us < bytes
    ("poly", 16, 512, 4, False, 51.333, "bytes"),
])
def test_bounds_at_the_paths_shapes(kind, B, X, roots, with_res, bound_us, by):
    nbytes, flops = roofline.call_work(kind, B, X, X, 8, roots, with_res)
    t = roofline.bound_s(nbytes, flops, 8)
    assert t * 1e6 == pytest.approx(bound_us, abs=1e-3)
    t_bytes, t_flops = nbytes / roofline.HBM_BYTES_PER_S, flops / roofline.FP32_FLOPS_PER_S
    assert (t_bytes >= t_flops) == (by == "bytes")


def test_poly_without_residual_charges_one_application_less():
    _, f_res = roofline.call_work("poly", 8, 16, 16, 8, 4, True)
    _, f_nores = roofline.call_work("poly", 8, 16, 16, 8, 4, False)
    assert f_res - f_nores == (roofline.FLOPS_K3_ROOT - roofline.FLOPS_K3_LAST_NO_D) * 256 * 8


def test_share_from_calls_and_kernel_time():
    trace = dict(calls=[("matvec", 128, 128, 128, 8, 0, False)] * 10
                 + [("poly", 128, 128, 128, 8, 16, True)] * 2,
                 by_name={"void stencil_rows_kernel<float2, false, true>(...)": 10 * 41.474e-6,
                          "void poly_tiled_kernel<float2>(...)": 8 * 0.14e-3})
    assert roofline.share_pct(trace, ("matvec", "residual"), "K1 + K2") == pytest.approx(50.0, rel=1e-4)
    assert roofline.share_pct(trace, ("poly",), "K3") == pytest.approx(
        100 * 2 * 82.133e-6 / 1.12e-3, rel=1e-4)
    assert roofline.share_pct(dict(calls=[], by_name={}), ("poly",), "K3") is None


def test_p90_over_all_batches():
    vals = list(range(1, 101))              # 100 batches of 1..100 ms
    assert stats.percentile(vals, 90) == pytest.approx(90.1)
    assert stats.percentile([5.0] * 7 + [50.0] * 3, 90) == pytest.approx(50.0)


def test_sampling_time_on_a_known_sample():
    es = [1 + 1j, 3 + 1j, 1 - 1j, 3 - 1j]   # mean 2, |e - mean|^2 = 2 each
    var = stats.population_variance(es)
    assert var == pytest.approx(2.0)
    target = stats.stop_target(0.7, 0.01, 2.0, 1.0)   # 0.014
    # (2 / 0.014^2) samples at 1000 samples/s
    assert stats.sampling_s_to_target(var, target, 1000.0) == pytest.approx(2 / 0.014 ** 2 / 1000)


def test_stopping_shares_match_the_program():
    from deflatedmlmc_schwinger_tpu_torch.trace.mlmc import (
        _level_tol_factor,
        _tolerance_fractions,
    )

    for nl in (3, 4, 5):
        for skip in (False, True):
            f = stats.tolerance_fractions(nl, skip)
            assert f == _tolerance_fractions(nl, skip)
            for i in range(nl - 1):
                if nl == 3 and i == 2:
                    continue
                assert stats.level_tol_factor(i, nl, *f, skip) == _level_tol_factor(i, nl, *f, skip)
    assert stats.level_tol_factor(0, 4, *stats.tolerance_fractions(4, True), True) == math.sqrt(0.9)


def test_trace_reading(tmp_path):
    """Busy union over overlapping device events, idle gaps labelled by the
    innermost host event over each gap, device time by name."""
    ev = [
        dict(ph="X", cat="user_annotation", name=devtrace.STRETCH, ts=0, dur=100, pid=1, tid=1),
        dict(ph="X", cat="cpu_op", name="aten::item", ts=30, dur=40, pid=1, tid=1),
        dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize", ts=35, dur=30, pid=1, tid=1),
        dict(ph="X", cat="kernel", name="gemm_a", ts=10, dur=20, pid=0, tid=7),
        dict(ph="X", cat="kernel", name="elementwise_b", ts=25, dur=10, pid=0, tid=8),
        dict(ph="X", cat="kernel", name="gemm_a", ts=70, dur=10, pid=0, tid=7),
        dict(ph="X", cat="kernel", name="outside", ts=150, dur=10, pid=0, tid=7),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps(dict(traceEvents=ev)))
    r = devtrace.read_trace(str(p))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)        # [10, 35] and [70, 80]
    assert r["device_ops"] == 3
    assert r["by_name"]["gemm_a"] == pytest.approx(30e-6)
    assert r["idle_by"]["cudaStreamSynchronize"] == pytest.approx(35e-6)   # [35, 70]
    assert r["idle_by"]["host Python"] == pytest.approx(30e-6)             # [0, 10], [80, 100]
    assert devtrace.group_seconds(r["by_name"])["GEMM"] == pytest.approx(30e-6)
