"""The benchmark's own arithmetic on the window's samples: percentiles,
the per-sample variance, and the stopping rule's target, frozen here so
that a later change to the program cannot move the yardstick.

The target is the standard error at which the estimator's own stopping rule
stops sampling a level (copied from trace/hutchinson.py and trace/mlmc.py
``_tolerance_fractions`` / ``_level_tol_factor``):
    stop_safety * trace_tol * |tr| * (the level's share of the tolerance),
the share being 1 for Hutchinson. ``sampling_s_to_1pct`` is the time the
measured rate needs for the samples that reach it:
    (sigma^2 / target^2) / samples_per_s.
"""

from __future__ import annotations

from math import sqrt
from typing import Sequence

import numpy as np


def tolerance_fractions(nr_levels: int, skip_level: bool):
    """Per-level variance-budget split of the sequential MLMC schedule."""
    if nr_levels < 3:
        raise ValueError("MLMC needs at least three levels")
    f0, f1 = (0.8, 0.2) if nr_levels == 3 else (0.45, 0.45)
    if skip_level:
        f0 = f0 + f1
    return f0, f1


def level_tol_factor(i: int, nr_levels: int, f0: float, f1: float,
                     skip_level: bool) -> float:
    """The share of the trace tolerance given to MLMC level i."""
    if i == 0:
        return sqrt(f0)
    if i == 1:
        return sqrt(f1)
    if skip_level:
        return sqrt(1.0 - f0) / sqrt(nr_levels - 3)
    return sqrt(1.0 - f0 - f1) / sqrt(nr_levels - 3)


def stop_target(stop_safety: float, trace_tol: float, trace_abs: float,
                tol_factor: float) -> float:
    return stop_safety * trace_tol * trace_abs * tol_factor


def population_variance(es: np.ndarray) -> float:
    """mean |e - mean|^2 over complex samples (the stopping rule's dev^2)."""
    es = np.asarray(es, dtype=np.complex128).ravel()
    return float(np.mean(np.abs(es - es.mean()) ** 2))


def sampling_s_to_target(variance: float, target: float, samples_per_s: float) -> float:
    return (variance / (target * target)) / samples_per_s


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics
    (numpy's default), over all values."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))

