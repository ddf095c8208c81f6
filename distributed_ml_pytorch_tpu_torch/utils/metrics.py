"""Per-iteration training records and per-rank CSV dumps, and the serving
SLO percentiles (counterpart of the JAX ``utils/metrics.py``
``MetricsLogger`` / ``print_eval_line`` / ``percentile`` /
``latency_summary``), and the admission gate's running statistics
(:class:`EwmaMeanVar`, as the JAX module's), and the telemetry EWMA a
worker's lease renewals carry (:class:`Ewma`).

The CSV schema is the reference's (``example/main.py:76-105``):
``index, timestamp, iteration, training_loss`` on every row, plus
``test_loss, test_accuracy`` (empty on rows without an eval). Written with
the standard ``csv`` module, in the column order and cell format that
pandas' ``DataFrame.to_csv(index_label="index")`` gives the JAX package.
"""

from __future__ import annotations

import csv
import math
import os
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile of a 1-D sample (``q`` in [0, 100]);
    an empty sample or an out-of-range ``q`` raises instead of giving NaN."""
    arr = np.asarray(list(values), np.float64)
    if arr.size == 0:
        raise ValueError("percentile() of an empty sample")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    return float(np.percentile(arr, q))


def latency_summary(values, percentiles=(50, 90, 99)) -> Optional[Dict]:
    """``count``/``mean``/``max`` and the given percentiles (``p50`` …) of a
    latency sample; ``None`` for an empty sample."""
    arr = np.asarray(list(values), np.float64)
    if arr.size == 0:
        return None
    out = {"count": int(arr.size), "mean": float(arr.mean()), "max": float(arr.max())}
    for q in percentiles:
        out[f"p{q:g}"] = percentile(arr, q)
    return out


class MetricsLogger:
    """Accumulates per-iteration log records and dumps one CSV per rank."""

    def __init__(self, log_dir: str = "log"):
        self.log_dir = log_dir
        self.records: List[Dict] = []

    def log_step(self, iteration: int, training_loss: float, **extra) -> Dict:
        rec = {
            "timestamp": datetime.now(),
            "iteration": iteration,
            "training_loss": float(training_loss),
        }
        rec.update(extra)
        self.records.append(rec)
        return rec

    def to_csv(self, filename: str) -> str:
        """Write the records to ``log_dir/filename``; returns the path."""
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, filename)
        columns: List[str] = []
        for rec in self.records:
            columns += [k for k in rec if k not in columns]
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["index", *columns])
            for i, rec in enumerate(self.records):
                w.writerow([i, *("" if rec.get(k) is None else rec[k] for k in columns)])
        return path


def print_eval_line(rec: Dict) -> None:
    """Per-interval telemetry line (reference ``example/main.py:85-89``)."""
    print(
        "Timestamp: {timestamp} | "
        "Iteration: {iteration:6} | "
        "Loss: {training_loss:6.4f} | "
        "Test Loss: {test_loss:6.4f} | "
        "Test Accuracy: {test_accuracy:6.4f}".format(**rec)
    )


#: the smoothing of the telemetry EWMAs (the JAX package's)
TELEMETRY_ALPHA = 0.3


class Ewma:
    """An exponentially weighted mean, as the JAX package's: the first
    sample seeds it (a value of exactly 0.0 reads as unset), then ``value =
    (1 - alpha) * value + alpha * x``, in double precision, so the floats a
    lease renewal carries are the JAX ones."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = TELEMETRY_ALPHA):
        if not 0 < alpha <= 1:
            raise ValueError(f"need 0 < alpha <= 1, got {alpha}")
        self.alpha = float(alpha)
        self.value = 0.0

    def update(self, x: float) -> float:
        x = float(x)
        self.value = (x if self.value == 0.0
                      else (1.0 - self.alpha) * self.value + self.alpha * x)
        return self.value

    def reset(self) -> None:
        self.value = 0.0


class EwmaMeanVar:
    """EWMA mean and variance, an admitted sample optionally winsorized at
    ``winsor`` before it moves the mean (the admission gate's statistics,
    ``utils/health.py``): a ramp of samples each just under the gate's
    threshold must not walk the mean up with it. The caller folds in only
    the samples it admits."""

    __slots__ = ("mean", "var", "count")

    #: the weight of a new sample (the JAX gate's default)
    alpha = 0.2

    def __init__(self):
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def sigma(self, floor: float = 0.0) -> float:
        return max(math.sqrt(max(self.var, 0.0)), float(floor))

    def update(self, x: float, winsor: Optional[float] = None) -> None:
        x = float(x)
        if self.count == 0:
            self.mean = x
            self.var = 0.0
        else:
            d = x - self.mean
            if winsor is not None:
                d = max(-winsor, min(winsor, d))
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.count += 1
