"""Per-iteration training records and per-rank CSV dumps (counterpart of the
JAX ``utils/metrics.py`` ``MetricsLogger`` / ``print_eval_line``).

The CSV schema is the reference's (``example/main.py:76-105``):
``index, timestamp, iteration, training_loss`` on every row, plus
``test_loss, test_accuracy`` (empty on rows without an eval). Written with
the standard ``csv`` module, in the column order and cell format that
pandas' ``DataFrame.to_csv(index_label="index")`` gives the JAX package.
"""

from __future__ import annotations

import csv
import os
from datetime import datetime
from typing import Dict, List


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
