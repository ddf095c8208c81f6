"""Wall-clock step statistics (counterpart of the JAX ``utils/tracing.py``,
:class:`StepTimer` only; the profiler windows wait for the observability
plane)."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


class StepTimer:
    """Wall-clock per-step statistics with warmup exclusion.

    Bracket each step with :meth:`start` (just before dispatch) and
    :meth:`tick` (after the step's result is on the host, which synchronizes
    with the device), so the interval is dispatch-to-ready time. ``skip``
    initial intervals are discarded (warmup, kernel builds). A :meth:`tick`
    without a preceding :meth:`start` records nothing.
    """

    def __init__(self, skip: int = 2, items_per_step: Optional[int] = None):
        self.skip = skip
        self.items_per_step = items_per_step
        self._seen = 0
        self._times: list = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self) -> None:
        if self._last is None:
            return
        dt = time.perf_counter() - self._last
        self._last = None
        self._seen += 1
        if self._seen > self.skip:
            self._times.append(dt)

    def tick_n(self, n: int) -> None:
        """Record the elapsed interval as ``n`` equal steps; a chunk that
        holds any warmup step is dropped whole."""
        if self._last is None or n < 1:
            return
        dt = (time.perf_counter() - self._last) / n
        self._last = None
        if self._seen < self.skip:
            self._seen += n
            return
        self._seen += n
        self._times.extend([dt] * n)

    def reset_stats(self) -> None:
        """Clear collected intervals but keep the warmup state."""
        self._times = []

    def summary(self) -> Optional[dict]:
        if not self._times:
            return None
        t = np.asarray(self._times)
        out = {
            "steps": int(t.size),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
        }
        if self.items_per_step:
            out["items_per_sec"] = float(self.items_per_step / t.mean())
        return out

    def report(self, prefix: str = "steps") -> Optional[str]:
        s = self.summary()
        if s is None:
            return None
        line = "{}: {} timed, mean {:.2f} ms, p50 {:.2f} ms, p99 {:.2f} ms".format(
            prefix, s["steps"], s["mean_ms"], s["p50_ms"], s["p99_ms"])
        if "items_per_sec" in s:
            line += ", {:.0f} items/s".format(s["items_per_sec"])
        return line
