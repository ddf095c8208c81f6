"""Step timing and profiler windows (counterpart of the JAX
``utils/tracing.py``).

- :class:`StepTimer`: wall-clock statistics over training steps (mean,
  p50, p99, throughput), dispatch to ready.
- :class:`TraceWindow`: a ``torch.profiler`` trace of a bounded window of
  global steps (CUDA and CPU activities on the card, CPU otherwise),
  written as Chrome-trace JSON (``ui.perfetto.dev``) by the profiler's own
  exporter. A whole run's trace would be gigabytes; a window shows the
  steady state.
- :func:`annotate_step`: a ``torch.profiler.record_function`` range named
  ``<name>#<step>``, so that each step shows in the trace.
"""

from __future__ import annotations

import os
import sys
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


class TraceWindow:
    """A ``torch.profiler`` trace of global steps ``[start, start + n_steps)``.

    Call :meth:`on_step` with the global step before dispatching it: the
    trace opens when the dispatch overlaps the window and closes at its end
    (:meth:`after_step`) or at :meth:`close`, whichever comes first. A falsy
    ``profile_dir`` makes every call a no-op, so callers wire it
    unconditionally. On the card each session opens with
    ``devprof.WARMUP_LAUNCHES`` throwaway one-element adds (the profiler was
    seen to lose a session's first kernel). The trace goes to
    ``<profile_dir>/trace_<pid>.pt.trace.json``.
    """

    def __init__(self, profile_dir: Optional[str], start: int = 10, n_steps: int = 10):
        self.profile_dir = profile_dir
        self.start = start
        self.stop = start + n_steps
        self._active = False
        self._done = False
        self._first_step: Optional[int] = None
        self._prof = None
        self._cuda = False
        #: the written trace's path, once closed
        self.trace_path: Optional[str] = None

    def on_step(self, step: int, n_steps: int = 1) -> None:
        """Open the trace when the dispatch ``[step, step + n_steps)``
        overlaps the window (a chunk that strides over it is traced whole);
        call before the dispatch."""
        if not self.profile_dir or self._done:
            return
        if self._first_step is None:
            self._first_step = step
        if not self._active and step < self.stop and step + n_steps > self.start:
            self._open()
        elif self._active and step >= self.stop:
            self.close()

    def _open(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from distributed_ml_pytorch_tpu_torch.utils.devprof import WARMUP_LAUNCHES

        self._cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self._prof = profile(activities=activities)
        self._prof.start()
        if self._cuda:
            warm = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                warm.add_(1.0)
            torch.cuda.synchronize()
        self._active = True

    def after_step(self, next_step: int) -> None:
        """Close the trace once the window's last step has completed: call
        with the next global step after the current one is done, so that an
        eval or a final save after the window stays out of it."""
        if self._active and next_step >= self.stop:
            self.close()

    def close(self) -> None:
        if not self._active:
            return
        if self._cuda:
            import torch

            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_{os.getpid()}.pt.trace.json")
        self._prof.export_chrome_trace(path)
        self.trace_path = path
        self._active = False
        self._done = True
        print(f"wrote profiler trace to {self.profile_dir}")

    def warn_if_never_opened(self) -> None:
        """At the end of a run: say so on stderr when profiling was asked for
        but the window ``[start, stop)`` was never reached."""
        if self.profile_dir and not self._done and not self._active:
            if self._first_step is not None and self._first_step >= self.stop:
                # a resumed run that started past the window
                hint = ("the run started at step {} — raise --profile-start past "
                        "the resume point".format(self._first_step))
            else:
                hint = "lower --profile-start or raise --profile-steps"
            print("warning: --profile-dir was set but the trace window "
                  f"[{self.start}, {self.stop}) was never reached; no trace "
                  f"written ({hint})", file=sys.stderr)


def annotate_step(name: str, step: int):
    """A profiler range ``<name>#<step>`` around one step."""
    import torch

    return torch.profiler.record_function(f"{name}#{step}")
