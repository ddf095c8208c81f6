"""Where a callable's time goes on the card: ``torch.profiler`` kernel times.

:func:`kernel_breakdown` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities), synchronizes, and sums each CUDA kernel's device time by name
and by group (``groups`` maps a label to substrings of kernel names; the
first match wins, the rest is ``"other"``), and counts each group's kernel
launches. The busy time is the sum of the kernels' durations (one stream,
so they do not overlap); the idle share is
``1 - busy / wall``, with the wall clock taken around the profiled run, so
it includes the profiler's own host overhead and reads as an upper bound.

A profiled run that records no device time is repeated (up to
``PROFILER_RUNS`` in all); when none records any (the profiler relies on CUPTI),
the result says so in ``"device_time"`` instead of reporting zeros as
measurements.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Sequence


#: profiled runs tried before reporting no device time: on an H100 under
#: torch 2.11, short back-to-back profiled runs sometimes came back without
#: their CUDA events
PROFILER_RUNS = 3


def _kernel_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total", "device_time_total",
                 "cuda_time_total"):
        val = getattr(evt, attr, None)
        if val:
            return float(val)
    return 0.0


def kernel_breakdown(fn: Callable[[], object], groups: Mapping[str, Sequence[str]],
                     top: int = 8) -> Dict[str, object]:
    """Run ``fn`` under the profiler; return wall and busy ms, the idle
    share, ms and launches per group and the ``top`` kernels by device
    time. ``fn`` may run up to ``PROFILER_RUNS`` times (see
    :data:`PROFILER_RUNS`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _run in range(PROFILER_RUNS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        per_kernel: Dict[str, float] = {}
        calls: Dict[str, int] = {}
        for evt in prof.events():
            if getattr(evt, "device_type", None) != DeviceType.CUDA:
                continue
            per_kernel[evt.name] = per_kernel.get(evt.name, 0.0) + _kernel_us(evt) / 1e3
            calls[evt.name] = calls.get(evt.name, 0) + 1
        busy_ms = sum(per_kernel.values())
        if busy_ms > 0.0:
            break
    if busy_ms <= 0.0:
        return {"wall_ms": wall_ms, "device_time": "not measured (no CUDA kernel events)"}
    by_group = {label: 0.0 for label in groups}
    by_group["other"] = 0.0
    launches = dict.fromkeys(by_group, 0)
    for name, ms in per_kernel.items():
        label = next((lb for lb, keys in groups.items() if any(k in name for k in keys)),
                     "other")
        by_group[label] += ms
        launches[label] += calls[name]
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "group_ms": by_group, "group_launches": launches,
            "top_kernels_ms": [[n[:120], ms] for n, ms in ranked]}
