"""Where a callable's time goes on the card: ``torch.profiler`` kernel times.

:func:`kernel_breakdown` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities), synchronizes, and sums each CUDA kernel's device time by name
and by group (``groups`` maps a label to substrings of kernel names; the
first match wins, the rest is ``"other"``), and counts each group's kernel
launches. The busy time is the sum of the kernels' durations (one stream,
so they do not overlap); each group's gap is the card's idle time just
before its launches (from the end of the activity before each one to its
start, summed); the idle share is
``1 - busy / wall``, with the wall clock taken around the profiled run, so
it includes the profiler's own host overhead and reads as an upper bound.

The profiler can lose kernels without a word. On an H100 under torch 2.11,
once a process had run the attention kernels, the first kernel launched
after each start of the profiler never came back (a cuDNN layout
transform at the head of an AlexNet step), and a kernel's start, mapped to the host's clock,
read up to 4.7 ms before the call that launched it, so a step's first
kernels could fall before the capture window. So each profiled run first
launches ``WARMUP_LAUNCHES`` one-element adds and synchronizes, which take
that loss and are left out of every figure, then idles ``WINDOW_PAD_S``
before and after ``fn`` (the wall clock spans ``fn`` alone). Every launch
call of ``fn`` whose kernel did not come back is counted in
``"lost_launches"``; a run that lost one or recorded no device time is
repeated, up to ``PROFILER_RUNS`` in all, and ``"runs"`` says how many
times ``fn`` ran. When no run records any device time (the profiler relies
on CUPTI), the result says so in ``"device_time"`` instead of reporting
zeros as measurements.

A CUDA graph's kernels come back under the launch of the graph
(``cudaGraphLaunch``), one event each, and count as kernels like any other.
A launch call made while a stream is being captured (between
``cudaStreamBeginCapture`` and ``cudaStreamEndCapture``) records a graph
node and runs nothing, so it is counted in ``"captured_launches"``, not as
lost.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Sequence, Tuple


#: profiled runs tried before reporting what the last one recorded
PROFILER_RUNS = 3
#: idle host time inside the capture window before and after ``fn``: more
#: than the largest skew between device and host timestamps seen (4.7 ms)
WINDOW_PAD_S = 0.02
#: throwaway launches at the head of each profiled run, left out of the
#: figures: the profiler was seen to lose the first kernel after it starts
WARMUP_LAUNCHES = 8


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call that launches a kernel."""
    return "LaunchKernel" in name or "LaunchCooperativeKernel" in name


def _kernel_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total", "device_time_total",
                 "cuda_time_total"):
        val = getattr(evt, attr, None)
        if val:
            return float(val)
    return 0.0


def _captured(events, device) -> set:
    """Correlation ids of the launch calls made inside a stream capture
    window (host events ``cudaStreamBeginCapture`` to ``...EndCapture``)."""
    host = sorted((e for e in events if getattr(e, "device_type", None) != device),
                  key=lambda e: e.time_range.start)
    ids, inside = set(), False
    for e in host:
        if "StreamBeginCapture" in e.name:
            inside = True
        elif "StreamEndCapture" in e.name:
            inside = False
        elif inside and _is_launch(e.name):
            ids.add(e.id)
    return ids


def tally(events, device, skip_launches: int = 0
          ) -> Tuple[Dict[str, float], Dict[str, int], Dict[str, float], int]:
    """``(ms, launches, gap ms)`` per kernel name over the profiler's
    ``events`` whose ``device_type`` is ``device``, and the number of launch
    calls whose kernel is not among them (matched by correlation id). The
    first ``skip_launches`` launch calls on the host's clock, and their
    kernels, are left out, and so are launch calls made during a stream
    capture (they run nothing)."""
    events = list(events)
    calls_made = sorted((e for e in events if getattr(e, "device_type", None) != device
                         and _is_launch(e.name)), key=lambda e: e.time_range.start)
    skipped = {e.id for e in calls_made[:skip_launches]}
    launched = {e.id for e in calls_made[skip_launches:]} - _captured(events, device)
    per_kernel: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    gaps: Dict[str, float] = {}
    spans = []
    came_back = set()
    for evt in events:
        if getattr(evt, "device_type", None) != device or evt.id in skipped:
            continue
        came_back.add(evt.id)
        per_kernel[evt.name] = per_kernel.get(evt.name, 0.0) + _kernel_us(evt) / 1e3
        calls[evt.name] = calls.get(evt.name, 0) + 1
        spans.append((evt.time_range.start, evt.time_range.end, evt.name))
    spans.sort()
    for (_s0, e0, _n0), (s1, _e1, n1) in zip(spans, spans[1:]):
        gaps[n1] = gaps.get(n1, 0.0) + max(0.0, s1 - e0) / 1e3
    return per_kernel, calls, gaps, len(launched - came_back)


def kernel_breakdown(fn: Callable[[], object], groups: Mapping[str, Sequence[str]],
                     top: int = 8) -> Dict[str, object]:
    """Run ``fn`` under the profiler; return wall and busy ms, the idle
    share, ms, launches and the gap before the launches per group, the
    ``top`` kernels by device time, the launches whose kernel the profiler
    lost and how many times ``fn`` ran (see :data:`PROFILER_RUNS`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    warm = torch.zeros(1, device="cuda")
    for run in range(1, PROFILER_RUNS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(WARMUP_LAUNCHES):
                warm.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(WINDOW_PAD_S)
        events = prof.events()
        per_kernel, calls, gaps, lost = tally(events, DeviceType.CUDA, WARMUP_LAUNCHES)
        captured = len(_captured(events, DeviceType.CUDA))
        busy_ms = sum(per_kernel.values())
        if busy_ms > 0.0 and not lost:
            break
    if busy_ms <= 0.0:
        return {"wall_ms": wall_ms, "runs": run,
                "device_time": "not measured (no CUDA kernel events)"}
    by_group = {label: 0.0 for label in groups}
    by_group["other"] = 0.0
    launches = dict.fromkeys(by_group, 0)
    gap_ms = dict.fromkeys(by_group, 0.0)
    for name, ms in per_kernel.items():
        label = next((lb for lb, keys in groups.items() if any(k in name for k in keys)),
                     "other")
        by_group[label] += ms
        launches[label] += calls[name]
        gap_ms[label] += gaps.get(name, 0.0)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "group_ms": by_group, "group_launches": launches, "group_gap_ms": gap_ms,
            "top_kernels_ms": [[n[:120], ms] for n, ms in ranked],
            "lost_launches": lost, "captured_launches": captured, "runs": run}
