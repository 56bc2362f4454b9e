"""The device trace of a traced run, reduced in memory.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (device activity) and
keeps, from the raw events, what the metric readers need: the device time
and launches by kernel name, the union of the device's busy intervals
(kernels, copies, fills), and the longest idle gaps with the innermost of
the benchmark's host spans that was open in each. No trace file is
written. (Device timestamps are on the host's wall clock, as
``time.time_ns`` reads it.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float  # host clock over the profiled call, ended in a synchronise
    busy_s: float  # union of the device's activity intervals
    kernels: dict[str, list] = field(default_factory=dict)  # name -> [device seconds, launches]
    gaps: list[tuple[str, float]] = field(default_factory=list)  # longest idle gaps: (host op, seconds)

    def device_s(self, patterns) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose names hold any of ``patterns``."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.kernels.items():
            if any(p in name for p in patterns):
                s, n = s + sec, n + cnt
        return s, n

    def top_ops(self, k: int = 10) -> list[list]:
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:k]
        return [[name[:160], sec] for name, (sec, _) in ranked]


def profile(fn, device, spans=None) -> Trace:
    """``fn()`` under ``torch.profiler`` with device activity only (no host
    operations are recorded, which would slow the host's dispatch and so
    inflate the idle share). ``spans``, the benchmark's own ``core.Spans``,
    name what the host was doing in each idle gap. On the CPU (the tests'
    runs) nothing is recorded and the device reads idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    busy_iv = []
    kernels: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start, dur = e.start_ns(), e.duration_ns()
        busy_iv.append((start, start + dur))
        agg = kernels.setdefault(e.name(), [0.0, 0])
        agg[0] += dur * 1e-9
        agg[1] += 1
    busy_iv.sort()
    merged: list[list[int]] = []
    for s, t in busy_iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    idle = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])), reverse=True)[:10]
    host = spans.intervals if spans is not None else []
    gaps = []
    for length, s, t in idle:
        mid = (s + t) // 2
        inner = [(h1 - h0, name) for name, h0, h1 in host if h0 <= mid <= h1]
        gaps.append((min(inner)[1] if inner else "outside the benchmark's spans", length * 1e-9))
    return Trace(window_s=wall, busy_s=busy * 1e-9, kernels=kernels, gaps=gaps)
