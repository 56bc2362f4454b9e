"""Stage timers and device traces (counterpart of
``f5tts_tpu/utils/profiling.py``).

``GLOBAL_TIMER`` keeps rolling per-stage timings (the engine's per-solve host
fetch, strict escalations) that ``/v1/metrics`` reports as percentiles. A
device trace comes from ``torch.profiler`` and is written as a Chrome trace
(``chrome://tracing`` or Perfetto) under the directory the caller names.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict, deque


class StageTimer:
    """Thread-safe rolling stage timings with percentile summaries."""

    def __init__(self, window: int = 512):
        self._samples: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        with self._lock:
            self._samples[name].append(seconds)
            self._counts[name] += 1

    def summary(self) -> dict:
        out = {}
        with self._lock:
            for name, q in self._samples.items():
                if not q:
                    continue
                s = sorted(q)
                out[name] = {
                    "count": self._counts[name],
                    "p50_ms": round(s[len(s) // 2] * 1e3, 2),
                    "p95_ms": round(s[min(int(len(s) * 0.95), len(s) - 1)] * 1e3, 2),
                    "max_ms": round(s[-1] * 1e3, 2),
                }
        return out


GLOBAL_TIMER = StageTimer()

_trace_lock = threading.Lock()
_trace: tuple | None = None  # (profiler, log_dir) while a trace runs


def start_device_trace(log_dir: str) -> bool:
    """Start a ``torch.profiler`` trace of the host and, where a card is
    visible, the device; False when one is already running or the profiler
    cannot start."""
    global _trace
    from torch.profiler import ProfilerActivity, profile

    import torch

    with _trace_lock:
        if _trace is not None:
            return False
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        try:
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception:
            return False
        _trace = (prof, log_dir)
        return True


def stop_device_trace() -> bool:
    """Stop the running trace and write it to ``<log_dir>/trace_<time>.json``;
    False when none runs."""
    global _trace
    with _trace_lock:
        if _trace is None:
            return False
        prof, log_dir = _trace
        _trace = None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json"))
    return True
