"""Stage timers, counters and device traces (counterpart of
``f5tts_tpu/utils/profiling.py``).

``GLOBAL_TIMER`` is the program's one tracer. Its spans (``stage``) and
recorded times (``record``) keep a rolling window per name, which
``/v1/metrics`` reports as percentiles, and running totals (count and
seconds) per name; ``add`` keeps integer counters; ``totals`` reads both.
The names are fixed, each taken where its work happens:

- ``engine.prepare_request``, ``engine.finalize_request``: per request;
- ``engine.pack`` (host packing and uploads), ``engine.dispatch`` (the
  launch of the bucket program and its host copies; it also holds the
  host's waits on the card inside Vocos's inverse STFT, whose uploads from
  pageable memory synchronise), ``engine.fetch_wait`` (the host's wait on
  a solve's results): per solve of ``synthesize_rows``;
- ``engine.solve_device`` (device time from a solve's first operation to
  the end of its host copies) and ``engine.solve_gap`` (device time from the
  previous solve's end to this one's start, within one pass of
  ``synthesize_rows``; its escalation pass starts anew): CUDA timing
  events, recorded on a card only;
- counters ``engine.solves``, ``engine.frames_solved`` (batch bucket x
  duration bucket) and ``engine.frames_needed`` (the rows' durations within
  their bucket);
- ``batcher.dispatch_segment`` (per segment), ``batcher.tick_wait`` (per
  tick) and ``batcher.queue_wait`` (per row, from ``submit`` to admission)
  in the step batcher.

While recording is on (``recording()``, or between ``start_device_trace``
and ``stop_device_trace``) every span is also a
``torch.profiler.record_function`` range, so the program's spans sit beside
the kernels in a Chrome trace, and a ``(name, start_ns, end_ns)`` interval
on ``time.time_ns()`` in the bounded ``intervals``. While it is off a span
costs two clock reads and one update under the lock.

A device trace comes from ``torch.profiler`` and is written as a Chrome
trace (``chrome://tracing`` or Perfetto) under the directory the caller
names.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict, deque

MAX_INTERVALS = 65536  # the recorded intervals a StageTimer keeps


class _Span:
    """One timed region of a ``StageTimer``; see ``StageTimer.stage``."""

    __slots__ = ("timer", "name", "t0", "w0", "rf")

    def __init__(self, timer: "StageTimer", name: str):
        self.timer, self.name, self.rf = timer, name, None

    def __enter__(self):
        if self.timer.recording_on:
            from torch.profiler import record_function

            self.rf = record_function(self.name)
            self.rf.__enter__()
            self.w0 = time.time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.timer.intervals.append((self.name, self.w0, time.time_ns()))
            self.rf.__exit__(*exc)
        self.timer.record(self.name, dt * 1e-9)
        return False


class StageTimer:
    """Thread-safe stage timings: rolling windows with percentile summaries,
    running totals, integer counters, and the recording state."""

    def __init__(self, window: int = 512):
        self._samples: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._counts: dict[str, int] = defaultdict(int)
        self._seconds: dict[str, float] = defaultdict(float)
        self._counters: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self.recording_on = False
        # (name, start_ns, end_ns) on time.time_ns() of the spans closed while
        # recording, in the order they closed; the oldest drop out when full
        self.intervals: deque = deque(maxlen=MAX_INTERVALS)

    def stage(self, name: str) -> _Span:
        """A context manager timing its body under ``name``."""
        return _Span(self, name)

    def record(self, name: str, seconds: float):
        with self._lock:
            self._samples[name].append(seconds)
            self._counts[name] += 1
            self._seconds[name] += seconds

    def add(self, name: str, n: int = 1):
        """Add ``n`` to the integer counter ``name``."""
        with self._lock:
            self._counters[name] += n

    def totals(self) -> dict:
        """``{"times": {name: {"count", "total_s"}}, "counters": {name: n}}``
        since the timer was made: every span and recorded time, and every
        counter."""
        with self._lock:
            return {"times": {k: {"count": n, "total_s": self._seconds[k]} for k, n in self._counts.items()},
                    "counters": dict(self._counters)}

    @contextlib.contextmanager
    def recording(self):
        """Record inside the block; the state before it is restored after."""
        before, self.recording_on = self.recording_on, True
        try:
            yield self
        finally:
            self.recording_on = before

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
    visible, the device, and turn ``GLOBAL_TIMER``'s recording on; False
    when one is already running or the profiler cannot start."""
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
        GLOBAL_TIMER.recording_on = True
        return True


def stop_device_trace() -> bool:
    """Turn ``GLOBAL_TIMER``'s recording off, stop the running trace and
    write it to ``<log_dir>/trace_<time>.json``; False when none runs."""
    global _trace
    with _trace_lock:
        if _trace is None:
            return False
        prof, log_dir = _trace
        _trace = None
        GLOBAL_TIMER.recording_on = False
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json"))
    return True
