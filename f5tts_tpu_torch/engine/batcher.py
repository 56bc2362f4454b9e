"""Continuous cross-request batcher (counterpart of
``f5tts_tpu/engine/batcher.py``): the request front a server puts before
either engine.

Row-level jobs from concurrent requests are funneled into one queue; a
dedicated worker drains it with a short batching window and hands the grouped
rows to the engine's ``synthesize_rows``, so ten concurrent single-sentence
requests cost one batched solve (or one batched decode), not ten. The engine
is anything with ``synthesize_rows(rows) -> list`` of one result per row:
``TTSEngine`` (rows are ``RowSpec``) or ``ParlerTTSEngine`` (``ParlerRow``).
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any


class OverloadedError(RuntimeError):
    """Raised to callers when the batcher queue is at capacity (maps to 503)."""


@dataclass
class _Job:
    row: Any  # RowSpec or ParlerRow
    future: Future = field(default_factory=Future)


class ContinuousBatcher:
    """Thread-based micro-batching worker over an engine's ``synthesize_rows``."""

    def __init__(self, engine, max_batch: int = 32, max_wait_ms: float = 15.0,
                 max_queue: int = 256):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_queue = max_queue
        self._jobs: list[_Job] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._inflight: list[_Job] = []  # batch being solved right now
        self.stats = {"batches": 0, "rows": 0, "max_batch_seen": 0}

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="tts-batcher", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stop = True
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        # fail queued jobs immediately: abandoned futures would otherwise
        # pin their waiters for the caller's full result() timeout
        with self._lock:
            orphans, self._jobs = self._jobs, []
        for job in orphans:
            if not job.future.done():
                job.future.set_exception(OverloadedError("batcher stopped during unload"))

    def submit(self, row) -> Future:
        job = _Job(row)
        with self._lock:
            if self._stop:
                # a request racing unload would otherwise enqueue onto a dead
                # worker and block its waiter for the full result() timeout
                job.future.set_exception(OverloadedError("batcher stopped (model unloading)"))
                return job.future
            if len(self._jobs) >= self.max_queue:
                # overload protection: shed load instead of growing unboundedly
                job.future.set_exception(OverloadedError(f"batcher queue full ({self.max_queue})"))
                return job.future
            self._jobs.append(job)
        self._wake.set()
        return job.future

    async def submit_async(self, row):
        return await asyncio.wrap_future(self.submit(row))

    def _run(self):
        try:
            self._run_loop()
        finally:
            # worker died (including BaseException a per-batch handler can't
            # catch): fail queued jobs instead of pinning waiters, and flip
            # _stop so later submits fail fast until a reload builds a fresh
            # batcher
            with self._lock:
                died = not self._stop
                self._stop = True
                orphans, self._jobs = self._jobs, []
            # jobs still queued are failed here in either case (on a clean
            # stop the worker empties the queue before stop() looks at it)
            why = "batcher worker died mid-batch" if died else "batcher stopped during unload"
            for job in orphans + (self._inflight if died else []):
                if not job.future.done():
                    job.future.set_exception(OverloadedError(why))
            if died:
                self._inflight = []

    def _run_loop(self):
        while not self._stop:
            self._wake.wait(timeout=0.1)
            self._wake.clear()
            if self._stop:
                break
            with self._lock:
                pending = len(self._jobs)
            if not pending:
                continue
            # batching window: let more jobs arrive up to max_batch
            deadline = time.monotonic() + self.max_wait_s
            while pending < self.max_batch and time.monotonic() < deadline:
                time.sleep(0.001)
                with self._lock:
                    pending = len(self._jobs)
            with self._lock:
                jobs, self._jobs = self._jobs[: self.max_batch], self._jobs[self.max_batch :]
            if not jobs:
                continue
            self._inflight = jobs
            try:
                results = self.engine.synthesize_rows([j.row for j in jobs])
                for j, res in zip(jobs, results):
                    j.future.set_result(res)
            except Exception as e:  # pragma: no cover
                for j in jobs:
                    if not j.future.done():
                        j.future.set_exception(e)
            # NOT a finally: a BaseException must leave _inflight set so the
            # worker-death handler in _run can resolve the batch's futures
            self._inflight = []
            self.stats["batches"] += 1
            self.stats["rows"] += len(jobs)
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(jobs))
