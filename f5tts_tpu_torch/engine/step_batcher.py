"""Step-level continuous batcher (counterpart of
``f5tts_tpu/engine/step_batcher.py``): requests join and leave running ODE
solves at segment boundaries.

The window batcher (``engine/batcher.py``) groups co-arriving jobs and then
blocks in one whole solve, so a request that arrives just after a solve starts
waits for all of it before its own batch forms. Here a solve advances in
segments of ``segment_intervals`` ODE intervals (``sampling/segment.py``) with
per-row time knots:

- between segments the host admits queued rows into free slots of running
  solve groups (a slot opens when its row finishes, or the group started
  below its width); a joining row starts at knot 0 while its neighbours go
  on mid-trajectory;
- rows with different step counts or guidance strengths co-batch (both are
  per-row data); finished rows are finalized (paste-back + vocode) and their
  futures resolved while the rest of the group keeps solving;
- when no group of the row's bucket has a free slot, a new group starts at
  once, and the groups' segments interleave on the card's queue.

The serving contract is ``ContinuousBatcher``'s (``submit``/``submit_async``/
``start``/``stop``/``stats`` over ``RowSpec`` futures). A group's state stays
on the card between segments: admitted rows are written into its tensors on
the stream the segments run on, and only finished rows are copied to the
host. A tick dispatches one segment per active group without reading a device
value, then waits on one CUDA event. ``GLOBAL_TIMER`` times each segment's
dispatch (``batcher.dispatch_segment``), each tick's wait
(``batcher.tick_wait``) and each row's wait from ``submit`` to its admission
into a group (``batcher.queue_wait``); the warm-up counts in none. Strict
rows run ``synthesize_rows`` on a side thread; samplers that hold a null
velocity across steps (``cfg_cache_period``, ``cfg_null_reuse``) must keep
the window batcher.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from f5tts_tpu_torch.engine.batcher import OverloadedError
from f5tts_tpu_torch.engine.engine import RowSpec, TTSEngine, _bucket
from f5tts_tpu_torch.sampling.euler import sample_noise_from_seeds
from f5tts_tpu_torch.sampling.segment import (finalize_rows, pair_text_embedding, resolved_time_grid, row_masks,
                                              solve_segment)
from f5tts_tpu_torch.utils.device import to_device
from f5tts_tpu_torch.utils.profiling import GLOBAL_TIMER


class SegmentPrograms:
    """The three programs of the segmented solve, bound to one engine's
    params and config: ``set_row`` (admit: write a cond row and the row's
    seeded noise into a slot), ``seg`` (advance k intervals), ``fin``
    (paste-back + vocode)."""

    def __init__(self, engine: TTSEngine, segment_intervals: int):
        s = engine.cfg.sampler
        if s.cfg_cache_period > 1 or s.cfg_null_reuse:
            # a held null velocity cannot ride a batch whose rows sit at
            # different trajectory points; cfg_interval is per-row data
            raise ValueError(
                "step-level batching supports full-interval and cfg_interval "
                "guidance; keep the window batcher for cfg_cache_period/"
                "cfg_null_reuse samplers")
        if segment_intervals < 1:
            raise ValueError("segment_intervals must be >= 1")
        self.engine = engine
        self.k = segment_intervals
        self.method = s.method

    def grid_for(self, steps: int) -> np.ndarray:
        return resolved_time_grid(self.engine.cfg.sampler, steps)

    def set_row(self, cond: torch.Tensor, y: torch.Tensor, idx: int, cond_row: np.ndarray, seed: int,
                dur_clipped: int) -> None:
        """Write slot ``idx``: its cond mel, and the noise ``sample_cfm`` draws
        for this seed (under the duration it clips to, as the window path)."""
        e = self.engine
        nb, mel = cond.shape[1], cond.shape[2]
        cond[idx].copy_(to_device(torch.from_numpy(cond_row), cond.device), non_blocking=True)
        noise = sample_noise_from_seeds([seed], nb, mel, torch.tensor([dur_clipped]), e.compute_dtype)
        y[idx].copy_(to_device(noise[0], y.device), non_blocking=True)

    def embed(self, text: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        e = self.engine
        return pair_text_embedding(e.dit_params, e.dit_cfg, text, attn_mask, attn_mask.shape[1], e.embed_fn)

    def seg(self, cond, cond_lens, text, duration, cfg_s, y, t0s, t1s, em, text_emb2=None) -> torch.Tensor:
        e = self.engine
        return solve_segment(
            e.dit_params, e.dit_cfg, cond=cond, cond_lens=cond_lens, text=text, duration=duration, y=y,
            t0s=t0s, t1s=t1s, cfg_strength=cfg_s, cfg_interval=tuple(e.cfg.sampler.cfg_interval),
            method=self.method, edit_mask=em, compute_dtype=e.compute_dtype, forward_fn=e.forward_fn,
            embed_fn=e.embed_fn, text_emb2=text_emb2)

    def fin(self, cond, cond_lens, text, duration, y, out_start, em):
        e = self.engine
        return finalize_rows(
            e._decode, e.vocos_params,
            cond=cond, cond_lens=cond_lens, text=text, duration=duration, y=y, out_start=out_start,
            edit_mask=em, compute_dtype=e.compute_dtype)


@dataclass
class _Job:
    row: RowSpec
    future: Future = field(default_factory=Future)
    submitted: float = field(default_factory=time.perf_counter)


@dataclass
class _Slot:
    job: _Job
    grid: np.ndarray  # the row's whole knot grid (steps + 1,)
    p: int = 0  # intervals completed (host-side count: never read from the card)
    joined_mid_solve: bool = False

    @property
    def done(self) -> bool:
        return self.p >= len(self.grid) - 1


class SolveGroup:
    """One running batched solve: width ``bb``, duration bucket ``nb``; cond
    and trajectory on the card, per-slot metadata on the host (uploaded when
    it changes)."""

    def __init__(self, progs: SegmentPrograms, nb: int, bb: int):
        e = progs.engine
        self.progs = progs
        self.nb, self.bb = nb, bb
        mel = e.cfg.mel.n_mels
        dev = e.device
        self.cond = torch.zeros((bb, nb, mel), dtype=torch.float32, device=dev)
        self.y = torch.zeros((bb, nb, mel), dtype=e.compute_dtype, device=dev)
        self.text = np.full((bb, e.cfg.text_pad), -1, np.int32)
        self.cond_lens = np.full((bb,), 2, np.int32)
        self.dur = np.full((bb,), 3, np.int32)
        self.out_start = np.zeros((bb,), np.int32)
        self.cfg_s = np.zeros((bb,), np.float32)
        self.em = np.ones((bb, nb), bool)
        self.slots: list[_Slot | None] = [None] * bb
        self.age_segments = 0
        self._dev: dict | None = None  # device copies of the metadata and the pair text embedding

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active(self) -> bool:
        return any(s is not None and not s.done for s in self.slots)

    def admit(self, job: _Job) -> None:
        e = self.progs.engine
        idx = self.free_slots()[0]
        r = job.row
        nb = self.nb
        rf = min(r.ref_frames, nb)
        cond_row = np.zeros((nb, e.cfg.mel.n_mels), np.float32)
        cond_row[:rf] = r.cond_mel[:rf]
        text_ids = e.tokenizer.encode([r.text], pad_to=e.cfg.text_pad)[0]
        text_len = int(np.sum(text_ids != -1))
        dur = min(r.duration, nb)
        # the clipped duration sample_cfm derives (the noise is drawn under it)
        dur_clipped = min(max(max(text_len, rf) + 1, dur), nb)
        seed = r.seed if r.seed is not None else int(e._host_rng.integers(2**31 - 1))

        self.text[idx] = text_ids
        self.cond_lens[idx] = rf
        self.dur[idx] = dur
        self.cfg_s[idx] = r.cfg_strength
        self.em[idx] = True
        if r.edit_mask is None:
            self.out_start[idx] = rf
        else:
            self.out_start[idx] = 0
            self.em[idx, : min(len(r.edit_mask), nb)] = r.edit_mask[:nb]
        self.progs.set_row(self.cond, self.y, idx, cond_row, seed, dur_clipped)
        self._dev = None
        self.slots[idx] = _Slot(job=job, grid=self.progs.grid_for(r.steps), joined_mid_solve=self.age_segments > 0)

    def _device_state(self) -> dict:
        """The metadata on the card and the pair text embedding, remade only
        after an admission or a freed slot (queued uploads: no host sync)."""
        if self._dev is None:
            dev = self.cond.device
            d = {name: to_device(torch.from_numpy(getattr(self, name).copy()), dev)
                 for name in ("text", "cond_lens", "dur", "out_start", "cfg_s", "em")}
            _, attn_mask, _ = row_masks(self.cond, d["cond_lens"], d["text"], d["dur"], d["em"])
            d["text_emb2"] = self.progs.embed(d["text"], attn_mask)
            self._dev = d
        return self._dev

    def dispatch_segment(self) -> torch.Tensor:
        """Queue one k-interval segment on the card and return the new
        trajectory. Slot progress is counted on the host; nothing here waits
        on the card."""
        with GLOBAL_TIMER.stage("batcher.dispatch_segment"):
            return self._advance()

    def _advance(self) -> torch.Tensor:
        """``dispatch_segment``'s work, untimed (the warm-up's segments)."""
        k = self.progs.k
        knots = np.ones((2, k, self.bb), np.float32)  # (t0s, t1s); free and finished slots stay at t0 == t1
        for i, s in enumerate(self.slots):
            if s is None or s.done:
                continue
            ks = s.grid[s.p : s.p + k + 1]
            if len(ks) < k + 1:  # tail segment: pad with dt = 0 no-ops
                ks = np.concatenate([ks, np.full(k + 1 - len(ks), s.grid[-1])])
            knots[0, :, i] = ks[:-1]
            knots[1, :, i] = ks[1:]
        d = self._device_state()
        t = to_device(torch.from_numpy(knots), self.cond.device)
        self.y = self.progs.seg(self.cond, d["cond_lens"], d["text"], d["dur"], d["cfg_s"], self.y, t[0], t[1],
                                d["em"], text_emb2=d["text_emb2"])
        for s in self.slots:
            if s is not None and not s.done:
                s.p = min(s.p + k, len(s.grid) - 1)
        self.age_segments += 1
        return self.y

    def finalize_done(self) -> int:
        """Finalize the finished slots (one ``fin`` over just those rows,
        copied to the host), resolve their futures and free the slots.
        Returns the number finalized."""
        done_idx = [i for i, s in enumerate(self.slots) if s is not None and s.done]
        if not done_idx:
            return 0
        e = self.progs.engine
        d = self._device_state()
        idx = to_device(torch.tensor(done_idx), self.cond.device)
        gen_mel, wave = self.progs.fin(self.cond[idx], d["cond_lens"][idx], d["text"][idx], d["dur"][idx],
                                       self.y[idx], d["out_start"][idx], d["em"][idx])
        gen_mel, wave = gen_mel.cpu().numpy(), wave.cpu().numpy()
        for j, i in enumerate(done_idx):
            s = self.slots[i]
            gen_len = int(self.dur[i]) - int(self.out_start[i])
            if not s.job.future.done():
                s.job.future.set_result((wave[j, : e._wave_samples(gen_len)], gen_mel[j, :gen_len]))
            self.slots[i] = None
            self.cfg_s[i] = 0.0  # freed slot: degenerate knots keep it a no-op until re-admission
        self._dev = None
        return len(done_idx)

    def fail_all(self, exc: BaseException) -> None:
        for i, s in enumerate(self.slots):
            if s is not None and not s.job.future.done():
                s.job.future.set_exception(exc)
            self.slots[i] = None


class StepBatcher:
    """Drop-in replacement for ``ContinuousBatcher`` with mid-solve
    join/leave. ``segment_intervals`` trades per-segment host work for join
    latency: with the serving default (Ralston, 10 intervals) and k = 2, a
    request waits at most about a fifth of a solve per running group before it
    integrates. ``adaptive``: when exactly one group is active and the queue
    is empty, its remaining segments are dispatched back to back (one wait at
    the end); the chain stops the moment a request is queued."""

    def __init__(self, engine: TTSEngine, segment_intervals: int = 2, max_queue: int = 256, max_groups: int = 8,
                 adaptive: bool = False):
        self.engine = engine
        self.progs = SegmentPrograms(engine, segment_intervals)
        self.max_queue = max_queue
        self.max_groups = max_groups
        self.adaptive = adaptive
        self._jobs: list[_Job] = []
        self._groups: list[SolveGroup] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._strict_pool: ThreadPoolExecutor | None = None
        self.stats = {"batches": 0, "rows": 0, "max_batch_seen": 0,
                      "segments": 0, "mid_solve_joins": 0, "groups_started": 0}

    # -- ContinuousBatcher-compatible surface --------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="tts-step-batcher", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stop = True
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=30)
            self._thread = None
        with self._lock:
            orphans, self._jobs = self._jobs, []
        for job in orphans:
            if not job.future.done():
                job.future.set_exception(OverloadedError("batcher stopped during unload"))
        for g in self._groups:
            g.fail_all(OverloadedError("batcher stopped during unload"))
        self._groups = []
        if getattr(self, "_strict_pool", None) is not None:
            self._strict_pool.shutdown(wait=False)
            self._strict_pool = None

    def submit(self, row: RowSpec) -> Future:
        if getattr(row, "quality", "default") == "strict":
            # strict rows need the whole solve's embedded estimate and a
            # possible recipe escalation (engine.synthesize_rows): a side thread
            # runs them, so the segment loop stays unblocked
            with self._lock:
                if self._stop:
                    f: Future = Future()
                    f.set_exception(OverloadedError("batcher stopped (model unloading)"))
                    return f
                if self._strict_pool is None:
                    self._strict_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tts-strict")
                pool = self._strict_pool
            return pool.submit(lambda: self.engine.synthesize_rows([row])[0])
        job = _Job(row)
        with self._lock:
            if self._stop:
                job.future.set_exception(OverloadedError("batcher stopped (model unloading)"))
                return job.future
            if len(self._jobs) >= self.max_queue:
                job.future.set_exception(OverloadedError(f"batcher queue full ({self.max_queue})"))
                return job.future
            self._jobs.append(job)
        self._wake.set()
        return job.future

    async def submit_async(self, row: RowSpec):
        return await asyncio.wrap_future(self.submit(row))

    # -- scheduler -----------------------------------------------------------

    def _bucket_of(self, r: RowSpec) -> int:
        return _bucket(max(r.duration, r.ref_frames + 2), self.engine.cfg.duration_buckets)

    def _admit_queued(self) -> None:
        with self._lock:
            jobs, self._jobs = self._jobs, []
        if not jobs:
            return
        not_yet_admitted = {id(j) for j in jobs}
        try:
            self._admit_jobs(jobs, not_yet_admitted)
        except BaseException:
            # a crash mid-admission must not drop drained but unadmitted jobs:
            # re-queue them so the death handler (or the next tick) sees them
            with self._lock:
                self._jobs = [j for j in jobs if id(j) in not_yet_admitted] + self._jobs
            raise

    def _admit_jobs(self, jobs: list[_Job], not_yet_admitted: set[int]) -> None:
        cfg = self.engine.cfg
        caps = dict(cfg.solve_batch_caps)
        by_bucket: dict[int, list[_Job]] = {}
        for j in jobs:
            by_bucket.setdefault(self._bucket_of(j.row), []).append(j)
        leftovers: list[_Job] = []
        for nb, pend in by_bucket.items():
            # fill free slots of running groups first (the mid-solve join)
            for g in self._groups:
                if g.nb != nb:
                    continue
                for _ in g.free_slots():
                    if not pend:
                        break
                    self._place(g, pend.pop(0), not_yet_admitted)
                    if g.age_segments > 0:
                        self.stats["mid_solve_joins"] += 1
            # the rest start new groups sized to the backlog
            while pend:
                if len(self._groups) >= self.max_groups:
                    leftovers += pend  # beyond the group cap: the next tick
                    pend = []
                    break
                cap = min(caps.get(nb, cfg.batch_buckets[-1]), cfg.batch_buckets[-1])
                bb = _bucket(min(len(pend), cap), cfg.batch_buckets)
                g = SolveGroup(self.progs, nb, bb)
                self._groups.append(g)
                self.stats["groups_started"] += 1
                n_admit = min(len(pend), bb)
                for job in pend[:n_admit]:
                    self._place(g, job, not_yet_admitted)
                pend = pend[n_admit:]
                self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], n_admit)
        if leftovers:
            with self._lock:
                self._jobs = leftovers + self._jobs

    def _place(self, g: SolveGroup, job: _Job, not_yet_admitted: set[int]) -> None:
        g.admit(job)
        not_yet_admitted.discard(id(job))
        self.stats["rows"] += 1
        GLOBAL_TIMER.record("batcher.queue_wait", time.perf_counter() - job.submitted)

    def _run(self):
        try:
            self._run_loop()
        finally:
            # resolve every outstanding future and fail later submits fast;
            # the drain fails what it drains on both exits (a job submitted
            # while the worker sat in its last tick would otherwise wait out
            # its caller's whole result() timeout)
            with self._lock:
                died = not self._stop
                self._stop = True
                orphans, self._jobs = self._jobs, []
            exc = OverloadedError("batcher worker died mid-solve" if died else "batcher stopped during unload")
            for job in orphans:
                if not job.future.done():
                    job.future.set_exception(exc)
            if died:
                for g in self._groups:
                    g.fail_all(exc)
                self._groups = []

    def _wait(self) -> None:
        """One CUDA event after the tick's last segment: the host tick tracks
        the card's progress."""
        with GLOBAL_TIMER.stage("batcher.tick_wait"):
            if self.engine.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
                event.synchronize()

    def _run_loop(self):
        while True:
            if not self._groups:
                self._wake.wait(timeout=0.1)
                self._wake.clear()
            if self._stop:
                break
            try:
                self._admit_queued()
                if not self._groups:
                    continue
                # one segment per active group, queued back to back
                active = [g for g in self._groups if g.active()]
                n = 0
                for g in active:
                    g.dispatch_segment()
                    n += 1
                if self.adaptive and len(active) == 1:
                    # low load: the sole group chains the rest of its solve
                    g = active[0]
                    while g.active() and not self._stop:
                        with self._lock:
                            if self._jobs:
                                break
                        g.dispatch_segment()
                        n += 1
                        self.stats["chained_segments"] = self.stats.get("chained_segments", 0) + 1
                if n:
                    self._wait()
                    self.stats["segments"] += n
                for g in self._groups:
                    if g.finalize_done():
                        self.stats["batches"] += 1
                self._groups = [g for g in self._groups if any(s is not None for s in g.slots)]
            except Exception as e:
                for g in self._groups:
                    g.fail_all(e)
                self._groups = []
                with self._lock:
                    jobs, self._jobs = self._jobs, []
                for job in jobs:
                    if not job.future.done():
                        job.future.set_exception(e)

    # -- warmup --------------------------------------------------------------

    def warmup(self, buckets: list[tuple[int, int]] | None = None) -> None:
        """Build the engine's kernels and run a tiny synthetic row through a
        group of each (duration, batch) shape, so the first requests meet no
        first-use costs. Not counted in ``stats`` or ``GLOBAL_TIMER``."""
        e = self.engine
        e.load_kernels()
        caps = dict(e.cfg.solve_batch_caps)
        for nb, bb in buckets or [(e.cfg.duration_buckets[0], e.cfg.batch_buckets[0])]:
            g = SolveGroup(self.progs, nb, min(bb, caps.get(nb, bb)))
            rng = np.random.default_rng(0)
            row = RowSpec(text="warmup", cond_mel=rng.standard_normal((8, e.cfg.mel.n_mels)).astype(np.float32),
                          ref_frames=8, duration=min(64, nb), steps=e.cfg.sampler.steps,
                          cfg_strength=e.cfg.sampler.cfg_strength, seed=0)
            g.admit(_Job(row))
            while g.active():
                g._advance()
            g.finalize_done()
