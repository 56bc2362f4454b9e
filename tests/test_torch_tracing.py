"""The port's tracer (``f5tts_tpu_torch/utils/profiling.py``'s ``StageTimer``
and ``GLOBAL_TIMER``) and the fixed spans, device events and counters the
engine and the step batcher take: totals and counters under threads, the
summary, the recording state (no ``record_function`` and no interval while
it is off; nested intervals on ``time.time_ns()`` while it is on), a Chrome
trace of a tiny CPU ``synthesize_rows``, and the engine's counters against
a hand count. One ``cuda`` test checks on the card that each solve's kernels
start after its ``engine.dispatch`` span opens, on ``time.time_ns()``.
Imports neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_tracing.py
"""

import contextlib
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from f5tts_tpu_torch.engine.engine import EngineConfig, RowSpec, TTSEngine
from f5tts_tpu_torch.engine.step_batcher import StepBatcher
from f5tts_tpu_torch.models.convert import init_dit_numpy, init_vocos_numpy
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.models.vocos import VocosConfig
from f5tts_tpu_torch.ops.mel import MelConfig
from f5tts_tpu_torch.sampling.euler import SamplerConfig
from f5tts_tpu_torch.text.tokenizer import Tokenizer
from f5tts_tpu_torch.utils import profiling
from f5tts_tpu_torch.utils.profiling import GLOBAL_TIMER, StageTimer

DIT = DiTConfig(dim=48, depth=1, heads=2, dim_head=24, ff_mult=2, mel_dim=16, text_num_embeds=120, text_dim=24,
                conv_layers=1, max_pos=256)
VOC = VocosConfig(input_channels=16, dim=32, intermediate_dim=64, num_layers=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Under the suite's parallel workers the CPU is oversubscribed; the tiny
    solves here run on one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    return init_dit_numpy(DIT, seed=0), init_vocos_numpy(VOC, seed=1)


def _engine(trees, **kw):
    cfg = dict(mel=MelConfig(n_mels=16), vocoder=VOC, sampler=SamplerConfig(method="ralston", steps=2),
               duration_buckets=(64, 128), batch_buckets=(1, 2, 4), solve_batch_caps=((64, 2), (128, 4)),
               text_pad=32, compute_dtype="float32")
    return TTSEngine(trees[0], DIT, trees[1], Tokenizer.from_texts(["tracing test rows"]),
                     EngineConfig(**{**cfg, **kw}), device="cpu")


def _row(i, duration, quality="default"):
    rng = np.random.default_rng(i)
    return RowSpec(text=f"row {i}", cond_mel=rng.standard_normal((8, 16)).astype(np.float32), ref_frames=8,
                   duration=duration, steps=2, cfg_strength=2.0, seed=i, quality=quality)


def _delta(before: dict, after: dict) -> dict:
    """Counts and counters added between two ``totals()``."""
    out = {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()}
    out.update({k: v["count"] - before["times"].get(k, {"count": 0})["count"] for k, v in after["times"].items()})
    return {k: v for k, v in out.items() if v}


class _RecordFunctionLog:
    """Stands in for ``torch.profiler.record_function``: logs the ranges opened."""

    opened: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _RecordFunctionLog.opened.append(self.name)

    def __exit__(self, *exc):
        return False


@pytest.fixture
def rf_log(monkeypatch):
    _RecordFunctionLog.opened = []
    monkeypatch.setattr(torch.profiler, "record_function", _RecordFunctionLog)
    return _RecordFunctionLog.opened


# -- the tracer --------------------------------------------------------------


def test_totals_and_counters_add_up_across_threads():
    """More threads than cores, a short switch interval: no update is lost."""
    t = StageTimer(window=8)
    n_threads, n_iter = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                with t.stage("s"):
                    pass
                t.add("c", 3)
                t.record("r", 0.5)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    tot = t.totals()
    assert tot["counters"] == {"c": 3 * n_threads * n_iter}
    assert tot["times"]["s"]["count"] == tot["times"]["r"]["count"] == n_threads * n_iter
    assert tot["times"]["r"]["total_s"] == 0.5 * n_threads * n_iter
    assert 0 < tot["times"]["s"]["total_s"] < 60
    assert t.summary()["r"] == {"count": n_threads * n_iter, "p50_ms": 500.0, "p95_ms": 500.0, "max_ms": 500.0}


def test_summary_keeps_its_rolling_window_while_totals_count_everything():
    t = StageTimer(window=4)
    values = [0.004, 0.001, 0.03, 0.002, 0.5, 0.007]
    for s in values:
        t.record("a", s)
    # the window holds the last four: 0.03, 0.002, 0.5, 0.007
    assert t.summary() == {"a": {"count": 6, "p50_ms": 30.0, "p95_ms": 500.0, "max_ms": 500.0}}
    assert t.totals() == {"times": {"a": {"count": 6, "total_s": sum(values)}}, "counters": {}}
    assert t.intervals == type(t.intervals)() and not t.recording_on


@pytest.mark.parametrize("recording", [False, True])
def test_a_span_records_only_while_recording(rf_log, recording):
    t = StageTimer()
    with t.recording() if recording else contextlib.nullcontext():
        with t.stage("x"):
            pass
    assert not t.recording_on  # the state before the block comes back
    assert t.totals()["times"]["x"]["count"] == 1
    assert rf_log == (["x"] if recording else [])
    assert len(t.intervals) == int(recording)


@pytest.mark.parametrize("shape", ["nested", "sequential"])
def test_intervals_follow_the_wall_clock_and_nest(rf_log, shape):
    t = StageTimer()
    w0 = time.time_ns()
    with t.recording():
        if shape == "nested":
            with t.stage("outer"):
                with t.stage("inner"):
                    time.sleep(0.002)
        else:
            for name in ("first", "second"):
                with t.stage(name):
                    time.sleep(0.002)
    w1 = time.time_ns()
    iv = list(t.intervals)
    assert all(w0 <= s <= e <= w1 for _, s, e in iv)
    assert [e for _, _, e in iv] == sorted(e for _, _, e in iv)  # appended as they close
    if shape == "nested":
        (inner, s_in, e_in), (outer, s_out, e_out) = iv
        assert (inner, outer) == ("inner", "outer") and s_out <= s_in and e_in <= e_out
        assert rf_log == ["outer", "inner"]
    else:
        (_, s1, e1), (_, s2, e2) = iv
        assert e1 <= s2 and e2 - s2 >= 2_000_000
        assert rf_log == ["first", "second"]


def test_intervals_are_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_INTERVALS", 3)
    t = StageTimer()
    with t.recording():
        for i in range(5):
            with t.stage(f"s{i}"):
                pass
    assert [name for name, _, _ in t.intervals] == ["s2", "s3", "s4"]
    assert t.totals()["times"]["s0"]["count"] == 1


# -- the engine and the step batcher ------------------------------------------


def test_device_trace_of_synthesize_rows_holds_the_engine_spans(trees, tmp_path):
    engine = _engine(trees)
    rows = [_row(i, 40) for i in range(3)]
    assert profiling.start_device_trace(str(tmp_path)) and GLOBAL_TIMER.recording_on
    try:
        engine.synthesize_rows(rows)
    finally:
        assert profiling.stop_device_trace()
    assert not GLOBAL_TIMER.recording_on
    (trace,) = list(tmp_path.glob("trace_*.json"))
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"engine.pack", "engine.dispatch", "engine.fetch_wait"} <= names


def test_engine_counts_solves_and_frames_against_a_hand_count(trees):
    engine = _engine(trees)
    calls = []
    inner = engine.bucket_program

    def counted(cond, *args, **kw):
        calls.append(tuple(cond.shape[:2]))
        return inner(cond, *args, **kw)

    before = GLOBAL_TIMER.totals()
    engine.warmup([(64, 2), (128, 4)])
    assert _delta(before, GLOBAL_TIMER.totals()) == {}  # the warm-up counts nothing

    # bucket 64 (cap 2): five rows in solves of 2, 2, 1; bucket 128 (cap 4): three rows in one solve of 4
    durations = [40, 50, 60, 64, 30, 100, 128, 70]
    engine.bucket_program = counted
    before = GLOBAL_TIMER.totals()
    out = engine.synthesize_rows([_row(i, d) for i, d in enumerate(durations)])
    got = _delta(before, GLOBAL_TIMER.totals())
    assert len(out) == len(durations)
    assert sorted(calls) == [(1, 64), (2, 64), (2, 64), (4, 128)]
    assert got == {"engine.solves": 4, "engine.frames_solved": 5 * 64 + 4 * 128,
                   "engine.frames_needed": sum(durations),
                   "engine.pack": 4, "engine.dispatch": 4, "engine.fetch_wait": 4}  # no CUDA events on the CPU


def test_escalated_solves_count_under_the_same_names(trees):
    engine = _engine(trees, strict_threshold=-1.0)  # every strict row escalates
    before = GLOBAL_TIMER.totals()
    engine.synthesize_rows([_row(i, 40, quality="strict") for i in range(3)])
    got = _delta(before, GLOBAL_TIMER.totals())
    assert engine.escalations == 3
    assert got["engine.solves"] == 4 and got["engine.frames_solved"] == 2 * (2 + 1) * 64  # solves of 2 and 1, twice
    assert got["engine.frames_needed"] == 2 * 3 * 40


def test_requests_count_prepare_and_finalize_spans(trees):
    engine = _engine(trees)
    ref = (np.sin(np.arange(12000) * 0.05) * 0.1).astype(np.float32)
    before = GLOBAL_TIMER.totals()
    for text in ("one short request.", "and another one."):
        engine.synthesize(text, ref, 24000, "a reference clip.", nfe_step=2, seed=1)
    got = _delta(before, GLOBAL_TIMER.totals())
    assert got["engine.prepare_request"] == got["engine.finalize_request"] == 2
    assert got["engine.solves"] >= 2


def test_step_batcher_spans_and_queue_waits(trees):
    engine = _engine(trees, duration_buckets=(64,), solve_batch_caps=((64, 4),))
    batcher = StepBatcher(engine, segment_intervals=1)
    before = GLOBAL_TIMER.totals()
    batcher.warmup([(64, 2)])
    assert _delta(before, GLOBAL_TIMER.totals()) == {}  # the warm-up counts nothing
    batcher.start()
    try:
        futures = [batcher.submit(_row(i, 48)) for i in range(3)]
        for f in futures:
            f.result(timeout=120)
    finally:
        batcher.stop()
    got = _delta(before, GLOBAL_TIMER.totals())
    assert got["batcher.queue_wait"] == 3
    assert got["batcher.dispatch_segment"] == batcher.stats["segments"] >= 2
    assert got["batcher.tick_wait"] >= 1
    assert "engine.solves" not in got  # segments are not synthesize_rows solves


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's CUDA events and kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_solve_kernels_start_after_their_dispatch_opens(dev):
    """The program's intervals (``time.time_ns()``) and the profiler's device
    timestamps are on one clock: every kernel of a solve starts after that
    solve's ``engine.dispatch`` span opened. The three solves have one shape,
    so each launches the same kernels, in order on one stream: the device
    timeline's kernels split into three equal runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = DiTConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, mel_dim=16, text_num_embeds=120,
                    text_dim=32, conv_layers=1, max_pos=512)
    engine = TTSEngine(init_dit_numpy(cfg, seed=0), cfg, init_vocos_numpy(VOC, seed=1),
                       Tokenizer.from_texts(["tracing test rows"]),
                       EngineConfig(mel=MelConfig(n_mels=16), vocoder=VOC, duration_buckets=(256,),
                                    batch_buckets=(1, 2), solve_batch_caps=((256, 2),), text_pad=32),
                       device=dev)
    engine.warmup([(256, 2)])
    rows = [_row(i, 200) for i in range(6)]
    engine.synthesize_rows(rows)  # first use of the pipeline's pinned buffers
    torch.cuda.synchronize()
    GLOBAL_TIMER.intervals.clear()
    before = GLOBAL_TIMER.totals()
    with GLOBAL_TIMER.recording(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.synthesize_rows(rows)
        torch.cuda.synchronize()
    got = _delta(before, GLOBAL_TIMER.totals())
    assert got["engine.solves"] == 3 and got["engine.solve_device"] == 3 and got["engine.solve_gap"] == 2
    opens = [s for name, s, _ in GLOBAL_TIMER.intervals if name == "engine.dispatch"]
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    kernels = sorted(e.start_ns() for e in events if not e.is_user_annotation() and "Memcpy" not in e.name())
    assert len(opens) == 3 and kernels and len(kernels) % 3 == 0, (opens, len(kernels))
    k = len(kernels) // 3
    leads = [kernels[i * k] - opens[i] for i in range(3)]
    copies = sorted(e.name() for e in events if "Memcpy" in e.name())
    print(f"{k} kernels a solve; first kernel after its dispatch opened (us):",
          [round(x / 1e3, 1) for x in leads], "; copies:", {n: copies.count(n) for n in set(copies)},
          "; annotations on the device:", sorted({e.name() for e in events if e.is_user_annotation()}))
    assert all(x >= 0 for x in leads), leads
