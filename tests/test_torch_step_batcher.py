"""The port's step-level batcher (``f5tts_tpu_torch/engine/step_batcher.py``):
the eleven cases of ``tests/test_step_batcher.py`` within the port, each row
held against the port's own window solve (``synthesize_rows``) from the same
seed, fp32 on the CPU at atol 1e-5 (composition invariance: per-row seeds and
masks isolate rows); plus the exact launch counter under concurrent threads."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from f5tts_tpu_torch.engine.batcher import OverloadedError
from f5tts_tpu_torch.engine.engine import EngineConfig, RowSpec, TTSEngine
from f5tts_tpu_torch.engine.step_batcher import SegmentPrograms, SolveGroup, StepBatcher, _Job
from f5tts_tpu_torch.models.convert import init_dit_numpy, init_vocos_numpy
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.models.vocos import VocosConfig
from f5tts_tpu_torch.ops.mel import MelConfig
from f5tts_tpu_torch.sampling.euler import SamplerConfig
from f5tts_tpu_torch.text.tokenizer import Tokenizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIT = DiTConfig(dim=48, depth=1, heads=2, dim_head=24, ff_mult=2, mel_dim=16, text_num_embeds=120, text_dim=24,
                conv_layers=1, max_pos=256)
VOC = VocosConfig(input_channels=16, dim=32, intermediate_dim=64, num_layers=1)


@pytest.fixture(scope="module")
def trees():
    return init_dit_numpy(DIT, seed=0), init_vocos_numpy(VOC, seed=1)


def _engine(trees, sampler=None):
    return TTSEngine(trees[0], DIT, trees[1], Tokenizer.from_texts(["step batcher test text"]),
                     EngineConfig(mel=MelConfig(n_mels=16), vocoder=VOC,
                                  sampler=sampler or SamplerConfig(method="ralston", steps=2),
                                  duration_buckets=(64,), batch_buckets=(1, 2, 4), text_pad=32,
                                  compute_dtype="float32"), device="cpu")


def _row(i, steps=2, cfg_strength=2.0):
    rng = np.random.default_rng(i)
    return RowSpec(text=f"step row {i}", cond_mel=rng.standard_normal((8, 16)).astype(np.float32),
                   ref_frames=8, duration=48, steps=steps, cfg_strength=cfg_strength, seed=i)


def _drain(g: SolveGroup) -> None:
    while g.active():
        g.dispatch_segment()
        g.finalize_done()


def _assert_same(result, solo):
    np.testing.assert_allclose(result[0], solo[0], atol=1e-5)
    np.testing.assert_allclose(result[1], solo[1], atol=1e-5)


@pytest.mark.parametrize("interval", [False, True])
def test_segmented_group_matches_solo_rows(trees, interval):
    """Rows with different step counts and guidance strengths co-batched in
    one segmented group each equal their solo window solve; with a guidance
    interval too (the gate is per-row data), at another step count."""
    sampler = SamplerConfig(method="euler", steps=4, cfg_interval=(0.3, 0.8)) if interval else None
    engine = _engine(trees, sampler)
    rows = [_row(20, steps=4, cfg_strength=2.0), _row(21, steps=6, cfg_strength=1.5)] if interval else \
        [_row(0, steps=2, cfg_strength=2.0), _row(1, steps=4, cfg_strength=1.5)]
    solo = [engine.synthesize_rows([r])[0] for r in rows]
    g = SolveGroup(SegmentPrograms(engine, segment_intervals=1 if interval else 2), nb=64, bb=2)
    jobs = [_Job(r) for r in rows]
    for j in jobs:
        g.admit(j)
    _drain(g)
    for j, s in zip(jobs, solo):
        _assert_same(j.future.result(timeout=1), s)


def test_mid_solve_join_matches_solo(trees):
    """A row admitted into a slot freed mid-solve (its neighbour still on its
    own knots) equals its solo solve."""
    engine = _engine(trees)
    long_row, short_row, joiner = _row(10, steps=4), _row(11, steps=1), _row(12, steps=2)
    solo = {id(r): engine.synthesize_rows([r])[0] for r in (long_row, short_row, joiner)}
    g = SolveGroup(SegmentPrograms(engine, segment_intervals=1), nb=64, bb=2)
    jobs = {id(r): _Job(r) for r in (long_row, short_row, joiner)}
    g.admit(jobs[id(long_row)])
    g.admit(jobs[id(short_row)])
    g.dispatch_segment()  # the short row finishes and leaves, the long one is mid-flight
    assert g.finalize_done() == 1 and g.active()
    g.admit(jobs[id(joiner)])
    assert next(s for s in g.slots if s is not None and s.job is jobs[id(joiner)]).joined_mid_solve
    _drain(g)
    for r in (long_row, short_row, joiner):
        _assert_same(jobs[id(r)].future.result(timeout=1), solo[id(r)])


def test_edit_row_in_segmented_group(trees):
    """Speech-edit rows (edit_mask infill, whole utterance out) ride the
    segmented path beside a synthesis row."""
    engine = _engine(trees)
    rng = np.random.default_rng(3)
    audio = rng.standard_normal(64 * 256 + 200).astype(np.float32) * 0.05
    edit_row, _ = engine.prepare_edit_row(audio, 24000, "edited text", [(0.05, 0.15)], seed=7)
    assert edit_row.edit_mask is not None and not edit_row.edit_mask.all()
    solo_edit, solo_plain = engine.synthesize_rows([edit_row])[0], engine.synthesize_rows([_row(4)])[0]
    g = SolveGroup(SegmentPrograms(engine, segment_intervals=2), nb=64, bb=2)
    j_edit, j_plain = _Job(edit_row), _Job(_row(4))
    g.admit(j_edit)
    g.admit(j_plain)
    _drain(g)
    _assert_same(j_edit.future.result(timeout=1), solo_edit)
    _assert_same(j_plain.future.result(timeout=1), solo_plain)
    assert len(solo_edit[1]) == edit_row.duration  # the whole utterance comes back


def test_step_batcher_end_to_end_threads(trees):
    engine = _engine(trees)
    b = StepBatcher(engine, segment_intervals=1).start()
    try:
        rows = [_row(i, steps=2) for i in range(5)]
        solo = [engine.synthesize_rows([r])[0] for r in rows]
        results = [f.result(timeout=300) for f in [b.submit(r) for r in rows]]
        for res, s in zip(results, solo):
            _assert_same(res, s)
        assert b.stats["rows"] == 5 and b.stats["segments"] >= 2
    finally:
        b.stop()


def test_step_batcher_late_arrival_joins_running_group(trees):
    """A request submitted while a long solve runs resolves without waiting
    for the long row to finish."""
    engine = _engine(trees)
    b = StepBatcher(engine, segment_intervals=1).start()
    try:
        long_fut = b.submit(_row(20, steps=32))
        time.sleep(0.3)  # the long solve starts
        late = _row(21, steps=1)
        solo = engine.synthesize_rows([late])[0]
        t0 = time.monotonic()
        res = b.submit(late).result(timeout=300)
        late_wall = time.monotonic() - t0
        _assert_same(res, solo)
        assert not long_fut.done() or late_wall < 60
        long_fut.result(timeout=300)
    finally:
        b.stop()


def test_step_batcher_rejects_cached_guidance_sampler(trees):
    engine = _engine(trees)
    engine.cfg = dataclasses.replace(engine.cfg, sampler=SamplerConfig(method="euler", steps=4, cfg_cache_period=2))
    with pytest.raises(ValueError, match="window batcher"):
        StepBatcher(engine)
    engine.cfg = dataclasses.replace(engine.cfg, sampler=SamplerConfig(method="ralston", steps=4, cfg_null_reuse=True))
    with pytest.raises(ValueError, match="window batcher"):
        StepBatcher(engine)


def test_step_batcher_stop_fails_queued():
    b = StepBatcher.__new__(StepBatcher)
    b._jobs = [_Job(row=None)]
    b._groups = []
    b._lock = threading.Lock()
    b._wake = threading.Event()
    b._stop = False
    b._thread = None
    orphan = b._jobs[0].future
    b.stop()
    with pytest.raises(OverloadedError):
        orphan.result(timeout=1)


def test_step_batcher_overload_sheds(trees):
    b = StepBatcher(_engine(trees), max_queue=3)  # not started: the queue only fills
    futs = [b.submit(_row(i)) for i in range(5)]
    assert len([f for f in futs if f.done() and isinstance(f.exception(), OverloadedError)]) == 2
    b._jobs.clear()


def test_adaptive_chaining_low_load(trees):
    """batcher=auto: a sole request's solve chains its segments without a
    host tick each, and the result is unchanged."""
    engine = _engine(trees)
    b = StepBatcher(engine, segment_intervals=1, adaptive=True).start()
    try:
        r = _row(30, steps=4)
        solo = engine.synthesize_rows([r])[0]
        _assert_same(b.submit(r).result(timeout=300), solo)
        assert b.stats.get("chained_segments", 0) >= 1
    finally:
        b.stop()


def test_settings_auto_batcher():
    from f5tts_tpu_torch.utils.config import Settings

    assert Settings().batcher == "auto" and Settings().device == "cuda"
    with pytest.raises(ValueError, match="cfg_cache"):
        Settings(batcher="step", cfg_cache=4)
    Settings(batcher="auto", cfg_cache=4)  # the service falls back to the window batcher


def test_launch_counter_is_exact_under_threads():
    """Request threads, the batcher thread and the strict pool launch the same
    kernels at once: the wrappers' counts go through one lock."""
    from f5tts_tpu_torch.ops.kernels import _build

    def wrapper():
        pass

    wrapper.launches = 0
    threads = [threading.Thread(target=lambda: [_build.count_launch(wrapper) for _ in range(20000)]) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 8 * 20000
