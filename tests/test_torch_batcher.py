"""The port's ``ContinuousBatcher`` (``f5tts_tpu_torch/engine/batcher.py``):
the submit / co-batch / overload / stop contract of the JAX package's batcher,
over a stub engine and over the tiny Parler engine on the CPU."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from f5tts_tpu.engine import batcher as j_batcher
from f5tts_tpu_torch.engine import batcher as t_batcher
from f5tts_tpu_torch.engine.ar_engine import ParlerEngineConfig, ParlerRow, ParlerTTSEngine
from f5tts_tpu_torch.models import convert as t_convert
from f5tts_tpu_torch.models import parler as TP


class StubEngine:
    """``synthesize_rows`` echoes its rows; optionally waits on a gate first."""

    def __init__(self, gate: threading.Event | None = None, fail: BaseException | None = None):
        self.calls: list[list] = []
        self.gate, self.fail = gate, fail

    def synthesize_rows(self, rows):
        self.calls.append(list(rows))
        if self.gate is not None:
            assert self.gate.wait(timeout=30)
        if self.fail is not None:
            raise self.fail
        return [(f"wave of {r}", None) for r in rows]


def test_same_public_surface_as_the_jax_batcher():
    for name in ("start", "stop", "submit", "submit_async"):
        assert callable(getattr(t_batcher.ContinuousBatcher, name)) and hasattr(j_batcher.ContinuousBatcher, name)
    assert issubclass(t_batcher.OverloadedError, RuntimeError)
    b = t_batcher.ContinuousBatcher(StubEngine())
    assert (b.max_batch, b.max_queue, b.stats) == (32, 256, {"batches": 0, "rows": 0, "max_batch_seen": 0})
    assert b.start() is b and b.start() is b  # idempotent, chains
    b.stop()


def _hold_worker(gate_engine, batcher):
    """Submit one job and wait until the worker sits inside the engine with it."""
    first = batcher.submit("held")
    while not gate_engine.calls:
        time.sleep(0.001)
    return first


def test_co_arriving_requests_share_one_batch():
    gate = threading.Event()
    engine = StubEngine(gate)
    b = t_batcher.ContinuousBatcher(engine, max_batch=8, max_wait_ms=20.0).start()
    held = _hold_worker(engine, b)
    futures = [b.submit(i) for i in range(5)]  # all queued while the worker is busy
    gate.set()
    assert held.result(timeout=10) == ("wave of held", None)
    assert [f.result(timeout=10) for f in futures] == [(f"wave of {i}", None) for i in range(5)]
    assert engine.calls == [["held"], [0, 1, 2, 3, 4]]
    assert b.stats == {"batches": 2, "rows": 6, "max_batch_seen": 5}
    b.stop()


def test_batches_are_capped_at_max_batch_and_keep_order():
    gate = threading.Event()
    engine = StubEngine(gate)
    b = t_batcher.ContinuousBatcher(engine, max_batch=2, max_wait_ms=20.0).start()
    _hold_worker(engine, b)
    futures = [b.submit(i) for i in range(5)]
    gate.set()
    assert [f.result(timeout=10)[0] for f in futures] == [f"wave of {i}" for i in range(5)]
    assert engine.calls[1:] == [[0, 1], [2, 3], [4]]
    assert b.stats["batches"] == 4 and b.stats["max_batch_seen"] == 2
    b.stop()


def test_queue_overload_sheds_load():
    gate = threading.Event()
    engine = StubEngine(gate)
    b = t_batcher.ContinuousBatcher(engine, max_batch=1, max_wait_ms=1.0, max_queue=2).start()
    first = _hold_worker(engine, b)
    queued = [b.submit("b"), b.submit("c")]
    shed = b.submit("d")
    with pytest.raises(t_batcher.OverloadedError, match="queue full"):
        shed.result(timeout=1)
    gate.set()
    assert first.result(timeout=10)[0] == "wave of held"
    assert [f.result(timeout=10)[0] for f in queued] == ["wave of b", "wave of c"]
    b.stop()


def test_stop_fails_queued_jobs_and_later_submits():
    gate = threading.Event()
    engine = StubEngine(gate)
    b = t_batcher.ContinuousBatcher(engine, max_batch=1, max_wait_ms=1.0).start()
    running = _hold_worker(engine, b)
    queued = b.submit("b")
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    gate.set()
    stopper.join(timeout=10)
    assert running.result(timeout=10)[0] == "wave of held"  # the batch in flight finishes
    with pytest.raises(t_batcher.OverloadedError, match="stopped"):
        queued.result(timeout=1)
    with pytest.raises(t_batcher.OverloadedError, match="stopped"):
        b.submit("c").result(timeout=1)


def test_engine_errors_reach_the_callers_and_the_worker_lives_on():
    engine = StubEngine(fail=ValueError("bad row"))
    b = t_batcher.ContinuousBatcher(engine, max_batch=4, max_wait_ms=20.0).start()
    futures = [b.submit(i) for i in range(2)]
    for f in futures:
        with pytest.raises(ValueError, match="bad row"):
            f.result(timeout=10)
    engine.fail = None
    assert b.submit(7).result(timeout=10) == ("wave of 7", None)
    b.stop()


def test_a_dead_worker_fails_its_batch_and_refuses_new_work():
    class Fatal(BaseException):
        pass

    engine = StubEngine(fail=Fatal())
    b = t_batcher.ContinuousBatcher(engine, max_batch=4, max_wait_ms=20.0)
    b._thread = threading.Thread(target=lambda: _swallow(b._run, Fatal), daemon=True)
    b._thread.start()
    doomed = b.submit("a")
    with pytest.raises(t_batcher.OverloadedError, match="died"):
        doomed.result(timeout=10)
    with pytest.raises(t_batcher.OverloadedError):
        b.submit("b").result(timeout=1)


def _swallow(fn, exc):
    try:
        fn()
    except exc:
        pass


def test_submit_async():
    b = t_batcher.ContinuousBatcher(StubEngine(), max_wait_ms=5.0).start()

    async def go():
        return await asyncio.gather(b.submit_async("x"), b.submit_async("y"))

    assert asyncio.run(go()) == [("wave of x", None), ("wave of y", None)]
    b.stop()


def test_parler_requests_through_the_batcher():
    """Three requests co-batch into one bucket-of-4 decode of the tiny Parler
    engine, and each gets the wave it would get alone (greedy)."""
    torch.backends.cudnn.allow_tf32 = False
    t5_cfg = TP.T5Config(vocab=60, d_model=24, d_kv=6, d_ff=32, heads=4, layers=2, rel_buckets=8, rel_max_dist=20)
    dec_cfg = TP.ParlerDecoderConfig(vocab=40, codebooks=4, hidden=32, layers=2, heads=4, ffn=48, cross_dim=24,
                                     prompt_vocab=60)
    dac_cfg = TP.DacConfig(num_codebooks=4, codebook_size=40, codebook_dim=6, latent_dim=24, decoder_dim=16, rates=(4, 2))
    engine = ParlerTTSEngine(
        t_convert.init_t5_numpy(t5_cfg), t5_cfg, t_convert.init_parler_decoder_numpy(dec_cfg), dec_cfg,
        t_convert.init_dac_numpy(dac_cfg), dac_cfg,
        ParlerEngineConfig(max_frames=8, temperature=0.0, eos_token=-1, compute_dtype="float32", batch_buckets=(1, 2, 4)),
        encode_fn=lambda s: [ord(c) % 60 for c in s], device="cpu")
    sizes = []
    batch = engine.synthesize_batch
    engine.synthesize_batch = lambda d, p, **kw: (sizes.append(len(d)), batch(d, p, **kw))[1]
    rows = [ParlerRow(f"speaker {i}.", f"utterance number {i}.", seed=i) for i in range(3)]
    b = t_batcher.ContinuousBatcher(engine, max_batch=32, max_wait_ms=1000.0).start()
    results = [f.result(timeout=120) for f in [b.submit(r) for r in rows]]
    b.stop()
    assert sizes == [4] and b.stats == {"batches": 1, "rows": 3, "max_batch_seen": 3}
    for row, (wave, extra) in zip(rows, results):
        assert extra.shape == (dec_cfg.codebooks, 8) and wave.shape == (8 * dac_cfg.hop,)  # codes beside the wave
        assert np.isfinite(wave).all() and np.abs(wave).max() > 0
        np.testing.assert_allclose(wave, engine.synthesize_rows([row])[0][0], atol=1e-5)
    with pytest.raises(ValueError, match="token budget"):  # an oversized request fails alone, before batching
        engine.validate_lengths("d" * 100, "hi.")
