"""The port's HTTP app (``f5tts_tpu_torch/serve/server.py`` over
``serve/service.py``) through ``aiohttp.test_utils`` at ``demo_tiny`` on the
CPU: the routes of ``tests/test_server.py``, the serving cases of
``tests/test_failure_recovery.py`` (automatic reload, worker death failing
the waiters of both batchers, a NaN solve failing only its own request on
the step path, hot swap under traffic), one table of requests sent to the
JAX app and the port's (same statuses, content types and WAV lengths), and
the command line (``--device cpu`` serves; without a GPU it raises)."""

import asyncio
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from f5tts_tpu_torch.audio.io import read_wav, wav_bytes
from f5tts_tpu_torch.engine.batcher import ContinuousBatcher, OverloadedError
from f5tts_tpu_torch.engine.engine import RowSpec
from f5tts_tpu_torch.engine.step_batcher import StepBatcher
from f5tts_tpu_torch.serve.schemas import SpeechRequest
from f5tts_tpu_torch.serve.server import build_app
from f5tts_tpu_torch.serve.service import ModelService, ServiceError
from f5tts_tpu_torch.utils.config import Settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _settings(**kw):
    return Settings(**{"demo_tiny": True, "warmup": False, "speech_rate_limit": "100/minute", "device": "cpu", **kw})


class _App:
    """One app on its own event loop, with a blocking request helper."""

    def __init__(self, app):
        self.app, self.loop = app, asyncio.new_event_loop()
        self.client = TestClient(TestServer(app, loop=self.loop), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def __call__(self, method, path, **kw):
        resp = self.loop.run_until_complete(self.client.request(method, path, **kw))
        return resp, self.loop.run_until_complete(resp.read())

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


@pytest.fixture(scope="module")
def client():
    c = _App(build_app(_settings()))
    yield c
    c.close()


def _app_with(**kw):
    return _App(build_app(_settings(**kw)))


def test_health_and_index(client):
    resp, body = client("GET", "/v1/health")
    data = json.loads(body)
    assert resp.status == 200 and data["status"] == "healthy" and data["device"] == "cpu"
    assert "consecutive_failures" in data and "mid_solve_joins" in data  # batcher=auto serves on StepBatcher
    resp, body = client("GET", "/")
    assert resp.status == 200 and "/v1/audio/speech" in body.decode() and "/v1/speech_edit" in body.decode()


def test_speech_roundtrip(client):
    resp, body = client("POST", "/v1/audio/speech", json={"text": "server test sentence.", "nfe_step": 2, "seed": 4})
    assert resp.status == 200 and resp.headers["Content-Type"].startswith("audio/wav")
    assert resp.headers["X-Response-Time"].endswith("s") and resp.headers["Access-Control-Allow-Origin"] == "*"
    wav, sr = read_wav(bytes(body))
    assert sr == 24000 and len(wav) > 1000 and np.isfinite(wav).all()
    _, body2 = client("POST", "/v1/audio/speech", json={"text": "server test sentence.", "nfe_step": 2, "seed": 4})
    assert body2 == body  # a fixed seed is deterministic


def test_speech_streaming_with_cors(client):
    resp, body = client("POST", "/v1/audio/speech",
                        json={"text": "stream me please.", "nfe_step": 2, "response_format": "stream", "seed": 2})
    assert resp.status == 200 and resp.headers.get("Access-Control-Allow-Origin") == "*"
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    pcm = np.frombuffer(body[44:], dtype=np.int16)
    _, whole = client("POST", "/v1/audio/speech", json={"text": "stream me please.", "nfe_step": 2, "seed": 2})
    wav, _ = read_wav(bytes(whole))
    assert len(pcm) == len(wav) > 1000  # one chunk: the stream is the whole request


def test_error_paths(client):
    for kw, status in [({"json": {"text": ""}}, 400), ({"json": {"text": "x", "voice": "ghost"}}, 400),
                       ({"data": b"nonsense"}, 400), ({"json": {"text": "hi", "nfe_step": 0}}, 400),
                       ({"json": ["text"]}, 400)]:
        assert client("POST", "/v1/audio/speech", **kw)[0].status == status
    assert client("POST", "/v1/indic_chat", json={"prompt": "hi", "src_lang": "hin_Deva"})[0].status == 501
    assert client("POST", "/v1/translate", json={"sentences": ["hi"], "src_lang": "a", "tgt_lang": "b"})[0].status == 501
    assert client("POST", "/v1/transcribe/", data=b"not multipart")[0].status == 400
    assert client("POST", "/v1/speech_to_speech", data=b"not multipart")[0].status == 400
    resp, _ = client("OPTIONS", "/v1/audio/speech")
    assert resp.status == 200 and resp.headers["Access-Control-Allow-Methods"] == "GET,POST,OPTIONS"


def test_voices_webui_metrics(client):
    resp, body = client("GET", "/v1/voices")
    assert resp.status == 200 and "default" in json.loads(body)["voices"]
    resp, body = client("GET", "/app")
    assert resp.status == 200 and b"Synthesize" in body
    resp, body = client("GET", "/v1/metrics")
    assert resp.status == 200 and {"stages", "batcher", "quality_escalations"} <= set(json.loads(body))
    resp, body = client("GET", "/metrics")
    text = body.decode()
    assert resp.headers["Content-Type"].startswith("text/plain") and "f5tpu_model_loaded 1" in text
    assert "f5tpu_reloads_total" in text and "f5tpu_batcher_segments" in text
    assert client("GET", "/v1/metrics?format=prometheus")[1].decode().startswith("# HELP")


def test_metrics_serve_the_fixed_names(client):
    """A step-batched and a strict request (``synthesize_rows`` on the side
    thread) fill the engine's and the batcher's fixed spans and counters."""
    for quality in ("default", "strict"):
        resp, _ = client("POST", "/v1/audio/speech",
                         json={"text": "metrics request.", "nfe_step": 2, "seed": 5, "quality": quality})
        assert resp.status == 200
    data = json.loads(client("GET", "/v1/metrics")[1])
    names = {"engine.prepare_request", "engine.finalize_request", "engine.pack", "engine.dispatch",
             "engine.fetch_wait", "batcher.dispatch_segment", "batcher.tick_wait", "batcher.queue_wait"}
    assert names <= set(data["stages"]) and names <= set(data["totals"]["times"])
    assert not [n for n in data["stages"] if n.startswith(("sample_decode", "escalate"))]
    counters = data["totals"]["counters"]
    assert counters["engine.solves"] >= 1 and counters["engine.frames_solved"] >= counters["engine.frames_needed"] > 0
    text = client("GET", "/metrics")[1].decode()
    assert f"\nf5tpu_engine_solves_total {counters['engine.solves']}\n" in text
    assert "# TYPE f5tpu_engine_frames_needed_total counter" in text
    assert 'f5tpu_stage_ms_sum{stage="engine.dispatch"}' in text
    assert 'f5tpu_stage_ms_count{stage="batcher.queue_wait"}' in text


def test_speech_edit_route(client):
    wav = (np.random.default_rng(0).standard_normal(24000) * 0.1).astype(np.float32)
    resp, body = client("POST", "/v1/speech_edit", data={
        "file": io.BytesIO(wav_bytes(wav, 24000)), "target_text": "edited words here.", "parts": "0.2,0.5",
        "nfe_step": "2", "seed": "3"})
    assert resp.status == 200, body
    out, sr = read_wav(bytes(body))
    assert sr == 24000 and len(out) == (24000 // 256 - 1) * 256 and np.isfinite(out).all()
    for data in ({"file": io.BytesIO(wav_bytes(wav, 24000)), "target_text": "x.", "parts": "garbage"},
                 {"target_text": "x.", "parts": "0.1,0.2"},
                 {"file": io.BytesIO(wav_bytes(wav, 24000)), "target_text": "x.", "parts": "0.1,0.2",
                  "fix_durations": "0.1;0.2"}):
        assert client("POST", "/v1/speech_edit", data=data)[0].status == 400


def test_concurrent_requests_share_step_batches(client):
    async def fire(i):
        resp = await client.client.request("POST", "/v1/audio/speech",
                                           json={"text": f"concurrent request number {i}.", "nfe_step": 4, "seed": i})
        return resp.status, await resp.read()

    async def run_all():
        return await asyncio.gather(*(fire(i) for i in range(6)))

    assert all(status == 200 for status, _ in client.loop.run_until_complete(run_all()))
    stats = json.loads(client("GET", "/v1/metrics")[1])["batcher"]
    assert stats["rows"] >= 6 and stats["max_batch_seen"] >= 2, stats


def test_multistyle_speech(client):
    resp, body = client("POST", "/v1/audio/speech", json={
        "text": "First part. {default} second part [not a voice]. {Regular} third.", "nfe_step": 2, "seed": 9})
    assert resp.status == 200
    wav, sr = read_wav(bytes(body))
    _, body2 = client("POST", "/v1/audio/speech", json={"text": "First part.", "nfe_step": 2, "seed": 9})
    assert sr == 24000 and np.isfinite(wav).all() and len(wav) > len(read_wav(bytes(body2))[0])


def test_visual_query_gated(client):
    assert client("POST", "/v1/visual_query", data={"query": "what is this?"})[0].status == 400
    png = bytes.fromhex("89504e470d0a1a0a0000000d49484452000000010000000108020000009077" +
                        "53de0000000c4944415408d763f8cfc000000301010018dd8db00000000049454e44ae426082")
    resp, body = client("POST", "/v1/visual_query", data={"file": io.BytesIO(png), "query": "q", "src_lang": "eng_Latn"})
    assert resp.status == 501, body
    assert client("POST", "/v1/document_query_batch", data={"file": io.BytesIO(png), "query": "q"})[0].status == 501


def test_voice_slot_management(client):
    def tone():
        sr = 24000
        return wav_bytes((np.sin(2 * np.pi * 300 * np.arange(sr) / sr) * 0.2).astype(np.float32), sr)

    form = aiohttp.FormData()
    form.add_field("name", "narrator_f")
    form.add_field("ref_text", "a calm narration voice.")
    form.add_field("file", tone(), filename="v.wav", content_type="audio/wav")
    resp, body = client("POST", "/v1/voices", data=form)
    assert resp.status == 200 and "narrator_f" in json.loads(body)["voices"]
    resp, body = client("POST", "/v1/audio/speech", json={"text": "testing the new voice.", "voice": "narrator_f",
                                                          "nfe_step": 2})
    assert resp.status == 200, body
    bad = aiohttp.FormData()
    bad.add_field("name", "../evil")
    bad.add_field("file", tone(), filename="v.wav", content_type="audio/wav")
    assert client("POST", "/v1/voices", data=bad)[0].status == 400
    assert client("DELETE", "/v1/voices/ghost")[0].status == 404
    resp, body = client("DELETE", "/v1/voices/narrator_f")
    assert resp.status == 200 and json.loads(body)["voices"] == ["default"]
    assert client("DELETE", "/v1/voices/default")[0].status == 400  # the last voice stays


def test_model_info_and_ckpt_picker_rollback(client, tmp_path):
    resp, body = client("GET", "/v1/model")
    assert resp.status == 200 and json.loads(body)["demo_tiny"] is True
    resp, body = client("POST", "/v1/load_model", json={"tts_ckpt": "/nonexistent/model.pt",
                                                        "tts_vocab": "/nonexistent/vocab.txt",
                                                        "vocoder_ckpt": "/nonexistent/vocos.bin"})
    assert resp.status == 400 and "nonexistent" in json.loads(body)["error"]
    for name in ("m.pt", "v.txt", "voc.bin"):
        (tmp_path / name).write_text("not a checkpoint")
    resp, body = client("POST", "/v1/load_model", json={"tts_ckpt": str(tmp_path / "m.pt"),
                                                        "tts_vocab": str(tmp_path / "v.txt"),
                                                        "vocoder_ckpt": str(tmp_path / "voc.bin")})
    err = json.loads(body)
    assert resp.status == 400 and "m.pt" in err["error"] and err["rollback"] == "previous model restored"
    resp, body = client("POST", "/v1/audio/speech", json={"text": "rolled back fine.", "nfe_step": 2})
    assert resp.status == 200 and body[:4] == b"RIFF"


def test_unload_load_cycle(client):
    assert client("POST", "/v1/unload_all_models")[0].status == 200
    assert client("POST", "/v1/audio/speech", json={"text": "hi."})[0].status == 503
    assert client("POST", "/v1/speech_edit", data={"target_text": "x"})[0].status == 503
    assert json.loads(client("GET", "/v1/health")[1])["status"] == "idle"
    assert client("POST", "/v1/load_all_models")[0].status == 200
    assert client("POST", "/v1/audio/speech", json={"text": "hi again.", "nfe_step": 2})[0].status == 200


def test_server_sampler_knobs_and_batchers():
    """cfg_cache reaches the engine and (auto) takes the window batcher;
    batcher=step serves concurrent requests on StepBatcher; the env knobs
    build the sampler as the JAX service does."""
    c = _app_with(cfg_cache=2)
    try:
        resp, body = c("POST", "/v1/audio/speech", json={"text": "cached guidance.", "nfe_step": 4})
        svc = c.app["service"]
        assert resp.status == 200 and body[:4] == b"RIFF" and svc.engine.cfg.sampler.cfg_cache_period == 2
        assert isinstance(svc.batcher, ContinuousBatcher)
    finally:
        c.close()
    c = _app_with(batcher="step")
    try:
        async def burst():
            resps = await asyncio.gather(*(c.client.request("POST", "/v1/audio/speech",
                                                            json={"text": f"step batched {i}.", "nfe_step": 2})
                                           for i in range(3)))
            return [(r.status, await r.read()) for r in resps]

        assert all(st == 200 and b[:4] == b"RIFF" for st, b in c.loop.run_until_complete(burst()))
        svc = c.app["service"]
        assert isinstance(svc.batcher, StepBatcher) and not svc.batcher.adaptive and svc.batcher.stats["rows"] >= 3
    finally:
        c.close()
    for kw, want in [({}, ("ralston", 10, 1)), ({"ode_method": "euler", "nfe": 32}, ("euler", 32, 1)),
                     ({"cfg_cache": 4}, ("euler", 32, 4)), ({"ode_method": "midpoint", "nfe": 16}, ("midpoint", 8, 1))]:
        svc = ModelService(_settings(**kw))
        svc.load()
        s = svc.engine.cfg.sampler
        assert (s.method, s.steps, s.cfg_cache_period) == want
        svc.unload()


def test_unported_models_raise_at_load(tmp_path):
    """Parler without a checkpoint and a tokenizer raises the JAX server's
    error (Parler checkpoints are read since A.6); BigVGAN (A.5) and torch
    checkpoints (A.3) are read, and a file that is no checkpoint raises naming
    itself."""
    svc = ModelService(_settings(vocoder_type="bigvgan"))
    svc.load()
    assert svc.engine.cfg.vocoder_type == "bigvgan"
    svc.unload()
    with pytest.raises(ValueError, match="needs F5TPU_PARLER_CKPT and F5TPU_PARLER_TOKENIZER"):
        ModelService(_settings(demo_tiny=False, tts_model="parler")).load()
    (tmp_path / "vocab.txt").write_text("a\nb\n")
    for ckpt, what in [("model.safetensors", "model.safetensors: cannot read"), ("model.pt", "model.pt: cannot read"),
                       ("model.h5", "not a checkpoint")]:
        (tmp_path / ckpt).write_text("x")
        svc = ModelService(_settings(demo_tiny=False, tts_ckpt=str(tmp_path / ckpt), tts_vocab=str(tmp_path / "vocab.txt"),
                                     vocoder_ckpt=str(tmp_path / ckpt)))
        with pytest.raises(ValueError, match=what):
            svc.load()
        assert not svc.loaded and svc.batcher is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelService(Settings(demo_tiny=True, warmup=False)).load()  # device "cuda" and no card here


def test_npz_checkpoints_serve(tmp_path):
    """The ``.npz`` params trees load as the served model (at the tiny
    geometry here, through the same path as the F5-TTS Base checkpoints)."""
    from f5tts_tpu_torch.models import convert
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.models.vocos import VocosConfig
    from f5tts_tpu_torch.serve import service as service_mod

    svc = ModelService(_settings(tts_ckpt=str(tmp_path / "f5.npz"), vocoder_ckpt=str(tmp_path / "vocos.npz")))
    dit = convert.init_dit_numpy(DiTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20,
                                           text_num_embeds=256, text_dim=32, conv_layers=1, max_pos=1024), seed=0)
    convert.save_params_npz(str(tmp_path / "f5.npz"), dit)
    convert.save_params_npz(str(tmp_path / "vocos.npz"), convert.init_vocos_numpy(
        VocosConfig(input_channels=20, dim=48, intermediate_dim=96, num_layers=2), seed=1))
    loaded = service_mod.load_checkpoint_tree(str(tmp_path / "f5.npz"))
    assert loaded["blocks"]["attn"]["to_q"]["w"].shape == dit["blocks"]["attn"]["to_q"]["w"].shape
    svc.load()  # demo_tiny: the random trees equal the saved ones
    body = svc.synthesize_sync(SpeechRequest(text="from the checkpoint.", nfe_step=2, seed=1))
    assert body[:4] == b"RIFF"
    svc.unload()


def test_failed_load_leaves_service_unloaded(tmp_path):
    (tmp_path / "bad.wav").write_bytes(b"RIFFnope")
    settings = _settings(voices_dir=str(tmp_path))
    service = ModelService(settings)
    with pytest.raises(Exception):
        service.load()
    assert not service.loaded and service.batcher is None
    settings.voices_dir = ""
    service.load()
    assert service.loaded and "default" in service.voices
    service.unload()


def test_server_parler_branch():
    """tts_model=parler serves the autoregressive branch on random weights:
    44.1 kHz, deterministic, the stream equals the batch path, an over-budget
    text 400s alone, and speech edit is 501 there."""
    c = _app_with(tts_model="parler")
    try:
        assert json.loads(c("GET", "/v1/health")[1])["model"].endswith("-parler")
        req = {"text": "parler utterance.", "seed": 3, "description": "a calm speaker."}
        resp, body = c("POST", "/v1/audio/speech", json=req)
        wav, sr = read_wav(bytes(body))
        assert resp.status == 200 and sr == 44100 and len(wav) > 100 and np.isfinite(wav).all()
        assert c("POST", "/v1/audio/speech", json=req)[1] == body
        resp, sbody = c("POST", "/v1/audio/speech", json={**req, "response_format": "stream"})
        streamed = np.frombuffer(bytes(sbody)[44:], dtype="<i2").astype(np.float32) / 32768.0
        assert resp.status == 200 and len(streamed) == len(wav)
        np.testing.assert_allclose(streamed, wav, atol=2 / 32768.0)
        assert json.loads(c("GET", "/v1/model")[1])["tts_model"] == "parler"
        resp, body = c("POST", "/v1/audio/speech", json={"text": "y" * 500, "description": "a speaker."})
        assert resp.status == 400 and json.loads(body)["error"].startswith("text is")
        resp, _ = c("POST", "/v1/audio/speech", json={"text": "y" * 500, "response_format": "stream"})
        assert resp.status == 400
        assert c("POST", "/v1/audio/speech", json={"text": "hello."})[0].status == 200
        assert json.loads(c("GET", "/v1/health")[1])["consecutive_failures"] == 0
        assert c("POST", "/v1/speech_edit", data={"target_text": "x"})[0].status == 501
    finally:
        c.close()


# -- failure recovery (tests/test_failure_recovery.py's serving cases) ------


def _wait_reload(service, deadline_s=120):
    deadline = time.time() + deadline_s
    while time.time() < deadline and service.reloads == 0:
        time.sleep(0.05)


def test_auto_reload_after_consecutive_failures():
    service = ModelService(_settings(batcher="window"))
    service.load()

    def broken(*a, **kw):
        raise RuntimeError("device lost")

    service.engine.synthesize_rows = broken
    for _ in (1, 2):
        with pytest.raises(ServiceError) as e:
            service.synthesize_sync(SpeechRequest(text="hello there."))
        assert e.value.status == 500 and e.value.body["error"].startswith("synthesis failed")
    _wait_reload(service)
    assert service.reloads == 1 and service.failures == 0 and service.loaded
    assert service.engine.synthesize_rows is not broken
    service.unload()


@pytest.mark.parametrize("batcher", ["window", "step"])
def test_batcher_worker_death_fails_waiters(batcher):
    """A BaseException that kills the worker thread resolves the queued
    futures and makes later submits fail fast, on both batchers."""
    row = RowSpec(text="x", cond_mel=np.zeros((4, 16), np.float32), ref_frames=4, duration=16, steps=1)
    if batcher == "window":
        class _Eng:
            def synthesize_rows(self, rows):
                raise SystemExit("simulated worker death")

        b = ContinuousBatcher(_Eng(), max_wait_ms=1).start()
    else:
        b = StepBatcher.__new__(StepBatcher)
        b._jobs, b._groups, b._lock, b._wake = [], [], threading.Lock(), threading.Event()
        b._stop, b._thread, b._strict_pool, b.max_queue, b.stats = False, None, None, 16, {}
        b._admit_queued = lambda: (_ for _ in ()).throw(SystemExit("simulated death"))
        b.start()
    with pytest.raises(OverloadedError, match="died"):
        b.submit(row).result(timeout=30)
    with pytest.raises(OverloadedError):
        b.submit(row).result(timeout=5)


def _fire_pair(service, bad: dict, good: dict) -> dict:
    results = {}

    def fire(tag, kw):
        try:
            results[tag] = ("ok", service.synthesize_sync(SpeechRequest(nfe_step=2, **kw)))
        except ServiceError as e:
            results[tag] = ("http", e.status)

    ts = [threading.Thread(target=fire, args=("bad", bad)), threading.Thread(target=fire, args=("good", good))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    return results


def test_nan_solve_fails_only_faulty_request_window():
    service = ModelService(_settings(batcher="window"))
    service.load()
    orig = service.engine.synthesize_rows

    def poisoned(rows):
        return [((np.full_like(w, np.nan), m) if "poison" in r.text else (w, m)) for r, (w, m) in zip(rows, orig(rows))]

    service.engine.synthesize_rows = poisoned
    results = _fire_pair(service, {"text": "poison this one."}, {"text": "a clean sentence."})
    assert results["bad"] == ("http", 500)
    assert results["good"][0] == "ok" and results["good"][1][:4] == b"RIFF"
    service.unload()


def test_step_path_nan_fails_only_poisoned_request(monkeypatch):
    """Poison one row's trajectory inside the segment program (keyed on its
    distinctive per-row guidance strength): that request 500s, its
    co-batched neighbour succeeds."""
    import torch

    import f5tts_tpu_torch.engine.step_batcher as sb

    service = ModelService(_settings(batcher="step"))
    service.load()
    orig_seg = sb.solve_segment

    def poisoned_seg(*a, **kw):
        y = orig_seg(*a, **kw)
        return torch.where((kw["cfg_strength"] == 7.77)[:, None, None], torch.nan, y)

    monkeypatch.setattr(sb, "solve_segment", poisoned_seg)
    results = _fire_pair(service, {"text": "poison this one.", "cfg_strength": 7.77},
                         {"text": "a clean sentence.", "cfg_strength": 2.0})
    assert results["bad"] == ("http", 500)
    assert results["good"][0] == "ok" and results["good"][1][:4] == b"RIFF"
    service.unload()


def test_step_path_failure_counts_and_reloads(monkeypatch):
    import f5tts_tpu_torch.engine.step_batcher as sb

    service = ModelService(_settings(batcher="step"))
    service.load()
    orig_seg = sb.solve_segment

    def broken_seg(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(sb, "solve_segment", broken_seg)
    for _ in (1, 2):
        with pytest.raises(ServiceError) as e:
            service.synthesize_sync(SpeechRequest(text="hello there.", nfe_step=2))
        assert e.value.status == 500
    _wait_reload(service)
    monkeypatch.setattr(sb, "solve_segment", orig_seg)
    assert service.reloads == 1 and service.loaded
    assert service.synthesize_sync(SpeechRequest(text="after the reload.", nfe_step=2))[:4] == b"RIFF"
    service.unload()


def test_hot_swap_under_traffic_is_clean():
    """Unload + load racing live traffic: every request succeeds or fails
    with a clean 503/500, nothing hangs, and traffic succeeds after."""
    service = ModelService(_settings())
    service.load()
    stop = threading.Event()
    outcomes = []

    def traffic():
        while not stop.is_set():
            try:
                outcomes.append(("ok", service.synthesize_sync(SpeechRequest(text="live traffic.", nfe_step=2))[:4]))
            except ServiceError as e:
                outcomes.append(("http", e.status))
            time.sleep(0.01)

    threads = [threading.Thread(target=traffic) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    service.unload()
    service.load()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=300)
    assert outcomes and all(v == b"RIFF" if kind == "ok" else v in (500, 503) for kind, v in outcomes)
    assert service.synthesize_sync(SpeechRequest(text="after the swap.", nfe_step=2))[:4] == b"RIFF"
    service.unload()


# -- the JAX app and the port's, one table of requests ----------------------


def _tone_wav() -> bytes:
    return wav_bytes((np.random.default_rng(0).standard_normal(24000) * 0.1).astype(np.float32), 24000)


TABLE = [
    ("POST", "/v1/audio/speech", {"json": {"text": "server test sentence.", "nfe_step": 2, "seed": 4}}),
    ("POST", "/v1/audio/speech", {"json": {"text": "a longer one, with an openai model field.", "nfe_step": 2,
                                           "seed": 1, "model": "tts-1", "speed": "1.2"}}),
    ("POST", "/v1/audio/speech", {"json": {"text": "stream me please.", "nfe_step": 2, "response_format": "stream"}}),
    ("POST", "/v1/audio/speech", {"json": {"text": ""}}),
    ("POST", "/v1/audio/speech", {"json": {"text": "x", "voice": "ghost"}}),
    ("POST", "/v1/audio/speech", {"json": {"text": "x", "voice": "ghost", "response_format": "stream"}}),
    ("POST", "/v1/audio/speech", {"data": b"nonsense"}),
    ("POST", "/v1/audio/speech", {"json": {"text": "hi.", "nfe_step": 0}}),
    ("POST", "/v1/audio/speech", {"json": {"text": "hi.", "speed": 9}}),
    ("POST", "/v1/audio/speech", {"json": {"text": "hi.", "language": "nope_Xxxx"}}),
    ("POST", "/v1/speech_edit", {"data": {"file": _tone_wav(), "target_text": "edited words here.", "parts": "0.2,0.5",
                                          "nfe_step": "2", "seed": "3"}}),
    ("POST", "/v1/speech_edit", {"data": {"file": _tone_wav(), "target_text": "x.", "parts": "garbage"}}),
    ("POST", "/v1/speech_edit", {"data": {"target_text": "x.", "parts": "0.1,0.2"}}),
    ("POST", "/v1/indic_chat", {"json": {"prompt": "hi", "src_lang": "hin_Deva"}}),
    ("POST", "/v1/indic_chat", {"json": {"prompt": ""}}),
    ("POST", "/v1/translate", {"json": {"sentences": ["hi"], "src_lang": "a", "tgt_lang": "b"}}),
    ("POST", "/v1/translate", {"json": {"sentences": []}}),
    ("POST", "/v1/transcribe/", {"data": b"not multipart"}),
    ("POST", "/v1/visual_query", {"data": {"query": "what?"}}),
    ("DELETE", "/v1/voices/ghost", {}),
    ("GET", "/v1/voices", {}), ("GET", "/v1/health", {}), ("GET", "/v1/metrics", {}), ("GET", "/metrics", {}),
    ("GET", "/", {}), ("GET", "/app", {}), ("GET", "/v1/model", {}), ("OPTIONS", "/v1/audio/speech", {}),
    ("POST", "/v1/load_model", {"json": {"tts_ckpt": "/nonexistent/m.pt"}}),
    ("POST", "/v1/load_model", {"json": {"tts_ckpt": __file__, "tts_vocab": __file__, "vocoder_ckpt": __file__,
                                         "vocoder_type": "hifigan"}}),
]


def _wav_samples(resp, body) -> int | None:
    if not resp.headers.get("Content-Type", "").startswith("audio/wav") or resp.status != 200:
        return None
    return (len(body) - 44) // 2  # int16 mono after the 44-byte header (also the streamed form)


def test_request_table_matches_the_jax_app():
    from f5tts_tpu.serve.server import build_app as j_build_app
    from f5tts_tpu.utils.config import Settings as JSettings

    apps = {"jax": _App(j_build_app(JSettings(demo_tiny=True, warmup=False, speech_rate_limit="100/minute"))),
            "torch": _app_with()}
    try:
        rows = {name: [] for name in apps}
        for method, path, entry in TABLE:
            for name, app in apps.items():
                kw = entry
                if isinstance(entry.get("data"), dict):  # a fresh upload stream for each app
                    kw = {"data": {k: io.BytesIO(v) if isinstance(v, bytes) else v for k, v in entry["data"].items()}}
                resp, body = app(method, path, **kw)
                rows[name].append((method, path, resp.status, resp.headers.get("Content-Type", "").split(";")[0],
                                   _wav_samples(resp, body)))
        assert rows["torch"] == rows["jax"]
        assert sum(r[4] is not None and r[4] > 1000 for r in rows["torch"]) == 4  # three speech (one streamed), one edit
    finally:
        for app in apps.values():
            app.close()


# -- the command line --------------------------------------------------------


def test_server_cli_serves_on_cpu_and_raises_without_a_gpu():
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", "f5tts_tpu_torch.serve.server", "--demo-tiny"], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "f5tts_tpu_torch.serve.server", "--demo-tiny", "--device", "cpu",
                             "--host", "127.0.0.1", "--port", str(port)], env={**env, "F5TPU_WARMUP": "0"}, cwd=REPO,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 90
        health = None
        while time.time() < deadline and health is None:
            try:
                with urllib.request.urlopen(base + "/v1/health", timeout=5) as r:
                    health = json.loads(r.read())
            except OSError:
                time.sleep(0.2)
        assert health is not None and health["status"] == "healthy" and health["device"] == "cpu"
        req = urllib.request.Request(base + "/v1/audio/speech", data=json.dumps({"text": "hi there.", "nfe_step": 2})
                                     .encode(), headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            wav, sr = read_wav(r.read())
        assert sr == 24000 and len(wav) > 1000
    finally:
        proc.terminate()
        proc.wait(timeout=30)
