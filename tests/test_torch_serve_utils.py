"""The port's serving utilities against the JAX package's on tables of
inputs: ``Settings`` (validation, env parsing), ``parse_rate_limit``,
``load_deployment_config`` (the repo's ``deploy_config.json`` included), the
dataclass ``SpeechRequest`` against the JAX pydantic model (same accept or
reject, same values), ``split_style_segments``, ``wav_bytes`` (byte-equal,
clipping and half-LSB values included), the stage timer, the torch.profiler
trace, and the chat/ASR gating without local weights."""

import dataclasses
import json
import os

import numpy as np
import pytest

from f5tts_tpu.audio.io import wav_bytes as j_wav_bytes
from f5tts_tpu.serve.schemas import SpeechRequest as JRequest
from f5tts_tpu.text.chunker import split_style_segments as j_split
from f5tts_tpu.utils import config as jcfg
from f5tts_tpu.utils.profiling import StageTimer as JTimer
from f5tts_tpu_torch.audio.io import wav_bytes as t_wav_bytes
from f5tts_tpu_torch.serve.schemas import SpeechRequest as TRequest
from f5tts_tpu_torch.text.chunker import split_style_segments as t_split
from f5tts_tpu_torch.utils import config as tcfg
from f5tts_tpu_torch.utils.profiling import StageTimer as TTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, TypeError, KeyError) as e:
        return ("error", type(e).__name__ if not isinstance(e, ValueError) else "ValueError")


def _fields(s) -> dict:
    return {k: v for k, v in dataclasses.asdict(s).items() if k != "device"}


SETTINGS = [
    {}, {"speech_rate_limit": "5/minute"}, {"speech_rate_limit": "whenever"}, {"chat_rate_limit": "3/fortnight"},
    {"speech_rate_limit": ""}, {"cfg_interval": "0.2,0.8"}, {"cfg_interval": "0.2"}, {"cfg_interval": "0.2,0.8", "cfg_cache": 2},
    {"cfg_cache": 0}, {"cfg_cache": 4}, {"ode_method": "rk4"}, {"ode_method": "dopri"},
    {"ode_method": "ralston", "cfg_cache": 2}, {"ode_method": "euler", "cfg_interval": "0.1,0.9"}, {"nfe": -1},
    {"nfe": 16}, {"vocoder_type": "bigvgan"}, {"vocoder_type": "hifigan"}, {"tts_model": "parler"},
    {"tts_model": "e2"}, {"batcher": "window"}, {"batcher": "continuous"}, {"batcher": "step", "cfg_cache": 4},
    {"batcher": "auto", "cfg_cache": 4}, {"batcher_segment_intervals": 0}, {"batcher_segment_intervals": 3},
]


@pytest.mark.parametrize("kw", SETTINGS)
def test_settings_validation_matches_jax(kw):
    got, want = _outcome(lambda: _fields(tcfg.Settings(**kw))), _outcome(lambda: _fields(jcfg.Settings(**kw)))
    assert got == want
    if got[0] == "ok":
        assert tcfg.Settings(**kw).device == "cuda" and jcfg.Settings(**kw).device == "tpu"


def test_settings_from_env_matches_jax(monkeypatch):
    env = {"F5TPU_PORT": "9001", "F5TPU_BATCH_WAIT_MS": "2.5", "F5TPU_WARMUP": "no", "F5TPU_LAZY_LOAD_MODEL": "true",
           "F5TPU_NFE": "12", "F5TPU_ODE_METHOD": "heun", "F5TPU_BATCHER": "step", "F5TPU_DEVICE": "cpu"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t, j = tcfg.Settings.from_env(host="127.0.0.1", port=None), jcfg.Settings.from_env(host="127.0.0.1", port=None)
    assert _fields(t) == _fields(j) and t.device == j.device == "cpu" and t.port == 9001 and t.warmup is False


@pytest.mark.parametrize("spec", ["5/minute", "100/hour", "1/second", "7/day", "3/fortnight", "five/minute", "5"])
def test_parse_rate_limit_matches_jax(spec):
    assert _outcome(lambda: tcfg.parse_rate_limit(spec)) == _outcome(lambda: jcfg.parse_rate_limit(spec))
    assert bool(tcfg.RATE_LIMIT_RE.match(spec)) == bool(jcfg.RATE_LIMIT_RE.match(spec))
    assert tcfg.SUPPORTED_LANGUAGES == jcfg.SUPPORTED_LANGUAGES


def test_deployment_config_matches_jax(tmp_path):
    cfg = {"global_settings": {"port": 9000, "dtype": "float32", "lazy_load": True, "device": "cpu"},
           "specific_configs": {"config_one": {"tts_ckpt": "/x/model.npz", "voices_dir": "/v", "tts_model": "parler"}}}
    p = tmp_path / "deploy.json"
    p.write_text(json.dumps(cfg))
    cases = [(str(p), "config_one"), (str(p), "config_nine")]
    with open(os.path.join(REPO, "deploy_config.json"), encoding="utf-8") as f:
        names = sorted(json.load(f)["specific_configs"])
    cases += [(os.path.join(REPO, "deploy_config.json"), n) for n in names]
    for path, name in cases:
        got = _outcome(lambda: _fields(tcfg.load_deployment_config(path, name, tcfg.Settings())))
        want = _outcome(lambda: _fields(jcfg.load_deployment_config(path, name, jcfg.Settings())))
        assert got == want, name
    s = tcfg.load_deployment_config(str(p), "config_one", tcfg.Settings())
    assert (s.port, s.dtype, s.lazy_load_model, s.device, s.config_name) == (9000, "float32", True, "cpu", "config_one")


def test_server_arguments_match_jax():
    argv = ["--host", "h", "--port", "1", "--config", "c", "--config-file", "f", "--demo-tiny", "--tts-ckpt", "a",
            "--tts-vocab", "b", "--vocoder-ckpt", "d", "--voices-dir", "e"]
    t, j = vars(tcfg.parse_arguments(argv)), vars(jcfg.parse_arguments(argv))
    assert t.pop("device") is None and t == j
    assert tcfg.parse_arguments(["--device", "cpu"]).device == "cpu"


REQUESTS = [
    {}, {"text": "hello"}, {"input": "hello"}, {"text": "x" * 100_001}, {"input": "x" * 100_000},
    {"text": "hi", "language": "kan_Knda"}, {"text": "hi", "language": "nope_Xxxx"}, {"language": None},
    {"speed": 0.3}, {"speed": 3.0}, {"speed": 0.29}, {"speed": 3.0000001}, {"speed": "1.5"}, {"speed": " 2 "},
    {"speed": "abc"}, {"speed": None}, {"speed": True}, {"speed": float("nan")}, {"speed": float("inf")},
    {"speed": "1_0"}, {"speed": ".5"}, {"speed": "1e0"}, {"speed": [1]},
    {"nfe_step": 0}, {"nfe_step": 1}, {"nfe_step": 128}, {"nfe_step": 129}, {"nfe_step": 2.0}, {"nfe_step": 2.5},
    {"nfe_step": "3"}, {"nfe_step": " 4 "}, {"nfe_step": "+4"}, {"nfe_step": "04"}, {"nfe_step": "4.00"},
    {"nfe_step": "4."}, {"nfe_step": "4.5"}, {"nfe_step": "-0"}, {"nfe_step": True}, {"nfe_step": None},
    {"cfg_strength": 0.0}, {"cfg_strength": 10.0}, {"cfg_strength": -0.1}, {"cfg_strength": 10.5},
    {"cfg_strength": "2"}, {"cfg_strength": "inf"}, {"seed": 7}, {"seed": "7"}, {"seed": "-3"}, {"seed": 3.0},
    {"seed": 1.5}, {"seed": True}, {"seed": "1e3"}, {"seed": "1_000"}, {"seed": float("inf")}, {"seed": 2**40},
    {"quality": "strict"}, {"quality": "best"}, {"quality": None}, {"response_format": "stream"},
    {"response_format": None}, {"text": 5}, {"text": None}, {"voice": 3}, {"voice": "narrator"},
    {"description": "calm."}, {"ref_text": "ref."}, {"text": "a", "model": "tts-1"},
    # non-ASCII digits are refused, underscore digit groups in floats taken, as pydantic does
    {"nfe_step": "\u0661\u0662"}, {"seed": "\uff13"}, {"speed": "\uff13"}, {"cfg_strength": "\uff13"},
    {"cfg_strength": "1_0"}, {"cfg_strength": "1.2_5"}, {"cfg_strength": "1_0e0"}, {"cfg_strength": "1e0_0"},
    {"cfg_strength": "1._5"}, {"cfg_strength": "1_e0"}, {"cfg_strength": "+_1"}, {"cfg_strength": " 1_0 "},
    {"cfg_strength": "_1"}, {"cfg_strength": "1_"}, {"cfg_strength": "1__0"}, {"speed": "\u0661.5"},
]


@pytest.mark.parametrize("body", REQUESTS, ids=[str(i) for i in range(len(REQUESTS))])
def test_speech_request_matches_pydantic_model(body):
    """Same accept or reject, same field values; unknown keys are ignored
    (OpenAI clients send ``model``)."""
    def values(r):
        return {k: getattr(r, k) for k in ("text", "input", "voice", "description", "ref_text", "language", "speed",
                                           "nfe_step", "cfg_strength", "seed", "response_format", "quality")} | {
            "effective_text": r.effective_text}

    def as_tuple(o):
        return o if o[0] == "error" else ("ok", values(o[1]))

    got = as_tuple(_outcome(lambda: TRequest.from_body(body)))
    want = ("ok", values(JRequest(**body))) if _outcome(lambda: JRequest(**body))[0] == "ok" else ("error", "ValueError")
    assert got == want
    if got[0] == "ok":  # types as well as values
        assert {k: type(v) for k, v in got[1].items()} == {k: type(v) for k, v in want[1].items()}
    with pytest.raises(ValueError):
        TRequest.from_body([body])


@pytest.mark.parametrize("text,known,default", [
    ("plain text without tags.", ["main"], "main"),
    ("First part. {default} second part [not a voice]. {Regular} third.", ["default"], "default"),
    ("{Narrator} once upon a time. [narrator] again. {unknown} stays.", ["narrator", "main"], "main"),
    ("[main] a [b.v-1] b {B.V-1} c", ["main", "b.v-1"], "main"),
    ("   ", ["main"], "main"), ("{main}", ["main"], "main"), ("x {regular} y {REGULAR} z", ["v"], "v"),
])
def test_split_style_segments_matches_jax(text, known, default):
    assert t_split(text, known, default=default) == j_split(text, known, default=default)


@pytest.mark.parametrize("subtype", ["int16", "float32"])
@pytest.mark.parametrize("sr", [24000, 44100])
def test_wav_bytes_byte_equal(subtype, sr):
    lsb = 1.0 / 32767
    audio = np.array([0.0, 0.5 * lsb, 1.5 * lsb, 2.5 * lsb, -0.5 * lsb, -1.5 * lsb, 1.0, -1.0, 1.2, -7.0, 0.25,
                      np.nan if subtype == "float32" else 0.0, 1 - 0.5 * lsb], np.float32)
    audio = np.concatenate([audio, np.random.default_rng(0).uniform(-1.1, 1.1, 997).astype(np.float32)])
    assert t_wav_bytes(audio, sr, subtype) == j_wav_bytes(audio, sr, subtype)
    with pytest.raises(ValueError):
        t_wav_bytes(audio, sr, "int24")


def test_stage_timer_matches_jax():
    t, j = TTimer(window=8), JTimer(window=8)
    for i, s in enumerate([0.003, 0.001, 0.02, 0.5, 0.0004, 0.07, 0.009, 0.002, 0.3, 0.011]):
        for timer in (t, j):
            timer.record("a" if i % 3 else "b", s)
    assert t.summary() == j.summary()
    with t.stage("c"):
        pass
    assert t.summary()["c"]["count"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from f5tts_tpu_torch.utils.profiling import start_device_trace, stop_device_trace

    assert not stop_device_trace()
    assert start_device_trace(str(tmp_path)) and not start_device_trace(str(tmp_path))
    torch.ones(8) @ torch.ones(8)
    assert stop_device_trace()
    (trace,) = list(tmp_path.glob("trace_*.json"))
    assert "traceEvents" in json.loads(trace.read_text())


def test_chat_and_asr_gating_without_weights():
    from f5tts_tpu_torch.audio.io import wav_bytes
    from f5tts_tpu_torch.serve import asr, chat

    with pytest.raises(ImportError):
        chat.indic_chat("hello", "hin_Deva")
    with pytest.raises(ImportError):
        chat.translate(["hello"], "eng_Latn", "hin_Deva")
    with pytest.raises(ImportError):
        chat.document_query_batch([object()], "q", "eng_Latn", "eng_Latn")
    with pytest.raises(ImportError):
        asr.transcribe_bytes(wav_bytes(np.zeros(2400, np.float32)))
    from f5tts_tpu.serve import chat as j_chat

    assert chat.preprocess_batch(["a ", " b"], "hin_Deva", "eng_Latn") == \
        j_chat.preprocess_batch(["a ", " b"], "hin_Deva", "eng_Latn")


def test_service_and_chip_smoke_imports_need_neither_aiohttp_nor_pydantic():
    """The card's machine has neither package: ``serve/service.py`` and every
    port module ``chip_smoke.py`` imports load with both blocked."""
    import ast
    import subprocess
    import sys

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8").read())
    mods = sorted({n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module
                   and n.module.startswith("f5tts_tpu_torch")} | {"f5tts_tpu_torch.serve.service"})
    assert "f5tts_tpu_torch.serve.service" in mods and "f5tts_tpu_torch.engine.step_batcher" in mods
    code = ("import sys\nsys.modules['aiohttp'] = None\nsys.modules['pydantic'] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "assert 'aiohttp' not in [k for k, v in sys.modules.items() if v is not None]\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
