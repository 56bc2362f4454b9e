"""``quality="strict"`` requests seen from outside the engine (counterpart of
``scripts/strict_live_probe.py``).

Three requests go to a served F5-TTS model: ``easy_strict`` (short text,
strict), ``hard_strict`` (long text, strict) and ``hard_default`` (long
text, default quality). Each row records the request's latency, its WAV
bytes and how far the server's escalation counter moved (a strict row whose
embedded error estimate passes the engine's ``strict_threshold`` is solved
again with the reference recipe, Euler 32). Two transports:

- ``http``: ``python -m f5tts_tpu_torch.serve.server`` as a subprocess with
  ``F5TPU_*`` settings, the counter read from ``/v1/metrics``'
  ``quality_escalations``; the server's process group is killed at the end;
- ``service``: ``serve/service.py:ModelService`` in this process (for a
  machine without aiohttp), the counter read from ``service.engine.escalations``.

The model is the teacher ``.npz`` (``--teacher``), or with
``--seeded-teacher`` a seeded F5-TTS Base tree written as ``.npz`` (no
trained teacher is in the repository: escalations on random weights say
whether the mechanism fires on that field, not how well the threshold is
calibrated), or with
``--demo-tiny`` the service's ``demo_tiny`` model. Vocos weights are random,
the 256-line vocabulary and the harmonic reference voice are written to the
work directory. ``run(...)`` is the work of ``main`` on given settings.

    python -m f5tts_tpu_torch.scripts.strict_live_probe --transport service --seeded-teacher   # one CUDA card
    python -m f5tts_tpu_torch.scripts.strict_live_probe --demo-tiny --device cpu --transport http
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

from f5tts_tpu_torch.utils.device import resolve_device
from f5tts_tpu_torch.utils.timing import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORDS = ["the", "hill", "wind", "voice", "stone", "light", "river", "song"]
VOCAB_SIZE = 256  # DiTConfig.base().text_num_embeds: the service sizes the text embedding from the vocabulary


def write_assets(work: str, seeded_teacher: bool = False) -> dict:
    """The vocabulary, random Vocos weights, the reference voice and (with
    ``seeded_teacher``) the seeded Base tree in ``work``: the settings that
    name them."""
    from f5tts_tpu_torch.audio.io import write_wav
    from f5tts_tpu_torch.models.convert import init_dit_numpy, init_vocos_numpy, save_params_npz
    from f5tts_tpu_torch.models.dit import DiTConfig

    os.makedirs(work, exist_ok=True)
    vocab_path = os.path.join(work, "vocab256.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write(" \n")
        for c in "abcdefghijklmnopqrstuvwxyz.,?!'-":
            f.write(c + "\n")
        for i in range(VOCAB_SIZE - 33):
            f.write(f"<tok{i}>\n")
    voc_path = os.path.join(work, "vocos_rand.npz")
    if not os.path.exists(voc_path):
        save_params_npz(voc_path, init_vocos_numpy(seed=1))
    voice_dir = os.path.join(work, "voices")
    os.makedirs(voice_dir, exist_ok=True)
    wav_path = os.path.join(voice_dir, "default.wav")
    if not os.path.exists(wav_path):
        sr = 24000
        t = np.arange(int(1.4 * sr)) / sr
        write_wav(wav_path, sum(0.22 * np.sin(2 * np.pi * f0 * t) for f0 in (160.0, 320.0, 480.0)).astype(np.float32),
                  sr)
    with open(os.path.join(voice_dir, "default.txt"), "w", encoding="utf-8") as f:
        f.write("a reference sentence for the probe.")
    settings = {"tts_vocab": vocab_path, "vocoder_ckpt": voc_path, "voices_dir": voice_dir}
    if seeded_teacher:
        teacher = os.path.join(work, "teacher_seeded_base.npz")
        if not os.path.exists(teacher):
            save_params_npz(teacher, init_dit_numpy(DiTConfig(text_num_embeds=VOCAB_SIZE), seed=0))
        settings["tts_ckpt"] = teacher
    return settings


def requests(easy_chars: int = 40, hard_chars: int = 420) -> list[tuple[str, dict]]:
    """The three requests, their texts drawn from a seeded generator."""
    rng = np.random.default_rng(0)

    def text_of(nchars):
        s = ""
        while len(s) < nchars:
            s += rng.choice(WORDS) + " "
        return s.strip() + "."

    return [(name, {"text": text_of(nchars), "quality": quality, "seed": 7}) for name, nchars, quality in (
        ("easy_strict", easy_chars, "strict"), ("hard_strict", hard_chars, "strict"),
        ("hard_default", hard_chars, "default"))]


def probe(send, escalations, reqs, card: str = "", log=print) -> dict:
    """``send(body) -> wav bytes`` each request, reading ``escalations()``
    before and after it; ``card`` names the device beside each latency."""
    rows = {}
    for name, body in reqs:
        m0 = escalations()
        t0 = time.perf_counter()
        wav = send(body)
        dt = time.perf_counter() - t0
        m1 = escalations()
        rows[name] = {"latency_s": round(dt, 4), "wav_bytes": len(wav), "escalations_delta": m1 - m0,
                      "metrics_after": {"quality_escalations": m1}}
        log(f"{name}: {rows[name]} ({card})")
    return rows


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def http_transport(settings: dict, work: str, timeout: float = 1800.0):
    """``(send, escalations, threshold)`` against the server started as a
    subprocess with ``settings`` as ``F5TPU_*`` variables; its start and each
    request get ``timeout`` seconds; its process group is killed on exit."""
    port = free_port()
    env = {**os.environ, **{f"F5TPU_{k.upper()}": ("1" if v is True else "0" if v is False else str(v))
                            for k, v in settings.items()},
           "PYTHONPATH": os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    log_path = os.path.join(work, "server.log")
    with open(log_path, "w") as server_log:
        srv = subprocess.Popen([sys.executable, "-m", "f5tts_tpu_torch.serve.server", "--host", "127.0.0.1",
                                "--port", str(port)], env=env, cwd=REPO, stdout=server_log,
                               stderr=subprocess.STDOUT, start_new_session=True)
    try:
        deadline = time.time() + timeout
        while True:
            if srv.poll() is not None:
                raise RuntimeError(f"the server exited with {srv.returncode} (see {log_path})")
            try:
                if _get(port, "/v1/health").get("status") == "healthy":
                    break
            except OSError:
                pass
            if time.time() > deadline:
                raise RuntimeError(f"the server did not become healthy (see {log_path})")
            time.sleep(0.2)

        def send(body):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/audio/speech", data=json.dumps(body).encode(),
                                         headers={"content-type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.read()

        yield send, lambda: _get(port, "/v1/metrics").get("quality_escalations", 0), None
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(os.getpgid(srv.pid), signal.SIGTERM)
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(os.getpgid(srv.pid), signal.SIGKILL)
            srv.wait()


@contextlib.contextmanager
def service_transport(settings: dict):
    """``(send, escalations, threshold)`` against a ``ModelService`` in this
    process; unloaded on exit."""
    from f5tts_tpu_torch.serve.schemas import SpeechRequest
    from f5tts_tpu_torch.serve.service import ModelService
    from f5tts_tpu_torch.utils.config import Settings

    service = ModelService(Settings(**settings))
    service.load()
    try:
        yield (lambda body: service.synthesize_sync(SpeechRequest(**body)), lambda: service.engine.escalations,
               service.engine.cfg.strict_threshold)
    finally:
        service.unload()


def run(transport: str, settings: dict, work: str, *, easy_chars: int = 40, hard_chars: int = 420,
        timeout: float = 1800.0, log=print) -> dict:
    """The three requests over ``transport`` (``http`` | ``service``) to the
    model ``settings`` name: the probe's JSON. ``timeout``: the server's start
    and each HTTP request."""
    card = card_line(resolve_device(settings.get("device", "cuda")))
    reqs = requests(easy_chars, hard_chars)
    opened = http_transport(settings, work, timeout) if transport == "http" else service_transport(settings)
    with opened as (send, escalations, threshold):
        rows = probe(send, escalations, reqs, card, log)
    if threshold is None:  # the served engine's own, read where the subprocess reads it
        from f5tts_tpu_torch.engine.engine import EngineConfig

        threshold = EngineConfig().strict_threshold
    return {"teacher": "demo_tiny" if settings.get("demo_tiny") else settings.get("tts_ckpt"),
            "transport": transport, "threshold": threshold, "card": card,
            "note": "on random or toy weights the escalations say whether the mechanism fires on this field, "
                    "not how well the threshold is calibrated", "rows": rows}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.strict_live_probe")
    p.add_argument("--teacher", default=".cache_dc1500/teacher.npz")
    p.add_argument("--seeded-teacher", action="store_true", help="serve a seeded F5-TTS Base tree")
    p.add_argument("--demo-tiny", action="store_true", help="serve the service's demo_tiny model")
    p.add_argument("--transport", default="http", choices=["http", "service"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--work", default=os.path.join(tempfile.gettempdir(), "strict_probe"))
    p.add_argument("--hard-chars", type=int, default=420)
    p.add_argument("--easy-chars", type=int, default=40)
    p.add_argument("--out", default=None, help="JSON result file (default: stdout only)")
    args = p.parse_args(argv)
    resolve_device(args.device)
    settings = {**write_assets(args.work, args.seeded_teacher and not args.demo_tiny),
                "warmup": False, "speech_rate_limit": "1000/minute", "device": args.device}
    if args.demo_tiny:
        settings["demo_tiny"] = True
    elif not args.seeded_teacher:
        settings["tts_ckpt"] = args.teacher
    out = run(args.transport, settings, args.work, easy_chars=args.easy_chars, hard_chars=args.hard_chars)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
