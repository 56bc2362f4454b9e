"""Optional Whisper ASR hook (parity with ``infer/utils_infer.py:133-169``):
host-side preprocessing used for /v1/transcribe and auto-transcribing reference
audio, with the reference's md5-keyed transcription cache. Requires the
transformers whisper pipeline + weights; raises ImportError when unavailable
(this is a zero-egress build — weights must be local).

Copy of ``f5tts_tpu/serve/asr.py``: host-side, and the port imports nothing of
the JAX package."""

from __future__ import annotations

import hashlib
import os

_asr_pipe = None
_ref_text_cache: dict[str, str] = {}

WHISPER_MODEL = os.environ.get("F5TPU_WHISPER_MODEL", "openai/whisper-large-v3-turbo")


def _pipeline():
    global _asr_pipe
    if _asr_pipe is None:
        # zero-egress guard: only local model dirs are usable; a hub id would
        # hang on download. Require an existing path.
        if not os.path.isdir(WHISPER_MODEL):
            raise ImportError(
                f"ASR needs local whisper weights: set F5TPU_WHISPER_MODEL to a model dir (got {WHISPER_MODEL!r})"
            )
        from transformers import pipeline  # raises if unavailable

        _asr_pipe = pipeline(
            "automatic-speech-recognition",
            model=WHISPER_MODEL,
            device="cpu",
        )
    return _asr_pipe


def transcribe_bytes(audio_bytes: bytes, language: str | None = None) -> str:
    from f5tts_tpu_torch.audio.io import read_wav

    wav, sr = read_wav(audio_bytes)
    key = hashlib.md5(audio_bytes).hexdigest()
    if key in _ref_text_cache:
        return _ref_text_cache[key]
    pipe = _pipeline()
    kwargs = {}
    if getattr(pipe, "type", "").startswith("seq2seq"):  # whisper-style models
        gen = {"task": "transcribe"}
        if language:
            gen["language"] = language
        kwargs = {"generate_kwargs": gen, "return_timestamps": False}
    out = pipe({"array": wav, "sampling_rate": sr}, **kwargs)
    text = out["text"].strip()
    _ref_text_cache[key] = text
    return text
