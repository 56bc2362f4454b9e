"""WAV read/write on numpy float32 (counterpart of ``f5tts_tpu/audio/io.py``):
int16 (or float32) PCM out, int16/int32/uint8/float in, channel-mean downmix."""

from __future__ import annotations

import io

import numpy as np
from scipy.io import wavfile


def read_wav(path_or_bytes) -> tuple[np.ndarray, int]:
    """Returns (mono float32 in [-1, 1], sample_rate). Accepts a path or bytes."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(bytes(path_or_bytes))
    sr, data = wavfile.read(path_or_bytes)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    return audio, int(sr)


def encode_pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> int16 PCM, clipped and rounded to nearest."""
    return np.rint(np.clip(np.asarray(audio, np.float32), -1.0, 1.0) * np.float32(32767.0)).astype(np.int16)


def _encode(audio: np.ndarray, subtype: str) -> np.ndarray:
    if subtype == "int16":
        return encode_pcm16(audio)
    if subtype == "float32":
        return np.asarray(audio, dtype=np.float32)
    raise ValueError(f"unknown subtype {subtype!r}")


def write_wav(path, audio: np.ndarray, sample_rate: int = 24000, subtype: str = "int16") -> None:
    wavfile.write(path, sample_rate, _encode(audio, subtype))


def wav_bytes(audio: np.ndarray, sample_rate: int = 24000, subtype: str = "int16") -> bytes:
    """A whole WAV file in memory (the speech routes' response body)."""
    buf = io.BytesIO()
    wavfile.write(buf, sample_rate, _encode(audio, subtype))
    return buf.getvalue()
