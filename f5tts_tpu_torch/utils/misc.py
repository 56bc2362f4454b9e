"""Host utilities (counterpart of ``f5tts_tpu/utils/misc.py``): a local
reference-voice loader, the time as words, and the device description."""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch


def load_audio(source: str) -> tuple[np.ndarray, int]:
    """Reference-voice loader for local paths (or ``file://`` URLs): remote
    URLs are refused (no network access), and callers cache."""
    from f5tts_tpu_torch.audio.io import read_wav

    if source.startswith("file://"):
        source = source[len("file://") :]
    if source.startswith(("http://", "https://")):
        raise ValueError("remote voice URLs are not supported in this zero-egress build; use a local path")
    if not os.path.exists(source):
        raise FileNotFoundError(source)
    return read_wav(source)


_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine", "ten",
         "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty"]


def _number_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("" if ones == 0 else " " + _ONES[ones])


def time_to_words(now: datetime.datetime | None = None) -> str:
    """The time in IST as words: 'HH o'clock' on the hour, else 'HH MM'."""
    ist = datetime.timezone(datetime.timedelta(hours=5, minutes=30))
    now = now.astimezone(ist) if now else datetime.datetime.now(ist)
    hour = now.hour % 12 or 12
    if now.minute == 0:
        return f"{_number_words(hour)} o'clock"
    return f"{_number_words(hour)} {_number_words(now.minute)}"


def describe_device(device: str | torch.device | None = None) -> dict:
    """The device the port runs on: the CUDA card (``None`` or ``"cuda"``;
    raises with no GPU, as ``resolve_device`` does) or the CPU on request."""
    from f5tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "devices": torch.cuda.device_count(), "kind": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "devices": 1, "kind": "cpu"}
