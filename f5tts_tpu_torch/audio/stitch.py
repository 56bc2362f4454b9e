"""Crossfade stitching of per-chunk waveforms (numpy; the linear crossfade
of ``f5tts_tpu/audio/stitch.py`` and its native ``crossfade_pair``)."""

from __future__ import annotations

import numpy as np


def crossfade_pair(a: np.ndarray, b: np.ndarray, n_fade: int) -> np.ndarray:
    """``[a[:-f]; a[-f:]*fade_out + b[:f]*fade_in; b[f:]]`` with linear fades."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    n_fade = int(min(n_fade, len(a), len(b)))
    if n_fade <= 0:
        return np.concatenate([a, b])
    fade_out = np.linspace(1.0, 0.0, n_fade, dtype=np.float32)
    fade_in = np.linspace(0.0, 1.0, n_fade, dtype=np.float32)
    overlap = a[-n_fade:] * fade_out + b[:n_fade] * fade_in
    return np.concatenate([a[:-n_fade], overlap, b[n_fade:]])


def crossfade_concat(waves: list[np.ndarray], cross_fade_duration: float = 0.15, sample_rate: int = 24000) -> np.ndarray:
    if not waves:
        return np.zeros(0, dtype=np.float32)
    if cross_fade_duration <= 0:
        return np.concatenate(waves)
    final = np.asarray(waves[0], np.float32)
    n = int(cross_fade_duration * sample_rate)
    for nxt in waves[1:]:
        final = crossfade_pair(final, nxt, n)
    return final
