"""Crossfade stitching of per-chunk waveforms (counterpart of
``f5tts_tpu/audio/stitch.py``): each pair through the native
``crossfade_pair`` (``audio/native.py``)."""

from __future__ import annotations

import numpy as np

from f5tts_tpu_torch.audio.native import crossfade_pair


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
