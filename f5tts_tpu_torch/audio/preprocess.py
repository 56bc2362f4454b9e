"""Reference-audio preprocessing: silence clipping, edge trim, RMS norm,
resample, and the removal of long silences from a generated wave (the parts
of ``f5tts_tpu/audio/preprocess.py`` the engine and CLI use, copied so the
port imports nothing of the JAX package).

Numpy re-implementation of the reference's pydub-based pipeline
(``infer/utils_infer.py:263-351``): split on silence with two threshold stages
to clip the reference to <= 15 s, trim edge silence, append 50 ms of silence,
then (at synthesis time, ``utils_infer.py:423-433``) mono-downmix, RMS-normalize
quiet refs up to 0.1, and resample to 24 kHz.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

TARGET_RMS = 0.1
TARGET_SR = 24_000


def rms_dbfs(x: np.ndarray) -> float:
    """pydub-style dBFS for float audio in [-1, 1] (max-possible-amp ref = 1)."""
    rms = float(np.sqrt(np.mean(np.square(x)))) if x.size else 0.0
    if rms <= 0:
        return -np.inf
    return 20.0 * np.log10(rms)


def _ms_len(audio: np.ndarray, sr: int) -> int:
    """pydub ``len(seg)``: milliseconds, rounded."""
    return round(1000 * len(audio) / sr)


def _ms_idx(ms: float, sr: int) -> int:
    """pydub position parsing: sample index of a millisecond offset."""
    return int(ms * (sr / 1000.0))


def _ms_slice(audio: np.ndarray, sr: int, a_ms: float, b_ms: float) -> np.ndarray:
    return audio[_ms_idx(a_ms, sr) : _ms_idx(b_ms, sr)]


def detect_silence(audio: np.ndarray, sr: int, min_silence_ms: int = 1000,
                   thresh_db: float = -16.0, seek_ms: int = 1) -> list[list[int]]:
    """Silent ``[start_ms, end_ms]`` ranges, pydub ``silence.detect_silence``
    semantics (the reference's clipping substrate, ``utils_infer.py:289-316``):
    a window of ``min_silence_ms`` is silent when its AGGREGATE rms is at or
    below the threshold amplitude; overlapping/nearby silent windows merge.
    Vectorized over a sample-squared cumsum instead of pydub's per-window
    slices. Deliberate float-domain divergence: pydub computes rms on int16
    samples with int() truncation, so windows within ~1 LSB of the threshold
    can classify differently and shift clip boundaries by a few ms (the
    pipeline goldens tolerate <=2 ms of drift); this float pipeline does not
    round-trip through int16."""
    seg_ms = _ms_len(audio, sr)
    if seg_ms < min_silence_ms:
        return []
    last_start = seg_ms - min_silence_ms
    starts = np.arange(0, last_start + 1, seek_ms)
    if last_start % seek_ms:
        starts = np.concatenate([starts, [last_start]])
    csum = np.concatenate([[0.0], np.cumsum(np.square(audio, dtype=np.float64))])
    a = (starts * (sr / 1000.0)).astype(np.int64)
    b = ((starts + min_silence_ms) * (sr / 1000.0)).astype(np.int64)
    b = np.minimum(b, len(audio))
    n = np.maximum(b - a, 1)
    rms = np.sqrt((csum[b] - csum[a]) / n)
    thresh_amp = 10.0 ** (thresh_db / 20.0)
    silence_starts = starts[rms <= thresh_amp].tolist()
    if not silence_starts:
        return []
    # merge: continuous windows extend a range; a gap shorter than the window
    # stays merged (pydub's exact rule)
    ranges: list[list[int]] = []
    prev = cur_start = silence_starts[0]
    for s in silence_starts[1:]:
        continuous = s == prev + seek_ms
        has_gap = s > prev + min_silence_ms
        if not continuous and has_gap:
            ranges.append([cur_start, prev + min_silence_ms])
            cur_start = s
        prev = s
    ranges.append([cur_start, prev + min_silence_ms])
    return ranges


def detect_nonsilent(audio: np.ndarray, sr: int, min_silence_ms: int = 1000,
                     thresh_db: float = -16.0, seek_ms: int = 1) -> list[list[int]]:
    """Non-silent ``[start_ms, end_ms]`` ranges (complement of detect_silence)."""
    silent = detect_silence(audio, sr, min_silence_ms, thresh_db, seek_ms)
    seg_ms = _ms_len(audio, sr)
    if not silent:
        return [[0, seg_ms]]
    if silent[0] == [0, seg_ms]:
        return []
    prev_end = 0
    out = []
    for s, e in silent:
        out.append([prev_end, s])
        prev_end = e
    if prev_end != seg_ms:
        out.append([prev_end, seg_ms])
    if out and out[0] == [0, 0]:
        out.pop(0)
    return out


def split_on_silence(audio: np.ndarray, sr: int, min_silence_ms: int, thresh_db: float,
                     keep_silence_ms: int, seek_ms: int = 1) -> list[np.ndarray]:
    """pydub ``silence.split_on_silence``: non-silent chunks padded by
    ``keep_silence_ms``; overlapping pads meet at the midpoint."""
    ranges = [
        [s - keep_silence_ms, e + keep_silence_ms]
        for s, e in detect_nonsilent(audio, sr, min_silence_ms, thresh_db, seek_ms)
    ]
    for r1, r2 in zip(ranges, ranges[1:]):
        if r2[0] < r1[1]:
            r1[1] = (r1[1] + r2[0]) // 2
            r2[0] = r1[1]
    seg_ms = _ms_len(audio, sr)
    return [_ms_slice(audio, sr, max(s, 0), min(e, seg_ms)) for s, e in ranges]


def detect_leading_silence(audio: np.ndarray, sr: int, thresh_db: float = -50.0,
                           chunk_ms: int = 10) -> int:
    """Leading silence in ms (pydub: 10 ms chunks whose dBFS < threshold)."""
    seg_ms = _ms_len(audio, sr)
    trim = 0
    while trim < seg_ms and rms_dbfs(_ms_slice(audio, sr, trim, trim + chunk_ms)) < thresh_db:
        trim += chunk_ms
    return min(trim, seg_ms)


def remove_silence_edges(audio: np.ndarray, sr: int, thresh_db: float = -42.0) -> np.ndarray:
    """Trim leading/trailing silence (``utils_infer.py:263-276``): leading via
    detect_leading_silence, trailing via per-1 ms dBFS walk from the end."""
    audio = audio[_ms_idx(detect_leading_silence(audio, sr, thresh_db), sr):]
    dur_s = len(audio) / sr  # pydub duration_seconds (exact, not ms-rounded)
    for ms in range(_ms_len(audio, sr) - 1, -1, -1):
        if rms_dbfs(_ms_slice(audio, sr, ms, ms + 1)) > thresh_db:
            break
        dur_s -= 0.001
    return audio[: _ms_idx(int(dur_s * 1000), sr)]


def clip_ref_audio(audio: np.ndarray, sr: int, max_ms: int = 15000) -> np.ndarray:
    """Two-stage silence-aware clip to <= 15 s + edge trim + 50 ms pad
    (``utils_infer.py:287-318``), pydub-ms-faithful."""

    def assemble(segs):
        out = np.zeros(0, dtype=audio.dtype)
        for seg in segs:
            if _ms_len(out, sr) > 6000 and _ms_len(np.concatenate([out, seg]), sr) > max_ms:
                break
            out = np.concatenate([out, seg])
        return out

    clipped = assemble(split_on_silence(audio, sr, 1000, -50.0, 1000, seek_ms=10))
    if _ms_len(clipped, sr) > max_ms:
        clipped = assemble(split_on_silence(audio, sr, 100, -40.0, 1000, seek_ms=10))
    if _ms_len(clipped, sr) > max_ms:
        clipped = _ms_slice(clipped, sr, 0, max_ms)
    if len(clipped) == 0:  # guard beyond the reference: an all-silent ref stays usable
        clipped = _ms_slice(audio, sr, 0, max_ms)
    clipped = remove_silence_edges(clipped, sr)
    return np.concatenate([clipped, np.zeros(_ms_idx(50, sr), dtype=audio.dtype)])


def remove_long_silences(audio: np.ndarray, sr: int, min_silence_ms: int = 1000,
                         thresh_db: float = -50.0, keep_silence_ms: int = 500) -> np.ndarray:
    """Collapse long internal silences of a generated wave (``utils_infer.py:530-539``:
    split on silence, concatenate the pieces)."""
    segs = split_on_silence(audio, sr, min_silence_ms, thresh_db, keep_silence_ms, seek_ms=10)
    if not segs:
        return audio[:0]
    return np.concatenate(segs)


def resample(audio: np.ndarray, sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    if sr == target_sr:
        return audio
    g = np.gcd(sr, target_sr)
    return resample_poly(audio, target_sr // g, sr // g).astype(np.float32)


def normalize_rms(audio: np.ndarray, target_rms: float = TARGET_RMS) -> tuple[np.ndarray, float]:
    """Boost quiet refs to target RMS; returns (audio, original rms).

    The gain is undone on the generated wave when the ref was quiet
    (``utils_infer.py:427-429,475-476``).
    """
    rms = float(np.sqrt(np.mean(np.square(audio)))) if audio.size else 0.0
    if 0 < rms < target_rms:
        audio = audio * (target_rms / rms)
    return audio.astype(np.float32), rms


def ensure_sentence_punctuation(text: str) -> str:
    """``utils_infer.py:343-347``."""
    if not text.endswith(". ") and not text.endswith("。"):
        if text.endswith("."):
            text += " "
        else:
            text += ". "
    return text
