"""Log-mel spectrogram front end (counterpart of ``f5tts_tpu/ops/mel.py``).

Two flavors, frame-major ``(b, frames, n_mels)`` output:

- ``vocos``: reflect-padded centered STFT, magnitude, HTK filterbank without
  norm, ``log(clamp(mel, 1e-5))``.
- ``bigvgan``: reflect pad ``(n_fft - hop)//2``, uncentered STFT, magnitude
  ``sqrt(re^2 + im^2 + 1e-9)``, Slaney filterbank with Slaney norm.

The STFT is framing + ``torch.fft.rfft`` (the JAX code also uses the library
FFT); the filterbank is host-side numpy.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from f5tts_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 24_000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 100
    fmin: float = 0.0
    fmax: float | None = None  # None -> sr / 2
    flavor: str = "vocos"  # "vocos" (HTK/torchaudio) | "bigvgan" (Slaney/librosa)

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_length


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window(periodic=True)``)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    scale: str = "htk",
    norm: str | None = None,
) -> np.ndarray:
    """Triangular mel filterbank ``(n_freqs, n_mels)`` float32: ``htk``/no norm
    (torchaudio default) or ``slaney``/``slaney`` (librosa default)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    if scale == "htk":
        to_mel, to_hz = _hz_to_mel_htk, _mel_to_hz_htk
    elif scale == "slaney":
        to_mel, to_hz = _hz_to_mel_slaney, _mel_to_hz_slaney
    else:
        raise ValueError(f"unknown mel scale {scale!r}")
    f_pts = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[np.newaxis, :] - all_freqs[:, np.newaxis]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels]))[np.newaxis, :]
    elif norm is not None:
        raise ValueError(f"unknown filterbank norm {norm!r}")
    return fb.astype(np.float32)


def frame_signal(wav: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """``(..., samples)`` -> overlapping frames ``(..., n_frames, frame_length)``."""
    return wav.unfold(-1, frame_length, hop)


def stft_magnitude(wav: torch.Tensor, n_fft: int, hop_length: int, win_length: int, center: bool,
                   magnitude_eps: float = 0.0) -> torch.Tensor:
    """|STFT| of ``(b, samples)`` -> ``(b, n_frames, n_fft//2 + 1)``."""
    window = torch.as_tensor(hann_window(win_length), device=wav.device, dtype=wav.dtype)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(window, (lpad, n_fft - win_length - lpad))
    if center:
        pad = n_fft // 2
        wav = torch.nn.functional.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame_signal(wav, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames.float(), dim=-1)
    power = spec.real**2 + spec.imag**2
    if magnitude_eps:
        return torch.sqrt(power + magnitude_eps)
    return torch.sqrt(torch.clamp(power, min=0.0))


def log_mel_spectrogram(wav: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Waveform ``(b, samples)`` -> log-mel ``(b, n_frames, n_mels)``."""
    if wav.ndim == 1:
        wav = wav[None]
    if cfg.flavor == "vocos":
        mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, cfg.win_length, center=True)
        fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, scale="htk", norm=None)
    elif cfg.flavor == "bigvgan":
        pad = (cfg.n_fft - cfg.hop_length) // 2
        wav = torch.nn.functional.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, cfg.win_length, center=False, magnitude_eps=1e-9)
        fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, scale="slaney", norm="slaney")
    else:
        raise ValueError(f"unknown mel flavor {cfg.flavor!r}")
    mel = mag @ torch.as_tensor(fb, device=mag.device)
    return torch.log(torch.clamp(mel, min=1e-5))


def bucketed_log_mel(wav: np.ndarray, cfg: MelConfig = MelConfig(), bucket: int = 32_768,
                     device: str | torch.device | None = None) -> np.ndarray:
    """Host API: log-mel of ONE waveform ``(samples,)`` -> ``(frames, n_mels)``.

    Zero-pads the samples to a ``bucket`` multiple before the transform and
    slices back to ``samples // hop`` frames, exactly as the JAX front end
    does (the padding changes the last frames' reflect context, so it is part
    of the contract)."""
    dev = resolve_device(device)
    n = len(wav)
    padded = -(-max(n, 1) // bucket) * bucket
    frames = n // cfg.hop_length
    wav = np.pad(np.asarray(wav, np.float32), (0, padded - n))
    mel = log_mel_spectrogram(torch.as_tensor(wav[None], device=dev), cfg)[0]
    return mel[:frames].cpu().numpy()
