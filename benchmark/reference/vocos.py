"""Vocos (charactr/vocos-mel-24khz) and its mel front end, from the
vocoder's configuration ``v`` (``input_channels`` mel bands, ``n_fft``,
``hop_length``).

- ``log_mel``: Vocos's mel (24 kHz, Hann window of ``n_fft``, HTK bands
  without norm, ``log(clamp(mel, 1e-5))``) through ``torch.stft``; F5-TTS's
  engine zero-pads the samples to a multiple of 32768 first and keeps
  ``samples // hop`` frames.
- ``decode``: Conv1d(k=7) embed, LayerNorm, ConvNeXt-V1 blocks with layer
  scale, LayerNorm, Linear to log-magnitude and phase, ``torch.istft``:
  ``(n - 1) * hop`` samples from ``n`` frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import layers as L

SR = 24000


def samples(v, frames: int) -> int:
    """Samples the decoder gives for ``frames`` mel frames."""
    return max((frames - 1) * v["hop_length"], 0)


def htk_filterbank(n_fft: int, n_mels: int, sr: int = SR):
    """torchaudio's ``melscale_fbanks`` (HTK scale, no norm): ``(n_freqs, n_mels)``."""
    freqs = np.linspace(0.0, sr / 2, n_fft // 2 + 1)
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    pts = 700.0 * (10.0 ** (np.linspace(mel(0.0), mel(sr / 2), n_mels + 2) / 2595.0) - 1.0)
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / np.diff(pts)[:-1]
    up = slopes[:, 2:] / np.diff(pts)[1:]
    return np.maximum(0.0, np.minimum(down, up))


def log_mel(v, wave: np.ndarray, device) -> torch.Tensor:
    """``(samples,)`` -> ``(samples // hop, n_mels)`` as F5-TTS's engine computes it."""
    n_fft, hop = v["n_fft"], v["hop_length"]
    n = len(wave)
    padded = -(-max(n, 1) // 32768) * 32768
    x = torch.zeros(padded, dtype=torch.float32, device=device)
    x[:n] = torch.as_tensor(wave, dtype=torch.float32, device=device)
    spec = torch.stft(x, n_fft, hop, n_fft, torch.hann_window(n_fft, device=device), center=True,
                      pad_mode="reflect", return_complex=True)
    fb = torch.as_tensor(htk_filterbank(n_fft, v["input_channels"]), dtype=torch.float32, device=device)
    return torch.log(torch.clamp(spec.abs().T @ fb, min=1e-5))[: n // hop]


def decode(v, p, mel):
    """``(b, n, n_mels)`` -> ``(b, (n - 1) * hop)``."""
    n_fft, hop = v["n_fft"], v["hop_length"]
    x = L.conv1d(p["embed"], mel, padding=3)
    x = L.layer_norm(x, 1e-6, p["norm_w"], p["norm_b"])
    for i in range(L.depth_of(p["blocks"])):
        bp = L.block(p["blocks"], i)
        h = L.conv1d(bp["dwconv"], x, groups=x.shape[-1], padding=3)
        h = L.layer_norm(h, 1e-6, bp["norm_w"], bp["norm_b"])
        x = L.rnd(x + bp["gamma"] * L.linear(bp["pw2"], F.gelu(L.linear(bp["pw1"], h))))
    x = L.linear(p["head"], L.layer_norm(x, 1e-6, p["final_norm_w"], p["final_norm_b"]))
    n_freq = n_fft // 2 + 1
    mag = torch.exp(torch.clamp(x[..., :n_freq], max=math.log(1e2)))
    spec = torch.polar(mag, x[..., n_freq:]).transpose(1, 2)
    return torch.istft(spec, n_fft, hop, n_fft, torch.hann_window(n_fft, device=mel.device), center=True)
