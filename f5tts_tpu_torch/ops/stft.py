"""Inverse STFT for the Vocos head (counterpart of ``f5tts_tpu/ops/stft.py``).

``torch.istft(center=True)`` semantics: per-frame inverse real DFT (two
matmuls against a precomputed basis, as the JAX code does), synthesis window,
overlap-add as ``n_fft/hop`` shifted adds, division by the squared-window
envelope, ``n_fft//2`` trim at both ends.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from f5tts_tpu_torch.ops.mel import hann_window


def _fold_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``(b, T, n_fft)`` -> ``(b, (T-1)*hop + n_fft)`` (hop | n_fft)."""
    b, T, n_fft = frames.shape
    total = frames.new_zeros((b, (T - 1) * hop + n_fft))
    for r in range(n_fft // hop):
        # slice r of every frame lands at offset r*hop in a contiguous T*hop run
        total[:, r * hop : r * hop + T * hop] += frames[:, :, r * hop : (r + 1) * hop].reshape(b, T * hop)
    return total


@functools.lru_cache(maxsize=8)
def _window_envelope(T: int, n_fft: int, hop: int, win_length: int) -> np.ndarray:
    w = hann_window(win_length).astype(np.float64)
    env = np.zeros((T - 1) * hop + n_fft)
    for t in range(T):
        env[t * hop : t * hop + n_fft] += w * w
    return env.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _irdft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Bases ``(n_freq, n_fft)`` with ``irfft(S) = Re(S) @ C + Im(S) @ D``."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((n_freq, 1), 2.0)  # DC and Nyquist count once, the others twice
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    return (np.cos(ang) * w / n_fft).astype(np.float32), (-np.sin(ang) * w / n_fft).astype(np.float32)


def istft_reim(
    re: torch.Tensor,  # (b, T, n_freq)
    im: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    center: bool = True,
) -> torch.Tensor:
    """iSTFT from separate real/imag parts -> ``(b, (T-1)*hop)`` for ``center=True``."""
    if n_fft % hop_length:
        raise ValueError("overlap-add needs hop | n_fft")
    T = re.shape[1]
    dev = re.device
    c, d = _irdft_basis(n_fft)
    frames = re.float() @ torch.as_tensor(c, device=dev) + im.float() @ torch.as_tensor(d, device=dev)
    frames = frames * torch.as_tensor(hann_window(win_length), device=dev)
    y = _fold_add(frames, hop_length)
    env = torch.as_tensor(_window_envelope(T, n_fft, hop_length, win_length), device=dev)
    y = y / torch.clamp(env, min=1e-11)
    if center:
        pad = n_fft // 2
        y = y[:, pad:-pad]
    return y
