"""STFT and inverse STFT (counterpart of ``f5tts_tpu/ops/stft.py``).

``istft_reim`` is the Vocos head's: ``torch.istft(center=True)`` semantics,
per-frame inverse real DFT (two matmuls against a precomputed basis, as the
JAX code does), synthesis window, overlap-add as ``n_fft/hop`` shifted adds,
division by the squared-window envelope, ``n_fft//2`` trim at both ends.
``istft`` takes a complex spectrum (the same matmuls, or ``irfft``);
``stft_complex`` is the analysis side (reflect pad, Hann window, ``rfft``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from f5tts_tpu_torch.ops.mel import frame_signal, hann_window


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


def stft_complex(
    wav: torch.Tensor,  # (b, samples)
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    center: bool = True,
) -> torch.Tensor:
    """Complex STFT ``(b, frames, n_fft//2 + 1)``, frame-major (complex64)."""
    window = torch.as_tensor(hann_window(win_length), device=wav.device, dtype=wav.dtype)
    if center:
        pad = n_fft // 2
        wav = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (pad, pad), mode="reflect").reshape(*wav.shape[:-1], -1)
    return torch.fft.rfft((frame_signal(wav, n_fft, hop_length) * window).float(), dim=-1)


def _overlap_add(frames: torch.Tensor, hop_length: int, win_length: int, center: bool) -> torch.Tensor:
    """Windowed ``(b, T, n_fft)`` frames -> the normalized, trimmed wave."""
    T, n_fft = frames.shape[1:]
    dev = frames.device
    frames = frames * torch.as_tensor(hann_window(win_length), device=dev)
    y = _fold_add(frames, hop_length)
    env = torch.as_tensor(_window_envelope(T, n_fft, hop_length, win_length), device=dev)
    y = y / torch.clamp(env, min=1e-11)
    if center:
        pad = n_fft // 2
        y = y[:, pad:-pad]
    return y


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
    dev = re.device
    c, d = _irdft_basis(n_fft)
    frames = re.float() @ torch.as_tensor(c, device=dev) + im.float() @ torch.as_tensor(d, device=dev)
    return _overlap_add(frames, hop_length, win_length, center)


def istft(
    spec: torch.Tensor,  # complex (b, T, n_fft//2 + 1), frame-major
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    center: bool = True,
    use_matmul_idft: bool = True,
) -> torch.Tensor:
    """iSTFT of a complex spectrum -> ``(b, (T-1)*hop)`` for ``center=True``:
    ``istft_reim`` of its parts, or with ``use_matmul_idft=False`` an
    ``irfft`` per frame."""
    if use_matmul_idft:
        return istft_reim(spec.real, spec.imag, n_fft, hop_length, win_length, center)
    if n_fft % hop_length:
        raise ValueError("overlap-add needs hop | n_fft")
    return _overlap_add(torch.fft.irfft(spec, n=n_fft, dim=-1).float(), hop_length, win_length, center)
