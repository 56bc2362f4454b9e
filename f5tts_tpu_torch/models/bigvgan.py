"""BigVGAN-class GAN vocoder, the optional second vocoder (counterpart of
``f5tts_tpu/models/bigvgan.py``).

The generator topology of ``nvidia/bigvgan_v2_24khz_100band_256x``: conv_pre
k=7 -> 6 transposed-conv upsample stages (rates 4,4,2,2,2,2, channels
1536 -> 24), each followed by the mean of 3 AMP resblocks (kernel sizes
3/7/11, dilations 1/3/5) with snake-beta activations
(``x + (1/(b+eps)) sin^2(a x)``, log-scale alpha/beta), conv_post k=7, tanh.

Every snake is anti-aliased (``Activation1d``): replicate-pad -> 2x
transposed conv with a 12-tap Kaiser-windowed sinc -> snake at the doubled
rate -> replicate-pad -> stride-2 low-pass. The JAX package writes the
fixed filter as polyphase shifted-slice sums for XLA; here it is a depthwise
``F.conv_transpose1d`` / ``F.conv1d`` (the same sums, up to fp32 rounding).

The decoder runs channel-first ``(b, c, n)`` so every convolution is one
cuDNN call. ``models/convert.py:bigvgan_params_from_numpy`` lays the JAX
params tree out for it once: conv kernels ``(k, in, out)`` -> ``(out, in, k)``,
and the transposed-conv kernels, which the JAX tree holds ``(k, in, out)``
and flipped along time (``lax.conv_transpose`` correlates where torch
convolves), unflipped to torch's ``(in, out, k)``. There is no TPU kernel on
this path: the JAX decoder is XLA.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class BigVGANConfig:
    mel_dim: int = 100
    upsample_initial_channel: int = 1536
    upsample_rates: tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    anti_aliased: bool = True

    @staticmethod
    def demo_tiny() -> "BigVGANConfig":
        """The ``--demo-tiny`` geometry of the JAX CLI and server (20 mels, 32 channels)."""
        return BigVGANConfig(mel_dim=20, upsample_initial_channel=32, upsample_rates=(4, 4, 4, 4),
                             upsample_kernel_sizes=(8, 8, 8, 8), resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),))


_AA_RATIO = 2
_AA_TAPS = 12  # int(6 * ratio // 2) * 2


def _kaiser_sinc_filter(cutoff: float, half_width: float, taps: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, normalized to unit DC gain."""
    half_size = taps // 2
    delta_f = 4.0 * half_width
    attenuation = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if attenuation > 50.0:
        beta = 0.1102 * (attenuation - 8.7)
    elif attenuation >= 21.0:
        beta = 0.5842 * (attenuation - 21.0) ** 0.4 + 0.07886 * (attenuation - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(taps, beta)
    time = np.arange(taps) - half_size + (0.5 if taps % 2 == 0 else 0.0)
    f = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    return (f / f.sum()).astype(np.float32)


_AA_FILTER = _kaiser_sinc_filter(0.5 / _AA_RATIO, 0.6 / _AA_RATIO, _AA_TAPS)


@functools.lru_cache(maxsize=64)
def _aa_filter(channels: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """The low-pass as a depthwise kernel ``(channels, 1, 12)``."""
    f = torch.as_tensor(_AA_FILTER, device=device).to(dtype)
    return f.view(1, 1, -1).expand(channels, 1, -1).contiguous()


def _snake_beta(x, alpha_log, beta_log):
    """``x (b, c, n)``; ``alpha_log``, ``beta_log (c,)``."""
    a = torch.exp(alpha_log.to(x.dtype))[None, :, None]
    b = torch.exp(beta_log.to(x.dtype))[None, :, None]
    return x + (1.0 / (b + 1e-9)) * torch.square(torch.sin(a * x))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """``(b, c, n) -> (b, c, 2n)``: replicate-pad 5, transposed conv (stride 2,
    gain 2), crop 15 from each end."""
    c = x.shape[1]
    f = _aa_filter(c, x.dtype, str(x.device))
    y = F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), f, stride=2, groups=c)
    return 2.0 * y[..., 15:-15]


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """``(b, c, 2n) -> (b, c, n)``: replicate-pad 5/6, stride-2 low-pass."""
    c = x.shape[1]
    return F.conv1d(F.pad(x, (5, 6), mode="replicate"), _aa_filter(c, x.dtype, str(x.device)), stride=2, groups=c)


def _act(x, alpha_log, beta_log, anti_aliased: bool):
    if not anti_aliased:
        return _snake_beta(x, alpha_log, beta_log)
    return _downsample2(_snake_beta(_upsample2(x), alpha_log, beta_log))


def _conv(p, x, padding: int = 0, dilation: int = 1):
    return F.conv1d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), padding=padding, dilation=dilation)


def _amp_block(p, x, k: int, dilations, anti_aliased: bool):
    for i, dil in enumerate(dilations):
        h = _act(x, p["alpha1"][i], p["beta1"][i], anti_aliased)
        h = _conv(p["convs1"][i], h, padding=(k - 1) * dil // 2, dilation=dil)
        h = _act(h, p["alpha2"][i], p["beta2"][i], anti_aliased)
        x = x + _conv(p["convs2"][i], h, padding=(k - 1) // 2)
    return x


def bigvgan_decode(params, mel: torch.Tensor, cfg: BigVGANConfig = BigVGANConfig(),
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Log-mel ``(b, n, mel_dim)`` -> waveform ``(b, n * prod(rates))`` in
    ``compute_dtype``; ``params`` in the port's layout
    (``bigvgan_params_from_numpy``)."""
    x = _conv(params["conv_pre"], mel.to(compute_dtype).transpose(1, 2), padding=3)
    for i, (r, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        up = params["ups"][i]
        x = F.conv_transpose1d(x, up["w"].to(x.dtype), up["b"].to(x.dtype), stride=r, padding=(k - r) // 2)
        acc = None
        for j, rk in enumerate(cfg.resblock_kernel_sizes):
            y = _amp_block(params["resblocks"][i][j], x, rk, cfg.resblock_dilations[j], cfg.anti_aliased)
            acc = y if acc is None else acc + y
        x = acc / len(cfg.resblock_kernel_sizes)
    x = _act(x, params["alpha_post"], params["beta_post"], cfg.anti_aliased)
    x = _conv(params["conv_post"], x, padding=3)
    return torch.clamp(torch.tanh(x[:, 0]), -1.0, 1.0)
