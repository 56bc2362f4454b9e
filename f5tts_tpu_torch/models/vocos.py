"""Vocos vocoder: ConvNeXt backbone + iSTFT head (counterpart of
``f5tts_tpu/models/vocos.py``).

Conv1d(k=7) embed -> LayerNorm -> N ConvNeXt-v1 blocks (depthwise k=7, LN,
pw 512->1536, exact GELU, pw 1536->512, layer-scale gamma) -> final LN ->
Linear(dim -> n_fft + 2) split into log-magnitude and phase ->
``exp(clip(mag)) * exp(i phase)`` -> iSTFT. Frame-major ``(b, n, mel)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.models.dit import block, stack_depth
from f5tts_tpu_torch.ops.stft import istft_reim


@dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    mag_clip: float = 1e2

    @property
    def head_out(self) -> int:
        return self.n_fft + 2


def _convnext_v1_block(p, x):
    h = m.conv1d(p["dwconv"], x, groups=x.shape[-1], padding=3)
    h = m.layer_norm(h, 1e-6, p["norm_w"], p["norm_b"])
    h = F.gelu(m.linear(p["pw1"], h))
    h = m.linear(p["pw2"], h)
    return x + p["gamma"].to(h.dtype) * h


def vocos_decode(params, mel: torch.Tensor, cfg: VocosConfig = VocosConfig(),
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Log-mel ``(b, n, mel)`` -> waveform ``(b, (n-1)*hop)`` fp32."""
    x = m.conv1d(params["embed"], mel.to(compute_dtype), padding=3)
    x = m.layer_norm(x, 1e-6, params["norm_w"], params["norm_b"])
    for i in range(stack_depth(params["blocks"])):
        x = _convnext_v1_block(block(params["blocks"], i), x)
    x = m.layer_norm(x, 1e-6, params["final_norm_w"], params["final_norm_b"])
    x = m.linear(params["head"], x).float()
    n_freq = cfg.n_fft // 2 + 1
    mag, phase = x[..., :n_freq], x[..., n_freq:]
    mag = torch.exp(torch.clamp(mag, max=math.log(cfg.mag_clip)))
    return istft_reim(mag * torch.cos(phase), mag * torch.sin(phase), cfg.n_fft, cfg.hop_length, cfg.n_fft, center=True)
