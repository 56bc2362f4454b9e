"""Rotary position embeddings and the absolute sin/cos text-position table
(counterpart of ``f5tts_tpu/ops/rope.py``).

Parity quirk kept from the reference: RoPE on the *flat* ``(b, n, h*d)``
projection with a ``d``-wide table rotates only head 0 (``apply_rotary``);
``apply_rotary_per_head`` is the conventional all-heads rotation. cos/sin are
cast to the tensor's dtype before rotating, as the JAX code does.
"""

from __future__ import annotations

import numpy as np
import torch


def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0, theta_rescale_factor: float = 1.0) -> np.ndarray:
    """``(end, dim)`` table: ``cat([cos(t f), sin(t f)], -1)`` with NTK rescaling."""
    theta = theta * theta_rescale_factor ** (dim / (dim - 2))
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    t = np.arange(end, dtype=np.float64)
    angles = np.outer(t, freqs)
    return np.concatenate([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def get_pos_embed_indices(start: torch.Tensor, length: int, max_pos: int, scale: float = 1.0) -> torch.Tensor:
    """Per-row position indices ``start[:, None] + floor(arange(length) * scale)``,
    clamped to ``max_pos - 1`` (int32)."""
    steps = (torch.arange(length, dtype=torch.float32, device=start.device)[None, :] * scale).to(torch.int32)
    return torch.clamp_max(start.to(torch.int32)[:, None] + steps, max_pos - 1)


def rotary_freqs(seq_len: int, dim_head: int, theta: float = 10000.0) -> np.ndarray:
    """x-transformers convention: ``(seq_len, dim_head)`` = ``cat([f, f], -1)``
    with ``f[t, j] = t / theta**(2j/dim_head)`` (half-split layout)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim_head, 2).astype(np.float64) / dim_head))
    f = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    return np.concatenate([f, f], axis=-1).astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(t: torch.Tensor, freqs: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Rotate the first ``freqs.shape[-1]`` channels of ``t`` (``(..., n, d)``);
    the remaining channels pass through (partial-rotary semantics)."""
    rot_dim = freqs.shape[-1]
    freqs = freqs[-t.shape[-2]:]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    cos = torch.cos(freqs).to(t.dtype)
    sin = torch.sin(freqs).to(t.dtype)
    t_rot = t_rot * cos * scale + rotate_half(t_rot) * sin * scale
    return torch.cat([t_rot, t_pass], dim=-1)


def apply_rotary_per_head(q_or_k: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Conventional rotation of every head: ``(b, h, n, dim_head)`` input."""
    cos = torch.cos(freqs).to(q_or_k.dtype)
    sin = torch.sin(freqs).to(q_or_k.dtype)
    return q_or_k * cos + rotate_half(q_or_k) * sin
