"""Length/span mask helpers (counterpart of ``f5tts_tpu/ops/masks.py``)."""

from __future__ import annotations

import torch


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    """``(b,) -> (b, length)`` bool, True where position < lens."""
    return torch.arange(length, device=lens.device)[None, :] < lens[:, None]


def mask_from_start_end_indices(length: int, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    seq = torch.arange(length, device=start.device)
    return (seq[None, :] >= start[:, None]) & (seq[None, :] < end[:, None])
