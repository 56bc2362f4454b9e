"""Length/span mask helpers (counterpart of ``f5tts_tpu/ops/masks.py``)."""

from __future__ import annotations

import torch


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    """``(b,) -> (b, length)`` bool, True where position < lens."""
    return torch.arange(length, device=lens.device)[None, :] < lens[:, None]


def mask_from_start_end_indices(length: int, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    seq = torch.arange(length, device=start.device)
    return (seq[None, :] >= start[:, None]) & (seq[None, :] < end[:, None])


def mask_from_frac_lengths(seq_len: torch.Tensor, frac_lengths: torch.Tensor, length: int,
                           rand: torch.Tensor | None = None, generator: torch.Generator | None = None) -> torch.Tensor:
    """Random contiguous span of ``int(frac * seq_len)`` frames per row (the
    training infill mask). ``rand`` is the ``(b,)`` uniform draw of the span
    start; without it one is drawn from ``generator``. The int32 truncations
    are the JAX package's: ``lengths = int(frac * len)``,
    ``start = max(int(max_start * rand), 0)``."""
    lengths = (frac_lengths * seq_len).to(torch.int32)
    max_start = seq_len - lengths
    if rand is None:
        dev = generator.device if generator is not None else frac_lengths.device
        rand = torch.rand(frac_lengths.shape, generator=generator, device=dev)
    start = (max_start * rand.to(frac_lengths.device)).to(torch.int32).clamp_min(0)
    return mask_from_start_end_indices(length, start, start + lengths)
