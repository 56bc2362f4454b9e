"""Plain multi-head attention (counterpart of ``f5tts_tpu/ops/attention.py``).

Bidirectional attention where the padding mask masks *keys only*; padded
query rows produce values the caller zeroes. Logits and softmax in fp32,
probabilities cast to ``v.dtype`` before the PV product.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-finite instead of -inf: keeps fully-masked rows NaN-free


def sdpa(
    q: torch.Tensor,  # (b, h, n, d)
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,  # (b, n) bool, True = valid key
) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :], logits, torch.tensor(NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
