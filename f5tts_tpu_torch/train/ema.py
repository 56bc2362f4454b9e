"""Exponential moving average of params (counterpart of
``f5tts_tpu/train/ema.py``): ema-pytorch's warmup-aware decay, beta 0.9999,
update after step 100, every 10 steps. The decay is computed in fp32 as the
JAX package computes it; the EMA tree is updated in place."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from f5tts_tpu_torch.train.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class EMAConfig:
    beta: float = 0.9999
    update_after_step: int = 100
    update_every: int = 10
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def ema_init(params):
    """A detached copy of the params tree."""
    return tree_map(lambda t: t.detach().clone(), params)


def ema_decay(step: int, cfg: EMAConfig = EMAConfig()) -> np.float32:
    """Warmup-aware decay (ema-pytorch's ``get_current_decay``) in fp32."""
    epoch = max(step - cfg.update_after_step - 1, 0)
    if epoch <= 0:
        return np.float32(0.0)
    value = np.float32(1.0) - (np.float32(1.0) + np.float32(epoch) / np.float32(cfg.inv_gamma)) ** np.float32(-cfg.power)
    return np.clip(value, np.float32(0.0), np.float32(cfg.beta))


@torch.no_grad()
def ema_update(ema, params, step: int, cfg: EMAConfig = EMAConfig()) -> None:
    """``ema = ema * decay + params * (1 - decay)`` in place, on steps that are
    a multiple of ``update_every``."""
    if step % cfg.update_every != 0:
        return
    decay = ema_decay(step, cfg)
    one_minus = float(np.float32(1.0) - decay)
    for (_, e), (_, p) in zip(tree_leaves(ema), tree_leaves(params)):
        e.mul_(float(decay)).add_(p.detach().to(e.dtype) * one_minus)
