"""Conditional flow matching: the training loss (counterpart of
``f5tts_tpu/models/cfm.py``).

Training semantics, as in the JAX package:
- ``t ~ U(0, 1)`` per row; ``phi = (1 - t) x0 + t x1``; target flow ``x1 - x0``;
- a random contiguous infill span of ``U(0.7, 1.0)`` of each row's frames; the
  loss is the masked MSE over that span, normalized by
  ``max(span frames * mel_dim, 1)``;
- CFG drops: audio-cond drop with p 0.3; with p 0.2 text and audio both,
  one draw per batch;
- no mask into the forward: training attends over the pad.

The random draws are split from the loss (``cfm_draws`` / ``cfm_loss``), so a
test can feed the JAX package's draws: ``jax.random`` cannot be reproduced in
torch.

Under a mesh (``cfm_loss(mesh=...)``) each data-parallel rank holds its rows
of the global batch (``CFMDraws.rows`` of the global draws) and the backbone
its tensor-parallel shards. The denominator is the global count of selected
frames x channels, all-reduced over ``data``, so the ranks' losses sum to
the one-device loss of the global batch (and their gradients to its
gradient), not to a mean of per-rank means.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch

from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.ops.masks import lens_to_mask, mask_from_frac_lengths


@dataclass(frozen=True)
class CFMConfig:
    model: DiTConfig = field(default_factory=DiTConfig)
    audio_drop_prob: float = 0.3
    cond_drop_prob: float = 0.2
    frac_lengths_mask: tuple[float, float] = (0.7, 1.0)


@dataclass
class CFMDraws:
    """The random inputs of one loss evaluation."""

    frac_lengths: torch.Tensor  # (b,) span fraction of each row
    span_rand: torch.Tensor  # (b,) uniform draw of each span's start
    x0: torch.Tensor  # (b, n, mel_dim) noise, fp32
    t: torch.Tensor  # (b,) flow time
    drop_audio: bool  # audio-cond drop for the batch
    drop_both: bool  # text + audio drop for the batch
    dropout_seed: int  # seeds the per-block dropout masks

    def rows(self, sl: slice) -> "CFMDraws":
        """The draws of the rows ``sl`` of the batch (a data-parallel rank's)."""
        return CFMDraws(self.frac_lengths[sl], self.span_rand[sl], self.x0[sl], self.t[sl], self.drop_audio,
                        self.drop_both, self.dropout_seed)


def cfm_draws(generator: torch.Generator, lens: torch.Tensor, n: int, mel_dim: int,
              cfg: CFMConfig = CFMConfig()) -> CFMDraws:
    """Draw one batch's random inputs from ``generator`` (on the device where
    they are used). The two drop flags and the dropout seed come back to the
    host: one small device-to-host copy per call."""
    dev = generator.device
    b = lens.shape[0]
    lo, hi = cfg.frac_lengths_mask
    frac = torch.rand((b,), generator=generator, device=dev) * (hi - lo) + lo
    span = torch.rand((b,), generator=generator, device=dev)
    x0 = torch.randn((b, n, mel_dim), generator=generator, device=dev)
    t = torch.rand((b,), generator=generator, device=dev)
    scalars = torch.rand((3,), generator=generator, device=dev, dtype=torch.float64).tolist()
    return CFMDraws(frac, span, x0, t, drop_audio=scalars[0] < cfg.audio_drop_prob,
                    drop_both=scalars[1] < cfg.cond_drop_prob, dropout_seed=int(scalars[2] * 2**62))


def cfm_loss(params, cfg: CFMConfig, draws: CFMDraws, mel: torch.Tensor, text: torch.Tensor, lens: torch.Tensor,
             compute_dtype: torch.dtype = torch.float32, forward_fn=None, mesh=None):
    """``(loss, aux)`` of one batch: ``mel (b, n, mel_dim)`` target (x1,
    padded), ``text (b, nt)`` ids (pad -1), ``lens (b,)`` valid frames. The
    forward runs in training mode (differentiable kernels, dropout,
    per-block checkpointing). ``forward_fn`` defaults to the backbone of
    ``cfg.model``'s type (DiT, UNetT or MMDiT). ``mesh``: the batch is this
    rank's rows and ``params`` its shards (see the module docstring); the
    loss is this rank's share of the global loss, and ``aux`` is global."""
    if forward_fn is None:
        from f5tts_tpu_torch.models import backbone_fns

        forward_fn = backbone_fns(cfg.model)[1]
    b, n, _ = mel.shape
    data = mesh["data"] if mesh is not None else None
    if mesh is not None:
        rows = (data.index * b, data.size * b) if data.size > 1 else None
        forward_fn = functools.partial(forward_fn, tp=mesh["model"], batch_rows=rows)
    dev = mel.device
    mask = lens_to_mask(lens, n)
    span = mask_from_frac_lengths(lens, draws.frac_lengths.to(dev), n, rand=draws.span_rand.to(dev)) & mask

    x1 = mel.to(compute_dtype)
    x0 = draws.x0.to(dev, compute_dtype)
    t = draws.t.to(dev, compute_dtype)
    phi = (1 - t[:, None, None]) * x0 + t[:, None, None] * x1
    flow = x1 - x0
    cond = torch.where(span[..., None], torch.zeros((), dtype=x1.dtype, device=dev), x1)
    drop_audio_cond = torch.full((b,), draws.drop_audio or draws.drop_both, dtype=torch.bool, device=dev)
    drop_text = torch.full((b,), draws.drop_both, dtype=torch.bool, device=dev)

    pred = forward_fn(params, cfg.model, phi, cond, text, t, drop_audio_cond, drop_text, mask=None,
                      compute_dtype=compute_dtype, training=True, dropout_seed=draws.dropout_seed)
    se = torch.square(pred.float() - flow.float())
    counts = torch.stack([span.float().sum(), t.float().sum()])  # selected frames, summed flow times
    if data is not None:
        data.all_reduce(counts)
    denom = torch.clamp(counts[0] * se.shape[-1], min=1.0)
    loss = (se * span[..., None].float()).sum() / denom
    global_b = b * (data.size if data is not None else 1)
    return loss, {"masked_frames": counts[0].to(torch.int64), "t_mean": counts[1] / global_b}
