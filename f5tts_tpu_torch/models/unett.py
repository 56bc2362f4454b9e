"""UNetT backbone, E2-TTS flavor (counterpart of ``f5tts_tpu/models/unett.py``).

- text embedding: the DiT's (``models/dit.py:text_embed``);
- input embedding: ``Linear(concat(x, cond, text))`` + the grouped conv-position
  pair with residual (the DiT's ``input_embed``);
- the time embedding goes in front of the sequence as one token, so the
  blocks see ``n + 1`` frames, and the key mask gets a valid first column;
- ``depth`` RMSNorm pre-norm attention / feed-forward blocks in two stacked
  halves: the first half pushes each block's input as a skip, the second pops
  them last-in first-out and merges each by ``concat`` + Linear, ``add`` or
  ``none``; then RMSNorm and the slice back to frames ``1..n``.

The JAX package pads the ``n + 1`` sequence to a multiple of 128 on its flash
path, because its Pallas kernel needs ``n % 128 == 0``. The port's attention
kernel takes any ``n`` (``ops/kernels/flash_attention.py``), so nothing is
padded here: the blocks run at ``n + 1``. Padded rows change no valid row in
the JAX package either, so the valid rows agree.

Training (``unett_forward(training=True)``): the attention takes the
differentiable kernels at ``n + 1`` (no pad), the conv-pos pair its
differentiable route, and each block (with its skip merge) runs under
``torch.utils.checkpoint``, as the JAX package remats each scanned block.
Dropout is not applied, as in the JAX UNetT (``dropout_seed`` is accepted for
the trainer's interface).

Multi-device: ``tp`` and ``cp`` reach the blocks' attention and
feed-forward as in the DiT (``models/modules.py``); the skip projections,
norms and embeddings are replicated.

Parameters are the JAX tree (``models/convert.py:unett_params_from_numpy``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.models.dit import _rope_table, block, input_embed, stack_depth, text_embed


@dataclass(frozen=True)
class UNetTConfig:
    dim: int = 1024
    depth: int = 24
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 4
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_dim: int = 512
    conv_layers: int = 4
    skip_connect_type: str = "concat"  # "concat" | "add" | "none"
    max_pos: int = 4096
    attn_impl: str = "flash"  # "flash" (kernel wrapper) | "plain" | "ring" (context parallel over ``cp``)
    conv_pos_impl: str = "fused"  # "fused" (kernel wrapper) | "plain"
    rope_all_heads: bool = False

    def __post_init__(self):
        if self.depth % 2:
            raise ValueError("UNetT depth must be even")
        if self.skip_connect_type not in ("concat", "add", "none"):
            raise ValueError(f"unknown skip_connect_type {self.skip_connect_type!r}")

    @staticmethod
    def base() -> "UNetTConfig":
        """E2-TTS Base: 333.2 M params."""
        return UNetTConfig()

    @staticmethod
    def small() -> "UNetTConfig":
        """E2-TTS Small."""
        return UNetTConfig(dim=768, depth=20, heads=12, dim_head=64, ff_mult=4)


def unett_embed(params, cfg: UNetTConfig, text, seq_len: int, drop_text, valid_mask=None):
    """Step-invariant text embedding: the DiT's wiring (``text_dim``, ``max_pos``)."""
    return text_embed(params, cfg, text, seq_len, drop_text, valid_mask)


def _attn_ff(blk, h, cfg: UNetTConfig, freqs, cos_sin, mask, training: bool = False, tp=None, cp=None):
    a = m.attention(blk["attn"], m.rms_norm(blk["attn_norm"], h), cfg.heads, freqs, mask, impl=cfg.attn_impl,
                    rope_all_heads=cfg.rope_all_heads, training=training, rope_cos_sin=cos_sin, tp=tp, cp=cp)
    h = a + h
    return m.feed_forward(blk["ff"], m.rms_norm(blk["ff_norm"], h), tp=tp) + h


def _merge_skip(blk, h, skip, cfg: UNetTConfig):
    if cfg.skip_connect_type == "concat":
        return m.linear(blk["skip_proj"], torch.cat([h, skip], dim=-1))
    if cfg.skip_connect_type == "add":
        return h + skip
    return h


def unett_forward(
    params,
    cfg: UNetTConfig,
    x: torch.Tensor,  # (b, n, mel_dim) noised input
    cond: torch.Tensor,  # (b, n, mel_dim) masked cond audio
    text: torch.Tensor | None,  # (b, nt) int ids, pad -1 (None if text_emb given)
    time: torch.Tensor,  # (b,) or scalar
    drop_audio_cond: torch.Tensor,  # (b,) bool
    drop_text: torch.Tensor,  # (b,) bool
    mask: torch.Tensor | None = None,  # (b, n) bool
    text_emb: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
    training: bool = False,
    dropout_seed: int | None = None,  # accepted for the trainer's interface; no dropout (as in JAX)
    tp=None,  # the mesh's model axis: the blocks hold this rank's shards
    cp=None,  # the ring's axis (attn_impl="ring")
    batch_rows: tuple[int, int] | None = None,  # accepted for the trainer's interface (no dropout)
) -> torch.Tensor:
    """The UNetT's velocity prediction ``(b, n, mel_dim)``. With ``training``,
    the differentiable kernels and per-block activation checkpointing."""
    b, n, _ = x.shape
    if time.ndim == 0:
        time = time.expand(b)
    t = m.timestep_embedding(params["time_embed"], time.to(compute_dtype))
    if text_emb is None:
        text_emb = unett_embed(params, cfg, text, n, drop_text, valid_mask=mask)
    h = input_embed(params, x.to(compute_dtype), cond.to(compute_dtype), text_emb.to(compute_dtype),
                    drop_audio_cond, mask, conv_pos_impl=cfg.conv_pos_impl)

    h = torch.cat([t[:, None, :], h], dim=1)  # the time token in front
    if mask is not None:
        mask = F.pad(mask, (1, 0), value=True)
    freqs, cos_sin = _rope_table(n + 1, cfg.dim_head, str(x.device))

    def run(fn, *args):  # one block, under activation checkpointing in training
        if training:
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    half = stack_depth(params["first_half"])
    skips = []
    for i in range(half):
        skips.append(h)  # each block's input is its skip
        blk = block(params["first_half"], i)
        h = run(lambda h_in, blk=blk: _attn_ff(blk, h_in, cfg, freqs, cos_sin, mask, training, tp, cp), h)
    for i in range(half):
        blk = block(params["second_half"], i)
        h = run(lambda h_in, skip, blk=blk: _attn_ff(blk, _merge_skip(blk, h_in, skip, cfg), cfg, freqs, cos_sin, mask,
                                                     training, tp, cp), h, skips.pop())

    h = m.rms_norm(params["norm_out"], h)[:, 1 : n + 1]
    return m.linear(params["proj_out"], h)
