"""DiT backbone, F5-TTS flavor (counterpart of ``f5tts_tpu/models/dit.py``).

- text embedding: char ids +1 (0 = filler for the -1 padding), per-row CFG
  text drop, absolute sin/cos table, ConvNeXtV2 stack under the per-row
  duration mask;
- input embedding: ``Linear(concat(x, cond, text))`` + grouped conv-position
  embedding with residual;
- ``depth`` DiT blocks (a Python loop over the stacked params' depth axis),
  RoPE, AdaLN-Zero final + Linear -> mel.

Parameters are the JAX tree: nested dicts of tensors, the blocks stacked
with a leading depth axis (``models/convert.py:dit_params_from_numpy``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.ops.rope import precompute_freqs_cis, rotary_freqs


@dataclass(frozen=True)
class DiTConfig:
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_dim: int = 512
    conv_layers: int = 4
    long_skip_connection: bool = False
    max_pos: int = 4096
    attn_impl: str = "flash"  # "flash" (kernel wrapper) | "plain"
    conv_pos_impl: str = "fused"  # "fused" (kernel wrapper) | "plain"
    rope_all_heads: bool = False  # False = reference parity (head-0-only RoPE)

    @staticmethod
    def base() -> "DiTConfig":
        """F5-TTS Base: 335.8 M params."""
        return DiTConfig()

    @staticmethod
    def small() -> "DiTConfig":
        return DiTConfig(dim=768, depth=18, heads=12, ff_mult=2, text_dim=512, conv_layers=4)


def block(stacked, i: int):
    """Layer ``i`` of a stacked parameter tree."""
    if isinstance(stacked, dict):
        return {k: block(v, i) for k, v in stacked.items()}
    return stacked[i]


def stack_depth(stacked) -> int:
    """Size of the leading depth axis of a stacked parameter tree."""
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def text_embed(params, cfg: DiTConfig, text: torch.Tensor, seq_len: int, drop_text: torch.Tensor,
               valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``(b, nt) int (pad = -1)`` -> ``(b, seq_len, text_dim)``; ``drop_text``
    bool ``(b,)``; ``valid_mask (b, seq_len)`` each row's true frames."""
    p = params["text_embed"]
    b, nt = text.shape
    ids = text[:, :seq_len].long() + 1
    if nt < seq_len:
        ids = torch.nn.functional.pad(ids, (0, seq_len - nt))
    ids = torch.where(drop_text[:, None], 0, ids)
    h = p["embed"]["w"][ids]
    if p.get("blocks") is not None:
        table = torch.as_tensor(precompute_freqs_cis(cfg.text_dim, cfg.max_pos)[:seq_len], device=h.device)
        h = h + table[None].to(h.dtype)
        for i in range(stack_depth(p["blocks"])):
            h = m.convnext_v2_block(block(p["blocks"], i), h, mask=valid_mask)
    return h


def input_embed(params, x, cond, text_emb, drop_audio_cond, mask=None, conv_pos_impl: str = "fused"):
    p = params["input_embed"]
    cond = torch.where(drop_audio_cond[:, None, None], torch.zeros((), dtype=cond.dtype, device=cond.device), cond)
    h = m.linear(p["proj"], torch.cat([x, cond, text_emb], dim=-1))
    return m.conv_pos_embedding(p["conv_pos"], h, mask, impl=conv_pos_impl) + h


def dit_embed(params, cfg: DiTConfig, text, seq_len: int, drop_text, valid_mask=None):
    """Step-invariant text embedding, lifted out of the ODE loop by the sampler."""
    return text_embed(params, cfg, text, seq_len, drop_text, valid_mask)


def dit_forward(
    params,
    cfg: DiTConfig,
    x: torch.Tensor,  # (b, n, mel_dim) noised input
    cond: torch.Tensor,  # (b, n, mel_dim) masked cond audio
    text: torch.Tensor | None,  # (b, nt) int ids, pad -1 (None if text_emb given)
    time: torch.Tensor,  # (b,) or scalar
    drop_audio_cond: torch.Tensor,  # (b,) bool
    drop_text: torch.Tensor,  # (b,) bool
    mask: torch.Tensor | None = None,  # (b, n) bool
    text_emb: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    b, n, _ = x.shape
    if time.ndim == 0:
        time = time.expand(b)
    t = m.timestep_embedding(params["time_embed"], time.to(compute_dtype))
    if text_emb is None:
        text_emb = dit_embed(params, cfg, text, n, drop_text, valid_mask=mask)
    h = input_embed(params, x.to(compute_dtype), cond.to(compute_dtype), text_emb.to(compute_dtype),
                    drop_audio_cond, mask, conv_pos_impl=cfg.conv_pos_impl)
    freqs = torch.as_tensor(rotary_freqs(n, cfg.dim_head), device=x.device)
    residual = h
    for i in range(stack_depth(params["blocks"])):
        h = m.dit_block(block(params["blocks"], i), h, t, cfg.heads, freqs, mask,
                        impl=cfg.attn_impl, rope_all_heads=cfg.rope_all_heads)
    if cfg.long_skip_connection:
        h = m.linear(params["long_skip"], torch.cat([h, residual], dim=-1))
    h = m.adaln_zero_final(params["norm_out"], h, t)
    return m.linear(params["proj_out"], h)

