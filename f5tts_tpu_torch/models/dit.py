"""DiT backbone, F5-TTS flavor (counterpart of ``f5tts_tpu/models/dit.py``).

- text embedding: char ids +1 (0 = filler for the -1 padding), per-row CFG
  text drop, absolute sin/cos table, ConvNeXtV2 stack under the per-row
  duration mask;
- input embedding: ``Linear(concat(x, cond, text))`` + grouped conv-position
  embedding with residual;
- ``depth`` DiT blocks (a Python loop over the stacked params' depth axis),
  RoPE, AdaLN-Zero final + Linear -> mel.
- training (``dit_forward(training=True)``): the differentiable kernels,
  dropout from per-block seeds, and each block under activation
  checkpointing (the JAX package remats each scanned block);
- multi-device: ``tp`` (the mesh's ``model`` axis) runs the blocks on this
  rank's Megatron shards, int8-quantized ones included
  (``quantize_dit_params(tp=)``), ``cp`` the ring attention of
  ``attn_impl="ring"`` (serving and training), and ``batch_rows`` places a
  data-parallel rank's rows in the global batch for its dropout masks
  (``models/modules.py``).

Parameters are the JAX tree: nested dicts of tensors, the blocks stacked
with a leading depth axis (``models/convert.py:dit_params_from_numpy``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.ops.kernels.flash_attention import cos_sin_of
from f5tts_tpu_torch.ops.rope import precompute_freqs_cis, rotary_freqs
from f5tts_tpu_torch.train.tree import tree_leaves


@functools.lru_cache(maxsize=16)
def _rope_table(n: int, dim_head: int, device: str) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """The ``(n, dim_head)`` RoPE angle table on ``device`` and its fp32
    ``cos``/``sin`` (the serving attention kernel's inputs), made together
    once per bucket and handed to every layer of every forward. Read only."""
    freqs = torch.as_tensor(rotary_freqs(n, dim_head), device=device)
    return freqs, cos_sin_of(freqs)


@functools.lru_cache(maxsize=16)
def _text_pos_table(text_dim: int, max_pos: int, device: str) -> torch.Tensor:
    """The text embedding's absolute sin/cos table on ``device``, made once:
    uploading it on every embedding would wait for the card's queue to drain
    (a host sync per solve, and per segment on the step-batched path)."""
    return torch.as_tensor(precompute_freqs_cis(text_dim, max_pos), device=device)


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
    dropout: float = 0.1  # train-time attention/FF dropout (DiTBlock default)
    long_skip_connection: bool = False
    max_pos: int = 4096
    attn_impl: str = "flash"  # "flash" (kernel wrapper) | "plain" | "ring" (context parallel over ``cp``)
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


def unstack(stacked, depth: int) -> list:
    """A stacked parameter tree as ``depth`` per-layer trees of views (one
    ``unbind`` per leaf, so the backward stacks each leaf's gradient once)."""
    if isinstance(stacked, dict):
        parts = {k: unstack(v, depth) for k, v in stacked.items()}
        return [{k: parts[k][i] for k in stacked} for i in range(depth)]
    return list(torch.unbind(stacked, 0))


def block_dropout_seeds(seed: int, depth: int) -> list[tuple[int, int]]:
    """One (attention, feed-forward) dropout seed per block, derived from one
    seed up front (the counterpart of splitting the dropout key per block)."""
    seeds = np.random.default_rng(seed).integers(0, 2**62, size=(depth, 2))
    return [(int(a), int(f)) for a, f in seeds]


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
        table = _text_pos_table(cfg.text_dim, cfg.max_pos, str(h.device))[:seq_len]
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
    training: bool = False,
    dropout_seed: int | None = None,  # training: enables cfg.dropout
    tp=None,  # the mesh's model axis: the blocks hold this rank's shards
    cp=None,  # the ring's axis (attn_impl="ring")
    batch_rows: tuple[int, int] | None = None,  # (first row, global rows) of a data-parallel rank
) -> torch.Tensor:
    """The DiT's velocity prediction. With ``training``, attention takes the
    differentiable kernels (whatever ``cfg.dropout`` is), dropout draws from
    per-block seeds derived from ``dropout_seed``, and each block runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the backward
    instead of stored, and its dropout masks with them. ``tp``/``cp``/
    ``batch_rows``: see the module docstring; everything outside the blocks
    is replicated."""
    b, n, _ = x.shape
    if time.ndim == 0:
        time = time.expand(b)
    t = m.timestep_embedding(params["time_embed"], time.to(compute_dtype))
    if text_emb is None:
        text_emb = dit_embed(params, cfg, text, n, drop_text, valid_mask=mask)
    h = input_embed(params, x.to(compute_dtype), cond.to(compute_dtype), text_emb.to(compute_dtype),
                    drop_audio_cond, mask, conv_pos_impl=cfg.conv_pos_impl)
    freqs, cos_sin = _rope_table(n, cfg.dim_head, str(x.device))
    residual = h
    depth = stack_depth(params["blocks"])
    if training:
        seeds = (block_dropout_seeds(dropout_seed, depth) if dropout_seed is not None and cfg.dropout > 0.0
                 else [None] * depth)
        for blk, blk_seeds in zip(unstack(params["blocks"], depth), seeds):
            def run(h_in, blk=blk, blk_seeds=blk_seeds):
                return m.dit_block(blk, h_in, t, cfg.heads, freqs, mask, impl=cfg.attn_impl,
                                   rope_all_heads=cfg.rope_all_heads, training=True, dropout_seeds=blk_seeds,
                                   dropout_rate=cfg.dropout, tp=tp, cp=cp, rows=batch_rows)

            h = checkpoint(run, h, use_reentrant=False, preserve_rng_state=False)
    else:
        for i in range(depth):
            h = m.dit_block(block(params["blocks"], i), h, t, cfg.heads, freqs, mask,
                            impl=cfg.attn_impl, rope_all_heads=cfg.rope_all_heads, rope_cos_sin=cos_sin, tp=tp, cp=cp)
    if cfg.long_skip_connection:
        h = m.linear(params["long_skip"], torch.cat([h, residual], dim=-1))
    h = m.adaln_zero_final(params["norm_out"], h, t)
    return m.linear(params["proj_out"], h)


def param_count(params) -> int:
    """Number of parameters in a params tree (numpy or tensor leaves)."""
    return sum(int(np.prod(t.shape)) for _, t in tree_leaves(params))


def quantize_dit_params(params, tp=None):
    """Int8-quantize the hot matmuls (q/k/v/out and feed-forward in/out of all
    blocks, on their stacked depth axis); embeddings, convs, AdaLN and the
    output projection stay floating. Serving-only: the quantized leaves are
    not differentiable. ``tp``: ``params`` are this rank's shards
    (``parallel/sharding.py``); the row-parallel ``to_out`` and ``out`` take
    the whole weight's column scales (an abs-max all-reduced over ``tp``),
    so every shard is the one-device tree's slice, as the JAX engine
    quantizes its sharded global view."""
    blocks = params["blocks"]
    if "qkv" in blocks["attn"]:
        raise ValueError("quantization='int8' takes the to_q/to_k/to_v layout, not the fused qkv projection "
                         "(fuse_attention_qkv)")
    row_parallel = ("to_out", "out")
    q_blocks = {
        **blocks,
        "attn": {name: m.quantize_linear_params(blocks["attn"][name], tp if name in row_parallel else None)
                 for name in ("to_q", "to_k", "to_v", "to_out")},
        "ff": {name: m.quantize_linear_params(blocks["ff"][name], tp if name in row_parallel else None)
               for name in ("in", "out")},
    }
    return {**params, "blocks": q_blocks}
