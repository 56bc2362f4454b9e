"""MMDiT backbone, SD3-style dual-stream joint attention (counterpart of
``f5tts_tpu/models/mmdit.py``).

The text stream (c) and the audio stream (x) carry their own q/k/v and
AdaLN params, attend jointly over the concatenated sequence (text keys are
never masked) and split back; the last block is ``context_pre_only`` (no
c-stream feed-forward or output projection). RoPE goes on the flat
projections with a ``dim_head``-wide table, so it rotates head 0 only (the
reference's quirk).

Kernels: the conv-position pair (no mask) goes through the conv-pos kernel
wrapper (with grad enabled, its differentiable route). The joint attention
is ``ops/attention.py:sdpa``, the plain attention: the JAX package runs it
through XLA (``sdpa_xla``), not a Pallas kernel. The JAX package has no engine or CLI path for this backbone, and
neither has the port. Training (``mmdit_forward(training=True)``) runs each
block under ``torch.utils.checkpoint`` (the JAX package remats each scanned
block); dropout is not applied, as in the JAX MMDiT.

Tensor parallelism (``tp``, the mesh's ``model`` axis) follows the JAX specs
(``parallel/sharding.py``): ``heads // tp.size`` local heads, the six q/k/v
projections column-parallel behind ``tp_input``, ``to_out`` row-parallel,
the feed-forwards, AdaLN and the embeddings replicated, the flat-RoPE quirk
on model rank 0 only (global head 0), for the audio and the text stream.
``to_out_c`` is column-parallel under the JAX key rule, so it gathers the
heads' output first and its output columns after
(``modules.gathered_column_linear``). Context parallelism raises: the JAX
MMDiT has no ring path (its joint attention is always ``sdpa_xla``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.models.dit import _rope_table, _text_pos_table, block, stack_depth
from f5tts_tpu_torch.ops.attention import sdpa
from f5tts_tpu_torch.ops.rope import apply_rotary


@dataclass(frozen=True)
class MMDiTConfig:
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 4
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_max_pos: int = 1024
    conv_pos_impl: str = "fused"  # "fused" (kernel wrapper) | "plain"


def _rotary(t, freqs):
    return t if freqs is None else apply_rotary(t, freqs)


def _joint_attention(p, x, c, heads: int, freqs_x, freqs_c, mask, context_pre_only: bool, tp=None):
    b, n, _ = x.shape
    nt = c.shape[1]
    if tp is not None and tp.size > 1:
        if heads % tp.size:
            raise ValueError(f"{heads} heads do not divide over {tp.size} model ranks")
        heads //= tp.size
        if tp.index > 0:  # the flat RoPE rotates global head 0, which lives on model rank 0
            freqs_x = freqs_c = None
    x, c = m.tp_input(x, tp), m.tp_input(c, tp)
    q = torch.cat([_rotary(m.linear(p["to_q"], x), freqs_x), _rotary(m.linear(p["to_q_c"], c), freqs_c)], 1)
    k = torch.cat([_rotary(m.linear(p["to_k"], x), freqs_x), _rotary(m.linear(p["to_k_c"], c), freqs_c)], 1)
    v = torch.cat([m.linear(p["to_v"], x), m.linear(p["to_v_c"], c)], 1)

    def split_heads(t):
        return t.reshape(b, n + nt, heads, -1).transpose(1, 2).contiguous()

    key_mask = F.pad(mask, (0, nt), value=True) if mask is not None else None  # text keys stay valid
    o = sdpa(split_heads(q), split_heads(k), split_heads(v), key_mask)
    o = o.transpose(1, 2).reshape(b, n + nt, -1)
    xo = m.row_parallel_linear(p["to_out"], o[:, :n], tp)
    co = o[:, n:] if context_pre_only else m.gathered_column_linear(p["to_out_c"], o[:, n:], tp)
    if mask is not None:
        xo = m._where_rows(mask, xo)
    return xo, co


def _block(p, x, c, t, heads: int, freqs_x, freqs_c, mask, context_pre_only: bool, tp=None):
    if context_pre_only:
        norm_c = m.adaln_zero_final(p["attn_norm_c"], c, t)
    else:
        norm_c, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = m.adaln_zero(p["attn_norm_c"], c, t)
    norm_x, x_gate_msa, x_shift_mlp, x_scale_mlp, x_gate_mlp = m.adaln_zero(p["attn_norm_x"], x, t)
    x_attn, c_attn = _joint_attention(p["attn"], norm_x, norm_c, heads, freqs_x, freqs_c, mask, context_pre_only,
                                      tp)
    if context_pre_only:
        c = None
    else:
        c = c + c_gate_msa[:, None] * c_attn
        norm_c = m.modulated_layer_norm(c, c_scale_mlp, c_shift_mlp)
        c = c + c_gate_mlp[:, None] * m.feed_forward(p["ff_c"], norm_c)
    x = x + x_gate_msa[:, None] * x_attn
    norm_x = m.modulated_layer_norm(x, x_scale_mlp, x_shift_mlp)
    return x + x_gate_mlp[:, None] * m.feed_forward(p["ff_x"], norm_x), c


def mmdit_text_embed(params, cfg: MMDiTConfig, text: torch.Tensor, drop_text: torch.Tensor) -> torch.Tensor:
    """``(b, nt) int (pad = -1)`` -> ``(b, nt, dim)``: ids + 1 (0 for padding
    and for rows whose text is dropped) and the absolute sin/cos table."""
    ids = torch.where(drop_text[:, None], 0, text.long() + 1)
    h = params["text_embed"]["w"][ids]
    table = _text_pos_table(cfg.dim, cfg.text_max_pos, str(h.device))
    return h + table[: h.shape[1]][None].to(h.dtype)


def mmdit_forward(
    params,
    cfg: MMDiTConfig,
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
    cp=None,  # no ring path: raises
    batch_rows: tuple[int, int] | None = None,  # accepted for the trainer's interface (no dropout)
) -> torch.Tensor:
    """The MMDiT's velocity prediction ``(b, n, mel_dim)``; with ``training``,
    per-block activation checkpointing; ``tp``: see the module docstring."""
    if cp is not None:
        raise NotImplementedError("the MMDiT has no context-parallel path: its joint attention is the plain sdpa "
                                  "over the whole sequence, as the JAX MMDiT's is always sdpa_xla")
    b, n, _ = x.shape
    if time.ndim == 0:
        time = time.expand(b)
    t = m.timestep_embedding(params["time_embed"], time.to(compute_dtype))
    if text_emb is None:
        text_emb = mmdit_text_embed(params, cfg, text, drop_text)
    c = text_emb.to(compute_dtype)
    zero = torch.zeros((), dtype=compute_dtype, device=x.device)
    cond = torch.where(drop_audio_cond[:, None, None], zero, cond.to(compute_dtype))
    p = params["audio_embed"]
    h = m.linear(p["proj"], torch.cat([x.to(compute_dtype), cond], dim=-1))
    h = m.conv_pos_embedding(p["conv_pos"], h, impl=cfg.conv_pos_impl) + h

    dev = str(x.device)
    freqs_x, freqs_c = _rope_table(n, cfg.dim_head, dev)[0], _rope_table(c.shape[1], cfg.dim_head, dev)[0]
    for i in range(stack_depth(params["blocks"])):
        blk = block(params["blocks"], i)
        args = (blk, h, c, t, cfg.heads, freqs_x, freqs_c, mask, False, tp)
        if training:  # each block under activation checkpointing
            h, c = checkpoint(_block, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            h, c = _block(*args)
    h, _ = _block(params["final_block"], h, c, t, cfg.heads, freqs_x, freqs_c, mask, True, tp)
    h = m.adaln_zero_final(params["norm_out"], h, t)
    return m.linear(params["proj_out"], h)
