"""Building-block layers of the DiT and Vocos (counterpart of
``f5tts_tpu/models/modules.py``).

Plain functions on tensors and parameter dictionaries with the JAX layouts:
Linear ``w: (in, out)``, Conv1d kernel ``(width, in/groups, out)``, Embedding
``(vocab, dim)``, activations frame-major ``(b, n, c)``. Numerics follow the
JAX code: tanh GELU in FeedForward, exact GELU in ConvNeXtV2, layer norm and
the GRN norm in fp32, the reference's head-0-only flat RoPE.

``attention(impl="flash")`` and ``conv_pos_embedding(impl="fused")`` go
through the kernel wrappers (CUDA kernel on a GPU tensor, plain version on a
CPU tensor); ``impl="plain"`` calls the plain versions on any device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.ops.attention import sdpa
from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos, conv_pos_plain, mish  # noqa: F401 (mish: layer API)
from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention
from f5tts_tpu_torch.ops.rope import apply_rotary, apply_rotary_per_head


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv1d(p, x, groups: int = 1, padding: int = 0, dilation: int = 1):
    """``x: (b, n, c)`` channel-last 1-D convolution with a ``(k, in/groups,
    out)`` kernel. Dense and depthwise convs go to ``F.conv1d``; other grouped
    convs are shifted per-tap contractions with the group index on the output
    axis (as in the JAX package)."""
    w = p["w"].to(x.dtype)
    k, cg_in, c_out = w.shape
    c_in = x.shape[-1]
    if groups == 1 or (cg_in == 1 and c_out == c_in):
        y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=padding, dilation=dilation, groups=groups)
        return y.transpose(1, 2) + p["b"].to(x.dtype)
    b, n, _ = x.shape
    co_g = c_out // groups
    x_pad = F.pad(x, (0, 0, padding, padding))
    wg = w.reshape(k, cg_in, groups, co_g)
    y = None
    for i in range(k):
        tap = x_pad[:, i * dilation : i * dilation + n].reshape(b, n, groups, cg_in)
        contrib = torch.einsum("bngi,igo->bngo", tap, wg[i])
        y = contrib if y is None else y + contrib
    return y.reshape(b, n, c_out) + p["b"].to(x.dtype)


def layer_norm(x, eps: float = 1e-6, weight=None, bias=None):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.square(x32 - mean).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _where_rows(mask, x):
    """Zero the frames of ``x (b, n, c)`` where ``mask (b, n)`` is False."""
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# timestep embedding
# ---------------------------------------------------------------------------


def sinus_position_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """``(b,) -> (b, dim)`` fp32; reference SinusPositionEmbedding (scale 1000)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    args = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def timestep_embedding(p, time: torch.Tensor, freq_embed_dim: int = 256) -> torch.Tensor:
    h = sinus_position_embedding(time, freq_embed_dim).to(time.dtype)
    h = linear(p["mlp1"], h)
    return linear(p["mlp2"], F.silu(h))


# ---------------------------------------------------------------------------
# conv position embedding
# ---------------------------------------------------------------------------


def conv_pos_embedding(p, x, mask=None, kernel_size: int = 31, groups: int = 16, impl: str = "fused"):
    """Two grouped Conv1d(k=31, groups=16) + Mish. ``mask`` is a per-row
    prefix (duration) mask applied to the input, between the convs (as the
    kernel's per-row ``lens``) and to the output, so every valid frame computes
    what an unpadded batch-1 call computes. ``impl='fused'`` takes the kernel
    wrapper, ``'plain'`` its plain version."""
    if p["conv1"]["w"].shape[0] != kernel_size:
        raise ValueError(f"conv_pos kernel width {p['conv1']['w'].shape[0]} != {kernel_size}")
    if mask is not None:
        x = _where_rows(mask, x)
    lens = mask.sum(-1).to(torch.int32) if mask is not None else None
    fn = {"fused": conv_pos, "plain": conv_pos_plain}[impl]
    y = fn(x, p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"], lens, groups)
    if mask is not None:
        y = _where_rows(mask, y)
    return y


# ---------------------------------------------------------------------------
# GRN + ConvNeXtV2
# ---------------------------------------------------------------------------


def grn(gamma, beta, x, mask=None):
    """Global response norm over the sequence axis; ``mask`` keeps padded
    frames out of the norm (the row's unpadded result)."""
    sq = torch.square(x.float())
    if mask is not None:
        sq = torch.where(mask[..., None], sq, 0.0)
    gx = torch.sqrt(sq.sum(1, keepdim=True))
    nx = (gx / (gx.mean(-1, keepdim=True) + 1e-6)).to(x.dtype)
    return gamma.to(x.dtype) * (x * nx) + beta.to(x.dtype) + x


def convnext_v2_block(p, x, dilation: int = 1, mask=None):
    if mask is not None:
        x = _where_rows(mask, x)
    pad = (dilation * 6) // 2
    h = conv1d(p["dwconv"], x, groups=x.shape[-1], padding=pad, dilation=dilation)
    h = layer_norm(h, 1e-6, p["norm_w"], p["norm_b"])
    h = F.gelu(linear(p["pw1"], h))
    h = grn(p["grn_gamma"], p["grn_beta"], h, mask)
    out = x + linear(p["pw2"], h)
    if mask is not None:
        out = _where_rows(mask, out)
    return out


# ---------------------------------------------------------------------------
# AdaLayerNormZero
# ---------------------------------------------------------------------------


def adaln_zero(p, x, emb):
    """Modulated x for attention plus (gate_msa, shift_mlp, scale_mlp, gate_mlp)."""
    mod = linear(p["linear"], F.silu(emb))
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
    h = layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    return h, gate_msa, shift_mlp, scale_mlp, gate_mlp


def adaln_zero_final(p, x, emb):
    scale, shift = linear(p["linear"], F.silu(emb)).chunk(2, dim=-1)
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


# ---------------------------------------------------------------------------
# FeedForward (tanh GELU) and attention
# ---------------------------------------------------------------------------


def feed_forward(p, x):
    return linear(p["out"], F.gelu(linear(p["in"], x), approximate="tanh"))


def attention(p, x, heads: int, rope_freqs=None, mask=None, impl: str = "flash", rope_all_heads: bool = False):
    """Self-attention with the reference's flat-RoPE quirk. ``impl='flash'``
    takes the kernel wrapper with the RoPE fused in; ``'plain'`` applies RoPE
    on the flat projection (head 0) or per head, then ``sdpa``."""
    b, n, _ = x.shape
    q = linear(p["to_q"], x)
    k = linear(p["to_k"], x)
    v = linear(p["to_v"], x)
    if impl == "plain" and rope_freqs is not None and not rope_all_heads:
        q = apply_rotary(q, rope_freqs)
        k = apply_rotary(k, rope_freqs)

    def split_heads(t):
        return t.reshape(b, n, heads, -1).transpose(1, 2).contiguous()

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if impl == "flash":
        o = flash_attention(q, k, v, mask, rope_freqs=rope_freqs, rope_all_heads=rope_all_heads)
    elif impl == "plain":
        if rope_freqs is not None and rope_all_heads:
            q = apply_rotary_per_head(q, rope_freqs)
            k = apply_rotary_per_head(k, rope_freqs)
        o = sdpa(q, k, v, mask)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    o = linear(p["to_out"], o.transpose(1, 2).reshape(b, n, -1))
    if mask is not None:
        o = _where_rows(mask, o)
    return o


def dit_block(p, x, t_emb, heads: int, rope_freqs=None, mask=None, impl: str = "flash", rope_all_heads: bool = False):
    norm, gate_msa, shift_mlp, scale_mlp, gate_mlp = adaln_zero(p["attn_norm"], x, t_emb)
    x = x + gate_msa[:, None] * attention(p["attn"], norm, heads, rope_freqs, mask, impl, rope_all_heads)
    norm = layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    return x + gate_mlp[:, None] * feed_forward(p["ff"], norm)
