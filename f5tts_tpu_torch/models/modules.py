"""Building-block layers of the DiT and Vocos (counterpart of
``f5tts_tpu/models/modules.py``).

Plain functions on tensors and parameter dictionaries with the JAX layouts:
Linear ``w: (in, out)``, Conv1d kernel ``(width, in/groups, out)``, Embedding
``(vocab, dim)``, activations frame-major ``(b, n, c)``. Numerics follow the
JAX code: tanh GELU in FeedForward, exact GELU in ConvNeXtV2, layer norm and
the GRN norm in fp32, the reference's head-0-only flat RoPE.

``linear`` sends int8-quantized params (``w_q``, ``s_w``) through the
``quant_matmul`` wrapper. ``attention(impl="flash")`` and
``conv_pos_embedding(impl="fused")`` go through the kernel wrappers (CUDA kernel on a GPU tensor, plain version on a
CPU tensor); ``impl="plain"`` calls the plain versions on any device.

Training mode (``attention(training=True)``, ``dit_block(training=True)``)
takes the differentiable kernels: RoPE on q/k in PyTorch, then
``flash_attention_train``; the conv-pos pair without a mask is
``conv_pos_train``. Dropout is inverted dropout drawn from a generator seeded
inside the layer from an explicit seed, so re-running a block (activation
checkpointing) draws the same masks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.ops.attention import sdpa
from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos, conv_pos_plain, conv_pos_train, mish  # noqa: F401 (mish: layer API)
from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention
from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train
from f5tts_tpu_torch.ops.kernels.quant_matmul import kernel_layout, quant_matmul
from f5tts_tpu_torch.ops.rope import apply_rotary, apply_rotary_per_head


def linear(p, x):
    if "w_q" in p:
        return _linear_int8(p, x)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _linear_int8(p, x):
    """W8A8 dynamic-quantized linear: per-out-channel weight scales ``s_w
    (out,)``, per-token activation scales, int32 accumulation, through the
    ``quant_matmul`` wrapper (one kernel launch on a GPU tensor) with this
    function's floor in the JAX package: the scale at 1e-8, not the abs-max at
    1e-6. Params: ``w_q`` int8 ``(in, out)``, ``s_w``, optional ``b``, and on a
    GPU the kernel-layout copy ``w_qt``."""
    k, n = p["w_q"].shape
    y = quant_matmul(x.reshape(-1, k).contiguous(), p["w_q"], p["s_w"], w_qt=p.get("w_qt"),
                     amax_floor=0.0, scale_floor=1e-8).reshape(*x.shape[:-1], n)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def quantize_linear_params(p):
    """fp Linear params -> int8 symmetric per-out-channel quantized form
    ``{w_q, s_w[, b]}``; leading (stacked-depth) axes are kept. On a GPU the
    kernel's K-contiguous copy ``w_qt`` is made here, once."""
    w = p["w"].float()
    amax = w.abs().amax(-2)
    s = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    wq = torch.clamp(torch.round(w / s.unsqueeze(-2)), -127, 127).to(torch.int8)
    out = {"w_q": wq, "s_w": s}
    if wq.is_cuda:
        out["w_qt"] = kernel_layout(wq)
    if "b" in p:
        out["b"] = p["b"]
    return out


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
    weights = (p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"])
    if impl == "fused" and mask is None:  # full rows (training): the differentiable kernel pair
        return conv_pos_train(x, *weights, groups)
    lens = mask.sum(-1).to(torch.int32) if mask is not None else None
    fn = {"fused": conv_pos, "plain": conv_pos_plain}[impl]
    y = fn(x, *weights, lens, groups)
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


def dropout(x, seed: int, rate: float):
    """Inverted dropout with masks drawn from a fresh generator seeded with
    ``seed`` (train time only): the same seed gives the same mask, so a
    recomputed block matches."""
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(seed)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


def feed_forward(p, x, dropout_seed: int | None = None, dropout_rate: float = 0.0):
    h = F.gelu(linear(p["in"], x), approximate="tanh")
    if dropout_seed is not None and dropout_rate > 0.0:
        h = dropout(h, dropout_seed, dropout_rate)  # Sequential(Linear+GELU, Dropout, Linear)
    return linear(p["out"], h)


def _rope_heads(t, rope_freqs, rope_all_heads: bool):
    """RoPE on ``(b, h, n, d)``: every head, or head 0 only (the flat-RoPE quirk)."""
    if rope_all_heads:
        return apply_rotary_per_head(t, rope_freqs)
    return torch.cat([apply_rotary_per_head(t[:, :1], rope_freqs), t[:, 1:]], 1)


def attention(p, x, heads: int, rope_freqs=None, mask=None, impl: str = "flash", rope_all_heads: bool = False,
              training: bool = False, dropout_seed: int | None = None, dropout_rate: float = 0.0,
              rope_cos_sin=None):
    """Self-attention with the reference's flat-RoPE quirk. ``impl='flash'``
    takes the kernel wrapper with the RoPE fused in (serving; ``rope_cos_sin``
    is handed to it) or, with ``training``, RoPE in PyTorch and the
    differentiable kernels; ``'plain'`` applies RoPE on the flat projection
    (head 0) or per head, then ``sdpa``."""
    b, n, _ = x.shape
    q = linear(p["to_q"], x)
    k = linear(p["to_k"], x)
    v = linear(p["to_v"], x)
    if impl == "plain" and rope_freqs is not None and not rope_all_heads:
        q = apply_rotary(q, rope_freqs)
        k = apply_rotary(k, rope_freqs)

    def split_heads(t):  # a (b, h, n, d) view; the kernels read it through its strides
        return t.reshape(b, n, heads, -1).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if impl != "flash":  # the plain path takes contiguous heads
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if impl == "flash" and training:
        if rope_freqs is not None:  # the RoPE's cat is q's and k's one copy; v stays a view
            q, k = _rope_heads(q, rope_freqs, rope_all_heads), _rope_heads(k, rope_freqs, rope_all_heads)
        o = flash_attention_train(q, k, v, mask)
    elif impl == "flash":
        o = flash_attention(q, k, v, mask, rope_freqs=rope_freqs, rope_all_heads=rope_all_heads,
                            rope_cos_sin=rope_cos_sin)
    elif impl == "plain":
        if rope_freqs is not None and rope_all_heads:
            q = apply_rotary_per_head(q, rope_freqs)
            k = apply_rotary_per_head(k, rope_freqs)
        o = sdpa(q, k, v, mask)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    o = linear(p["to_out"], o.transpose(1, 2).reshape(b, n, -1))  # a view of the kernels' (b, n, h, d) output
    if dropout_seed is not None and dropout_rate > 0.0:
        o = dropout(o, dropout_seed, dropout_rate)  # to_out = [Linear, Dropout]
    if mask is not None:
        o = _where_rows(mask, o)
    return o


def dit_block(p, x, t_emb, heads: int, rope_freqs=None, mask=None, impl: str = "flash", rope_all_heads: bool = False,
              training: bool = False, dropout_seeds: tuple[int, int] | None = None, dropout_rate: float = 0.0,
              rope_cos_sin=None):
    """One DiT block; ``dropout_seeds`` = (attention seed, feed-forward seed);
    ``rope_cos_sin`` as ``attention`` takes it."""
    attn_seed, ff_seed = dropout_seeds if dropout_seeds is not None else (None, None)
    norm, gate_msa, shift_mlp, scale_mlp, gate_mlp = adaln_zero(p["attn_norm"], x, t_emb)
    x = x + gate_msa[:, None] * attention(p["attn"], norm, heads, rope_freqs, mask, impl, rope_all_heads,
                                          training, attn_seed, dropout_rate, rope_cos_sin)
    norm = layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    return x + gate_mlp[:, None] * feed_forward(p["ff"], norm, ff_seed, dropout_rate)
