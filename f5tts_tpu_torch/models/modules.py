"""Building-block layers of the DiT, UNetT, MMDiT and Vocos (counterpart of
``f5tts_tpu/models/modules.py``).

Plain functions on tensors and parameter dictionaries with the JAX layouts:
Linear ``w: (in, out)``, Conv1d kernel ``(width, in/groups, out)``, Embedding
``(vocab, dim)``, activations frame-major ``(b, n, c)``. Numerics follow the
JAX code: tanh GELU in FeedForward, exact GELU in ConvNeXtV2, layer norm,
RMS norm and the GRN norm in fp32, the reference's head-0-only flat RoPE.

``linear`` sends int8-quantized params (``w_q``, ``s_w``) through the
``quant_matmul`` wrapper. ``attention(impl="flash")`` and
``conv_pos_embedding(impl="fused")`` go through the kernel wrappers (CUDA kernel on a GPU tensor, plain version on a
CPU tensor); ``impl="plain"`` calls the plain versions on any device.
AdaLN's modulated layer norm (``modulated_layer_norm``) and ``rms_norm``
take the row-norm kernel on a CUDA tensor that carries no gradient (serving
runs under ``torch.no_grad()``): one launch, fp32 math, one rounding, where
the chain rounds the norm and each modulation step to ``x.dtype``. With a
gradient to carry, and on the CPU, they are the JAX package's chain.

Training mode (``attention(training=True)``, ``dit_block(training=True)``)
takes the differentiable kernels: RoPE on q/k in PyTorch, then
``flash_attention_train``; with grad enabled the conv-pos pair is
``conv_pos_train`` (the kernel forward with each row's ``lens``, the plain
backward). Dropout is inverted dropout drawn from a generator seeded
inside the layer from an explicit seed, so re-running a block (activation
checkpointing) draws the same masks.

Tensor parallelism (``tp``: the mesh's ``model`` axis, ``parallel/mesh.py``,
or None): ``attention`` and ``feed_forward`` take this rank's Megatron
shards (``parallel/sharding.py``): ``heads // tp.size`` local heads, q/k/v
and the feed-forward's ``in`` column-parallel, ``to_out`` and ``out``
row-parallel, their partial products summed over ``tp`` and the replicated
bias added once, after the sum. The input of the column-parallel linears
passes ``tp_input`` (identity forward, its gradient summed over ``tp``).
The flat-RoPE quirk rotates global head 0, which lives on model rank 0: the
other ranks rotate nothing. ``tp`` of size 1 takes the one-device code as it
is. Int8 linears under ``tp`` follow the JAX global view: a column-parallel
one quantizes its (replicated) input as on one device; a row-parallel one
all-reduces the row abs-max with MAX, takes the int32 accumulators of its
K-shard, sums them over ``tp`` and rescales once (``_row_parallel_int8``),
so it equals the one-device linear bit for bit. ``attention(impl="ring")``
is context-parallel ring attention over the ``cp`` axis
(``parallel/ring_attention.py``), differentiable for training.

``fuse_attention_qkv`` makes the fused projection layout: one ``qkv``
linear of width ``3 * inner`` in place of ``to_q``/``to_k``/``to_v``, whose
output's thirds are strided views (a row stride of ``3 * inner``) that reach
the kernels with no copy. Off unless a caller builds such a tree; the int8
quantization and the tensor-parallel specs know only the three projections,
so they refuse it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from f5tts_tpu_torch.ops.attention import sdpa
from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos, conv_pos_plain, conv_pos_train, mish  # noqa: F401 (mish: layer API)
from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention
from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train
from f5tts_tpu_torch.ops.kernels.quant_matmul import kernel_layout, quant_matmul, rescale_rows, row_amax
from f5tts_tpu_torch.ops.kernels.row_norm import row_norm, row_norm_plain
from f5tts_tpu_torch.ops.rope import apply_rotary, apply_rotary_per_head

INT8_FLOORS = dict(amax_floor=0.0, scale_floor=1e-8)  # _linear_int8's floor in the JAX package: the scale at 1e-8


def _parallel(tp) -> bool:
    return tp is not None and tp.size > 1


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward; the gradient, partial on each
    rank (each rank's column shards see the whole input), summed over ``tp``."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the row-parallel partial products summed over ``tp``
    in the forward; the gradient passes unchanged (it is replicated)."""

    @staticmethod
    def forward(ctx, y, tp):
        return tp.all_reduce(y.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFeatures(torch.autograd.Function):
    """All-gather of this rank's slice of the last axis (the local heads'
    output) for a column-parallel linear that reads it whole. Its gradient,
    partial on each rank (each rank's columns see the whole input), is summed
    over ``tp`` and each rank keeps its slice."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.all_gather(x, x.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        g = tp.all_reduce(g.contiguous().clone())
        step = g.shape[-1] // tp.size
        return g.narrow(-1, tp.index * step, step), None


class _GatherColumns(torch.autograd.Function):
    """All-gather of a column-parallel linear's output columns for a
    replicated consumer. Its gradient is replicated, so each rank keeps its
    own columns."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp = tp
        return tp.all_gather(y, y.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        step = g.shape[-1] // tp.size
        return g.narrow(-1, tp.index * step, step), None


def _gather(fn, t, tp):
    if torch.is_grad_enabled() and t.requires_grad:
        return fn.apply(t, tp)
    return tp.all_gather(t, t.ndim - 1)


def gathered_column_linear(p, x, tp):
    """``linear`` with its output axis sharded over ``tp`` (``w (in, out)``
    on ``out`` and its bias with it) whose input is this rank's slice of the
    features and whose output feeds replicated code: the MMDiT's
    ``to_out_c`` under the JAX key rule. The input's slices are gathered
    (``_GatherFeatures``), the local columns computed, and the output's
    columns gathered (``_GatherColumns``). One device: ``linear`` itself."""
    if not _parallel(tp):
        return linear(p, x)
    return _gather(_GatherColumns, linear(p, _gather(_GatherFeatures, x, tp)), tp)


def tp_input(x, tp):
    """The input of column-parallel linears (see ``_CopyToModel``)."""
    if _parallel(tp) and torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModel.apply(x, tp)
    return x


def row_parallel_linear(p, x, tp):
    """``linear`` with its input axis sharded over ``tp``: the partial
    products summed over the model group, then the (replicated) bias added
    once; int8 params go through ``_row_parallel_int8``. One device:
    ``linear`` itself."""
    if not _parallel(tp):
        return linear(p, x)
    if "w_q" in p:
        return _row_parallel_int8(p, x, tp)
    y = x @ p["w"].to(x.dtype)
    y = _ReduceFromModel.apply(y, tp) if torch.is_grad_enabled() and y.requires_grad else tp.all_reduce(y)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


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
    ``quant_matmul`` wrapper (one kernel launch on a GPU tensor, the bias
    added inside it as the JAX package adds it: after the rounding to
    ``x.dtype``) with this function's floor in the JAX package: the scale at
    1e-8, not the abs-max at 1e-6. Params: ``w_q`` int8 ``(in, out)``,
    ``s_w``, optional ``b``, and on a GPU the kernel-layout copy ``w_qt``."""
    k, n = p["w_q"].shape
    return quant_matmul(x.reshape(-1, k).contiguous(), p["w_q"], p["s_w"], w_qt=p.get("w_qt"), b=p.get("b"),
                        **INT8_FLOORS).reshape(*x.shape[:-1], n)


def _row_parallel_int8(p, x, tp):
    """``_linear_int8`` of a row-parallel linear (``w_q`` this rank's K-shard,
    ``s_w`` the whole weight's scales): the local row abs-max all-reduced with
    MAX (the JAX global view spans the whole row), the int32 accumulators of
    this shard (``quant_matmul(amax=, raw=True)``) summed over ``tp`` (exact:
    the whole K stays under ``MAX_K``), then one rescale with the bias
    (``rescale_rows``). Bit-equal to the one-device linear; on a GPU three
    kernel launches."""
    k, n = p["w_q"].shape
    x2 = x.reshape(-1, k).contiguous()
    amax = tp.all_reduce(row_amax(x2), op=dist.ReduceOp.MAX)
    acc = tp.all_reduce(quant_matmul(x2, p["w_q"], p["s_w"], w_qt=p.get("w_qt"), amax=amax, raw=True,
                                     **INT8_FLOORS))
    y = rescale_rows(acc, amax, p["s_w"], b=p.get("b"), dtype=x.dtype, **INT8_FLOORS)
    return y.reshape(*x.shape[:-1], n)


def quantize_linear_params(p, tp=None):
    """fp Linear params -> int8 symmetric per-out-channel quantized form
    ``{w_q, s_w[, b]}``; leading (stacked-depth) axes are kept. On a GPU the
    kernel's K-contiguous copy ``w_qt`` is made here, once, from this rank's
    ``w_q``. ``tp``: the weight is this rank's K-shard of a row-parallel
    linear; the per-column abs-max is all-reduced with MAX over it, so the
    scales are the whole weight's (as the JAX engine quantizes its global
    view)."""
    w = p["w"].float()
    amax = w.abs().amax(-2)
    if _parallel(tp):
        amax = tp.all_reduce(amax, op=dist.ReduceOp.MAX)
    s = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    wq = torch.clamp(torch.round(w / s.unsqueeze(-2)), -127, 127).to(torch.int8)
    out = {"w_q": wq, "s_w": s}
    if wq.is_cuda:
        out["w_qt"] = kernel_layout(wq)
    if "b" in p:
        out["b"] = p["b"]
    return out


def fuse_attention_qkv(attn_params):
    """``to_q``/``to_k``/``to_v`` concatenated into one ``(in, 3 * inner)``
    projection ``qkv`` (bias too, if any); leading (stacked-depth) axes are
    kept. Numpy or tensor leaves, as given."""
    q, k, v = (attn_params[name] for name in ("to_q", "to_k", "to_v"))
    cat = np.concatenate if isinstance(q["w"], np.ndarray) else torch.cat
    fused = {"w": cat([q["w"], k["w"], v["w"]], -1)}
    if "b" in q:
        fused["b"] = cat([q["b"], k["b"], v["b"]], -1)
    return {"qkv": fused, "to_out": attn_params["to_out"]}


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


def _carries_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def modulated_layer_norm(x, scale, shift):
    """AdaLN's ``layer_norm(x) * (1 + scale) + shift`` of ``x (b, n, c)`` with
    ``scale``, ``shift`` ``(b, c)``. A CUDA ``x`` with no gradient to carry
    takes the row-norm kernel (one launch, fp32 math, one rounding to
    ``x.dtype``); otherwise the chain as the JAX package spells it."""
    if x.is_cuda and not _carries_grad(x, scale, shift):
        return row_norm(x.contiguous(), scale=scale, shift=shift, eps=1e-6)
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def rms_norm(p, x, eps: float = 1e-8):
    """x-transformers RMSNorm (the UNetT's): ``x * sqrt(dim) * g`` over the
    unit-RMS row, in fp32. A CUDA ``x`` with no gradient to carry takes the
    row-norm kernel, as ``modulated_layer_norm`` does."""
    if x.is_cuda and not _carries_grad(x, p["g"]):
        return row_norm(x.contiguous(), g=p["g"], eps=eps)
    return row_norm_plain(x, g=p["g"], eps=eps)


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
    wrapper (with grad enabled, its differentiable form ``conv_pos_train``),
    ``'plain'`` its plain version."""
    if p["conv1"]["w"].shape[0] != kernel_size:
        raise ValueError(f"conv_pos kernel width {p['conv1']['w'].shape[0]} != {kernel_size}")
    if mask is not None:
        x = _where_rows(mask, x)
    weights = (p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"])
    lens = mask.sum(-1).to(torch.int32) if mask is not None else None
    if impl == "fused" and torch.is_grad_enabled():  # the differentiable kernel route (training)
        y = conv_pos_train(x, *weights, lens, groups)
    else:
        y = {"fused": conv_pos, "plain": conv_pos_plain}[impl](x, *weights, lens, groups)
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
    h = modulated_layer_norm(x, scale_msa, shift_msa)
    return h, gate_msa, shift_mlp, scale_mlp, gate_mlp


def adaln_zero_final(p, x, emb):
    scale, shift = linear(p["linear"], F.silu(emb)).chunk(2, dim=-1)
    return modulated_layer_norm(x, scale, shift)


# ---------------------------------------------------------------------------
# FeedForward (tanh GELU) and attention
# ---------------------------------------------------------------------------


def dropout(x, seed: int, rate: float, window: tuple[tuple[int, int], ...] | None = None):
    """Inverted dropout with masks drawn from a fresh generator seeded with
    ``seed`` (train time only): the same seed gives the same mask, so a
    recomputed block matches. ``window``, one ``(start, whole)`` per axis,
    says that ``x`` is the block ``[start, start + x.shape[i])`` of a tensor
    ``whole`` long on each axis (a rank's rows and columns): the mask of the
    whole tensor is drawn and ``x`` takes its block, so a sharded run draws
    the one-device run's masks."""
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(seed)
    shape = x.shape if window is None else tuple(whole for _, whole in window)
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    if window is not None:
        mask = mask[tuple(slice(start, start + n) for (start, _), n in zip(window, x.shape))]
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


def _dropout_window(x, rows, tp):
    """The ``dropout`` window of a ``(b, n, c)`` activation: this rank's
    ``rows = (first row, global rows)`` of the data-parallel batch, and its
    block of the columns when ``tp`` shards them (None: the whole tensor)."""
    if rows is None and not _parallel(tp):
        return None
    b, n, c = x.shape
    row = rows if rows is not None else (0, b)
    col = (tp.index * c, tp.size * c) if _parallel(tp) else (0, c)
    return (row, (0, n), col)


def feed_forward(p, x, dropout_seed: int | None = None, dropout_rate: float = 0.0, tp=None, rows=None):
    """Linear + tanh GELU, dropout, Linear; under ``tp`` the hidden is this
    rank's columns (its dropout mask the matching block of the one-device
    mask), ``in`` column- and ``out`` row-parallel. ``rows``: see
    ``_dropout_window``."""
    h = F.gelu(linear(p["in"], tp_input(x, tp)), approximate="tanh")
    if dropout_seed is not None and dropout_rate > 0.0:  # Sequential(Linear+GELU, Dropout, Linear)
        h = dropout(h, dropout_seed, dropout_rate, _dropout_window(h, rows, tp))
    return row_parallel_linear(p["out"], h, tp)


def _rope_heads(t, rope_freqs, rope_all_heads: bool):
    """RoPE on ``(b, h, n, d)``: every head, or head 0 only (the flat-RoPE quirk)."""
    if rope_all_heads:
        return apply_rotary_per_head(t, rope_freqs)
    return torch.cat([apply_rotary_per_head(t[:, :1], rope_freqs), t[:, 1:]], 1)


def attention(p, x, heads: int, rope_freqs=None, mask=None, impl: str = "flash", rope_all_heads: bool = False,
              training: bool = False, dropout_seed: int | None = None, dropout_rate: float = 0.0,
              rope_cos_sin=None, tp=None, cp=None, rows=None):
    """Self-attention with the reference's flat-RoPE quirk. ``impl='flash'``
    takes the kernel wrapper with the RoPE fused in (serving; ``rope_cos_sin``
    is handed to it) or, with ``training``, RoPE in PyTorch and the
    differentiable kernels; ``'plain'`` applies RoPE on the flat projection
    (head 0) or per head, then ``sdpa``; ``'ring'`` does the same RoPE, then
    ring attention over the ``cp`` axis (serving and training: its backward
    runs kernel 3b per hop). ``tp``: this rank's heads (see the module
    docstring); ``rows``: the dropout window's rows."""
    b, n, _ = x.shape
    if _parallel(tp):
        if heads % tp.size:
            raise ValueError(f"{heads} heads do not divide over {tp.size} model ranks")
        heads //= tp.size
        if not rope_all_heads and tp.index > 0:  # global head 0 lives on model rank 0
            rope_freqs = rope_cos_sin = None
    x = tp_input(x, tp)
    if "qkv" in p:  # the fused layout: three strided views of one product
        q, k, v = linear(p["qkv"], x).chunk(3, -1)
    else:
        q = linear(p["to_q"], x)
        k = linear(p["to_k"], x)
        v = linear(p["to_v"], x)
    if impl in ("plain", "ring") and rope_freqs is not None and not rope_all_heads:
        q = apply_rotary(q, rope_freqs)
        k = apply_rotary(k, rope_freqs)

    def split_heads(t):  # a (b, h, n, d) view; the kernels read it through its strides
        return t.reshape(b, n, heads, -1).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if impl != "flash":  # the plain path takes contiguous heads
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if impl != "flash" and rope_freqs is not None and rope_all_heads:
        q = apply_rotary_per_head(q, rope_freqs)
        k = apply_rotary_per_head(k, rope_freqs)
    if impl == "flash" and training:
        if rope_freqs is not None:  # the RoPE's cat is q's and k's one copy; v stays a view
            q, k = _rope_heads(q, rope_freqs, rope_all_heads), _rope_heads(k, rope_freqs, rope_all_heads)
        o = flash_attention_train(q, k, v, mask)
    elif impl == "flash":
        o = flash_attention(q, k, v, mask, rope_freqs=rope_freqs, rope_all_heads=rope_all_heads,
                            rope_cos_sin=rope_cos_sin)
    elif impl == "plain":
        o = sdpa(q, k, v, mask)
    elif impl == "ring":
        if cp is None:
            raise ValueError("attn_impl='ring' needs the cp axis")
        from f5tts_tpu_torch.parallel.ring_attention import ring_attention

        o = ring_attention(q, k, v, mask, cp)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    o = row_parallel_linear(p["to_out"], o.transpose(1, 2).reshape(b, n, -1), tp)  # a view of the kernels' output
    if dropout_seed is not None and dropout_rate > 0.0:
        o = dropout(o, dropout_seed, dropout_rate, _dropout_window(o, rows, None))  # to_out = [Linear, Dropout]
    if mask is not None:
        o = _where_rows(mask, o)
    return o


def dit_block(p, x, t_emb, heads: int, rope_freqs=None, mask=None, impl: str = "flash", rope_all_heads: bool = False,
              training: bool = False, dropout_seeds: tuple[int, int] | None = None, dropout_rate: float = 0.0,
              rope_cos_sin=None, tp=None, cp=None, rows=None):
    """One DiT block; ``dropout_seeds`` = (attention seed, feed-forward seed);
    ``rope_cos_sin``, ``tp``, ``cp`` and ``rows`` as ``attention`` takes them."""
    attn_seed, ff_seed = dropout_seeds if dropout_seeds is not None else (None, None)
    norm, gate_msa, shift_mlp, scale_mlp, gate_mlp = adaln_zero(p["attn_norm"], x, t_emb)
    x = x + gate_msa[:, None] * attention(p["attn"], norm, heads, rope_freqs, mask, impl, rope_all_heads,
                                          training, attn_seed, dropout_rate, rope_cos_sin, tp, cp, rows)
    norm = modulated_layer_norm(x, scale_mlp, shift_mlp)
    return x + gate_mlp[:, None] * feed_forward(p["ff"], norm, ff_seed, dropout_rate, tp, rows)
