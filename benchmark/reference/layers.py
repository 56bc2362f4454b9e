"""Layers of the reference (float32). Parameter trees use the layouts the
benchmark's weight maker writes (``benchmark/weights.py``): Linear ``w (in,
out)``, Conv1d ``w (width, in/groups, out)``, blocks stacked on a leading
depth axis."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fp8(t, dim):
    """``t`` rounded to float8 e4m3, scaled per slice along ``dim`` to its range (448)."""
    s = t.abs().amax(dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


# The type every tensor the reference holds is stored in. None: float32.
# "fp8": float8 e4m3 (per-row scales), as a serving stack one precision below
# bf16 would hold them: the operands and results of every product and
# convolution, the norms' outputs, the residual streams, the ODE state and
# velocity and the vocoder's head. The comparison's control
# (``judge.reference_rows(precision="fp8")``).
PRECISION = {"all": None}


def rnd(t):
    return fp8(t, -1) if PRECISION["all"] == "fp8" else t


def linear(p, x):
    if PRECISION["all"] == "fp8":
        y = fp8(x, -1) @ fp8(p["w"], 0)
    else:
        y = x @ p["w"]
    return rnd(y + p["b"] if "b" in p else y)


def conv1d(p, x, groups=1, padding=0):
    """Channel-last ``x (b, n, c)`` through ``F.conv1d``."""
    w = p["w"]
    if PRECISION["all"] == "fp8":
        x, w = fp8(x, -1), fp8(w, (0, 1))
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), p["b"], padding=padding, groups=groups)
    return rnd(y.transpose(1, 2))


def layer_norm(x, eps=1e-6, w=None, b=None):
    return rnd(F.layer_norm(x, (x.shape[-1],), w, b, eps))


def rms_norm(g, x, eps=1e-8):
    """x-transformers RMSNorm: ``x / max(||x||, eps**0.5) * sqrt(dim) * g``."""
    return rnd(x * torch.rsqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), eps)) * math.sqrt(x.shape[-1]) * g)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def masked(x, mask):
    return x if mask is None else x * mask[..., None].to(x.dtype)


def sinus_embedding(t, dim=256, scale=1000.0):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32) * -(math.log(10000.0) / (half - 1)))
    args = scale * t[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], -1)


def time_embedding(p, t):
    return linear(p["mlp2"], F.silu(linear(p["mlp1"], sinus_embedding(t))))


def text_pos_table(dim, n, device, theta=10000.0):
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64)[: dim // 2] / dim)
    ang = torch.outer(torch.arange(n, dtype=torch.float64), freqs)
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1).float().to(device)


def grn(gamma, beta, x, mask):
    gx = torch.sqrt((masked(x, mask) ** 2).sum(1, keepdim=True))
    nx = gx / (gx.mean(-1, keepdim=True) + 1e-6)
    return gamma * (x * nx) + beta + x


def convnext_v2(p, x, mask):
    x = masked(x, mask)
    h = conv1d(p["dwconv"], x, groups=x.shape[-1], padding=3)
    h = layer_norm(h, 1e-6, p["norm_w"], p["norm_b"])
    h = grn(p["grn_gamma"], p["grn_beta"], F.gelu(linear(p["pw1"], h)), mask)
    return masked(rnd(x + linear(p["pw2"], h)), mask)


def block(stacked, i):
    if isinstance(stacked, dict):
        return {k: block(v, i) for k, v in stacked.items()}
    return stacked[i]


def depth_of(stacked):
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def text_embed(p, text, n, drop, mask):
    """``(b, nt)`` ids (pad -1) -> ``(b, n, text_dim)``: ids + 1 (0 = filler),
    dropped rows all filler, then (with text blocks) the sin/cos position
    table and the ConvNeXt-V2 blocks."""
    b, nt = text.shape
    ids = torch.zeros((b, n), dtype=torch.long, device=text.device)
    ids[:, : min(nt, n)] = text[:, :n].long() + 1
    ids = torch.where(drop[:, None], torch.zeros_like(ids), ids)
    h = p["embed"]["w"][ids]
    if "blocks" in p:  # F5-TTS adds the position table only with its ConvNeXt blocks
        h = h + text_pos_table(h.shape[-1], n, h.device)[None]
        for i in range(depth_of(p["blocks"])):
            h = convnext_v2(block(p["blocks"], i), h, mask)
    return h


def conv_pos(p, x, mask, groups=16):
    """Two grouped Conv1d(k=31) + Mish, the input, the middle and the output
    zeroed past each row's duration."""
    x = masked(x, mask)
    y = masked(mish(conv1d(p["conv1"], x, groups=groups, padding=15)), mask)
    return masked(mish(conv1d(p["conv2"], y, groups=groups, padding=15)), mask)


def input_embed(p, x, cond, text_emb, drop_cond, mask):
    cond = torch.where(drop_cond[:, None, None], torch.zeros_like(cond), cond)
    h = linear(p["proj"], torch.cat([x, cond, text_emb], -1))
    return rnd(conv_pos(p["conv_pos"], h, mask) + h)


def rope_angles(n, d, device, theta=10000.0):
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    f = torch.outer(torch.arange(n, dtype=torch.float64), inv)
    return torch.cat([f, f], -1).float().to(device)


def rotate_head0(t, ang):
    """F5-TTS applies RoPE to the flat ``(b, n, heads * d)`` projection with a
    ``d``-wide table, which rotates head 0 only."""
    d = ang.shape[-1]
    t0 = t[..., :d]
    x1, x2 = t0.chunk(2, -1)
    rot = t0 * torch.cos(ang) + torch.cat([-x2, x1], -1) * torch.sin(ang)
    return torch.cat([rot, t[..., d:]], -1)


def attention(p, x, heads, ang, mask):
    b, n, _ = x.shape
    q = rotate_head0(linear(p["to_q"], x), ang)
    k = rotate_head0(linear(p["to_k"], x), ang)
    v = linear(p["to_v"], x)
    q, k, v = (t.reshape(b, n, heads, -1).transpose(1, 2) for t in (q, k, v))
    logits = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    o = torch.softmax(logits, -1) @ v
    o = linear(p["to_out"], o.transpose(1, 2).reshape(b, n, -1))
    return masked(o, mask)


def feed_forward(p, x):
    return linear(p["out"], F.gelu(linear(p["in"], x), approximate="tanh"))
