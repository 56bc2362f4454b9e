"""Autoregressive mel-decoder TTS branch (counterpart of ``f5tts_tpu/models/ar.py``).

A decoder-only transformer over ``[text tokens ; BOS ; mel-frame embeddings]``
with causal attention and per-head RoPE:

- ``ar_loss``     -- teacher-forced next-frame regression (L1 + L2) plus the
                     stop-flag BCE; differentiable.
- ``ar_generate`` -- greedy generation: a prefill over ``[text ; BOS]`` fills a
                     per-layer KV cache, then one step per frame, the stop
                     flag of step i taking effect one step later.

Plain functions on the JAX params tree (``models/convert.py:init_ar_numpy``,
``ar_params_from_numpy``; blocks stacked on a leading depth axis). No TPU
kernel stands behind this branch: the attention is plain PyTorch with fp32
logits, a ``-1e30`` mask and softmax weights in the value dtype, as the JAX
code computes it (not SDPA, whose masking and accumulation differ).
Generation runs eagerly, one Python step per frame, where the JAX package
scans; the cache is written in place at each step's position.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.ops.rope import apply_rotary_per_head, rotary_freqs
from f5tts_tpu_torch.train.tree import tree_map


@dataclass(frozen=True)
class ARConfig:
    dim: int = 512
    depth: int = 12
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 4
    mel_dim: int = 100
    text_num_embeds: int = 256
    max_text_len: int = 512
    max_mel_len: int = 2048

    @property
    def inner(self) -> int:
        return self.heads * self.dim_head


def _layer(blocks, l: int):
    """Layer ``l`` of the stacked blocks (views, no copies)."""
    return tree_map(lambda t: t[l], blocks)


def _heads(t, heads: int):
    """(b, n, heads * d) -> (b, heads, n, d)."""
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def _attend(q, k, v, allowed):
    """fp32 logits scaled by ``d**-0.5``, ``-1e30`` where ``allowed`` is False,
    fp32 softmax, weights in ``v.dtype`` -> ``(b, nq, heads * d)``."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    probs = torch.softmax(torch.where(allowed, logits, -1e30), dim=-1).to(v.dtype)
    b, _, nq, _ = q.shape
    return (probs @ v).transpose(1, 2).reshape(b, nq, -1)


def _qkv(p, x, heads: int, freqs):
    q = apply_rotary_per_head(_heads(m.linear(p["to_q"], x), heads), freqs)
    k = apply_rotary_per_head(_heads(m.linear(p["to_k"], x), heads), freqs)
    return q, k, _heads(m.linear(p["to_v"], x), heads)


def _causal_mask(n: int, valid_mask, device):
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))[None, None]
    return mask if valid_mask is None else mask & valid_mask[:, None, None, :]


def _causal_attn(p, x, heads: int, freqs, valid_mask=None):
    q, k, v = _qkv(p, x, heads, freqs)
    return m.linear(p["to_out"], _attend(q, k, v, _causal_mask(x.shape[1], valid_mask, x.device)))


def _ff(blk, x):
    return x + m.feed_forward(blk["ff"], m.rms_norm(blk["ff_norm"], x))


def _block_apply(blk, x, heads: int, freqs, valid_mask=None):
    x = x + _causal_attn(blk["attn"], m.rms_norm(blk["attn_norm"], x), heads, freqs, valid_mask)
    return _ff(blk, x)


def _embed_sequence(params, cfg: ARConfig, text, mel):
    """[text emb ; BOS ; mel emb] -> (b, nt + 1 + nm, dim), in the promoted
    dtype of the text table and the mel projection (as ``jnp.concatenate``)."""
    te = params["text_embed"]["w"][text.long() + 1]
    me = m.linear(params["mel_in"], mel)
    dtype = torch.promote_types(te.dtype, me.dtype)
    bos = params["bos"].to(me.dtype).expand(mel.shape[0], 1, cfg.dim)
    return torch.cat([te.to(dtype), bos.to(dtype), me.to(dtype)], dim=1)


def ar_loss(params, cfg: ARConfig, text, mel, mel_lens, compute_dtype: torch.dtype = torch.float32):
    """Teacher-forced next-frame loss over valid frames plus the stop BCE.
    ``text`` (b, nt) int with -1 padding, ``mel`` (b, nm, mel_dim), ``mel_lens``
    (b,). Returns ``(loss, {"l1", "l2", "stop_bce"})``."""
    b, nm, _ = mel.shape
    nt = text.shape[1]
    dev = mel.device
    h = _embed_sequence(params, cfg, text, mel.to(compute_dtype))
    freqs = torch.as_tensor(rotary_freqs(h.shape[1], cfg.dim_head), device=dev)
    frame_pos = torch.arange(nm, device=dev)[None, :]
    mel_valid = frame_pos < mel_lens[:, None]
    valid = torch.cat([text != -1, torch.ones((b, 1), dtype=torch.bool, device=dev), mel_valid], dim=1)
    for l in range(cfg.depth):
        h = _block_apply(_layer(params["blocks"], l), h, cfg.heads, freqs, valid)
    h = m.rms_norm(params["norm_out"], h)

    dec = h[:, nt: nt + nm]  # position nt + k (BOS is at nt) predicts frame k
    pred = m.linear(params["mel_out"], dec).float()
    stop_logit = m.linear(params["stop_out"], dec)[..., 0]
    tgt = mel.float()
    w = mel_valid.float()[..., None]
    denom = w.sum().clamp_min(1.0) * cfg.mel_dim
    l1 = (torch.abs(pred - tgt) * w).sum() / denom
    l2 = (torch.square(pred - tgt) * w).sum() / denom

    stop_tgt = (frame_pos == (mel_lens[:, None] - 1)).float()
    stop_w = mel_valid.float()
    bce = (stop_w * (torch.clamp_min(stop_logit, 0) - stop_logit * stop_tgt
                     + torch.log1p(torch.exp(-torch.abs(stop_logit))))).sum() / stop_w.sum().clamp_min(1.0)
    return l1 + l2 + bce, {"l1": l1, "l2": l2, "stop_bce": bce}


@torch.no_grad()
def ar_generate(params, cfg: ARConfig, text: torch.Tensor, max_frames: int,
                compute_dtype: torch.dtype = torch.float32, stop_threshold: float = 0.5):
    """Greedy AR mel generation from ``text`` (b, nt) int, -1 padded. Returns
    ``(mel (b, max_frames, mel_dim), lengths (b,) int32)``: the frames a row
    emitted up to and including the one its stop flag marked as last, zeros
    after them. The stop computed at step i refers to the next frame being the
    last one, so it takes effect one step after that frame is emitted."""
    b, nt = text.shape
    dev = text.device
    total = nt + 1 + max_frames
    freqs_full = torch.as_tensor(rotary_freqs(total, cfg.dim_head), device=dev).to(compute_dtype)

    # prefill: [text ; BOS] through the causal pass, filling each layer's cache
    te = params["text_embed"]["w"][text.long() + 1].to(compute_dtype)
    bos = params["bos"].to(compute_dtype).expand(b, 1, cfg.dim)
    h = torch.cat([te, bos], dim=1)
    text_valid = torch.cat([text != -1, torch.ones((b, 1), dtype=torch.bool, device=dev)], dim=1)
    key_valid = torch.cat([text_valid, torch.ones((b, max_frames), dtype=torch.bool, device=dev)], dim=1)
    mask = _causal_mask(nt + 1, text_valid, dev)
    blocks = [_layer(params["blocks"], l) for l in range(cfg.depth)]  # sliced once, not once per frame
    caches = []
    for blk in blocks:
        q, k, v = _qkv(blk["attn"], m.rms_norm(blk["attn_norm"], h), cfg.heads, freqs_full[: nt + 1])
        h = _ff(blk, h + m.linear(blk["attn"]["to_out"], _attend(q, k, v, mask)))
        kc = torch.zeros((b, cfg.heads, total, cfg.dim_head), dtype=compute_dtype, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, : nt + 1] = k
        vc[:, :, : nt + 1] = v
        caches.append((kc, vc))
    frame = m.linear(params["mel_out"], m.rms_norm(params["norm_out"], h[:, -1:]))  # (b, 1, mel)

    key_idx = torch.arange(total, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    pending_stop = torch.zeros_like(done)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    frames = []
    for i in range(max_frames):
        frames.append(torch.where(done[:, None], 0.0, frame[:, 0]))
        lengths = torch.where(done, lengths, i + 1)
        pos = nt + 1 + i
        rope = freqs_full[pos: pos + 1]
        allowed = ((key_idx <= pos)[None] & key_valid)[:, None, None, :]
        h_tok = m.linear(params["mel_in"], frame.to(compute_dtype))
        for blk, (kc, vc) in zip(blocks, caches):
            q, k_new, v_new = _qkv(blk["attn"], m.rms_norm(blk["attn_norm"], h_tok), cfg.heads, rope)
            kc[:, :, pos] = k_new[:, :, 0]
            vc[:, :, pos] = v_new[:, :, 0]
            h_tok = _ff(blk, h_tok + m.linear(blk["attn"]["to_out"], _attend(q, kc, vc, allowed)))
        h_out = m.rms_norm(params["norm_out"], h_tok)
        frame = m.linear(params["mel_out"], h_out)
        stop = torch.sigmoid(m.linear(params["stop_out"], h_out)[..., 0])[:, 0]
        done = done | pending_stop
        pending_stop = stop > stop_threshold
    return torch.stack(frames, dim=1), lengths
