"""E2-TTS's UNetT velocity prediction (float32): the DiT's embeddings, the
time embedding as one token in front of the sequence, RMSNorm pre-norm
blocks in two halves whose skips are merged by concat + Linear, RMSNorm,
projection to mel.

``forward(p, cfg, x, cond, text_emb, t, drop, mask)`` as ``dit.forward``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import layers as L


def forward(p, cfg, x, cond, text_emb, t, drop, mask):
    n = x.shape[1]
    temb = L.time_embedding(p["time_embed"], t)
    h = L.input_embed(p["input_embed"], x, cond, text_emb, drop, mask)
    h = torch.cat([temb[:, None], h], 1)
    mask = F.pad(mask, (1, 0), value=True)
    ang = L.rope_angles(n + 1, cfg["dim_head"], h.device)

    def attn_ff(bp, h):
        h = L.rnd(h + L.attention(bp["attn"], L.rms_norm(bp["attn_norm"]["g"], h), cfg["heads"], ang, mask))
        return L.rnd(h + L.feed_forward(bp["ff"], L.rms_norm(bp["ff_norm"]["g"], h)))

    skips = []
    for i in range(L.depth_of(p["first_half"])):
        skips.append(h)
        h = attn_ff(L.block(p["first_half"], i), h)
    for i in range(L.depth_of(p["second_half"])):
        bp = L.block(p["second_half"], i)
        h = attn_ff(bp, L.linear(bp["skip_proj"], torch.cat([h, skips.pop()], -1)))
    h = L.rms_norm(p["norm_out"]["g"], h)[:, 1:]
    return L.linear(p["proj_out"], h)
