"""F5-TTS's DiT velocity prediction (float32): text and input embeddings,
``depth`` AdaLN-Zero blocks with head-0 RoPE, AdaLN-Zero final norm,
projection to mel.

``forward(p, cfg, x, cond, text_emb, t, drop, mask)`` with ``drop`` the
per-row CFG drop (audio cond and text) and ``mask`` each row's frames.
"""

from __future__ import annotations

import torch.nn.functional as F

from benchmark.reference import layers as L


def forward(p, cfg, x, cond, text_emb, t, drop, mask):
    temb = L.time_embedding(p["time_embed"], t)
    h = L.input_embed(p["input_embed"], x, cond, text_emb, drop, mask)
    ang = L.rope_angles(h.shape[1], cfg["dim_head"], h.device)
    blocks = p["blocks"]
    for i in range(L.depth_of(blocks)):
        bp = L.block(blocks, i)
        mod = L.linear(bp["attn_norm"]["linear"], F.silu(temb))
        shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = (m[:, None] for m in mod.chunk(6, -1))
        a = L.attention(bp["attn"], L.layer_norm(h) * (1 + scale_a) + shift_a, cfg["heads"], ang, mask)
        h = L.rnd(h + gate_a * a)
        h = L.rnd(h + gate_f * L.feed_forward(bp["ff"], L.layer_norm(h) * (1 + scale_f) + shift_f))
    scale, shift = (m[:, None] for m in L.linear(p["norm_out"]["linear"], F.silu(temb)).chunk(2, -1))
    return L.linear(p["proj_out"], L.layer_norm(h) * (1 + scale) + shift)
