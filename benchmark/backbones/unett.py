"""E2-TTS's UNetT (``model/backbones/unett.py``) with concat skips."""

from benchmark import weights as W
from benchmark.backbones._common import embed_flops_per_frame, embeddings, time_flops


def layout(m):
    d, inner, half = m["dim"], m["heads"] * m["dim_head"], m["depth"] // 2

    def blocks(skip):
        p = {"attn_norm": {"g": W.const((half, d), 1.0)},
             "attn": {k: W.linear(d, inner, depth=half) for k in ("to_q", "to_k", "to_v")}
             | {"to_out": W.linear(inner, d, depth=half)},
             "ff_norm": {"g": W.const((half, d), 1.0)},
             "ff": {"in": W.linear(d, d * m["ff_mult"], depth=half), "out": W.linear(d * m["ff_mult"], d, depth=half)}}
        if skip:
            p["skip_proj"] = W.linear(2 * d, d, bias=False, depth=half)
        return p

    return {**embeddings(m), "first_half": blocks(False), "second_half": blocks(True),
            "norm_out": {"g": W.const((d,), 1.0)}, "proj_out": W.linear(d, m["mel_dim"])}


def program(m):
    from f5tts_tpu_torch.models.unett import UNetTConfig, unett_embed, unett_forward

    keys = ("dim", "depth", "heads", "dim_head", "ff_mult", "mel_dim", "text_num_embeds", "text_dim", "conv_layers")
    return UNetTConfig(**{k: m[k] for k in keys}, skip_connect_type=m["skip_connect_type"]), unett_forward, unett_embed


def attention(m, n):
    """The blocks see the time token in front: ``n + 1`` positions."""
    return m["depth"], m["heads"], n + 1, m["dim_head"]


def row_forward_flops(m, n):
    """Embeddings per frame; per position (``n + 1``) the blocks' projections,
    feed-forward, attention products and the second half's skip
    projections; the output projection per frame; the time embedding."""
    d, inner, L = m["dim"], m["heads"] * m["dim_head"], m["depth"]
    per_pos = L * (2 * 4 * d * inner + 2 * 2 * d * d * m["ff_mult"] + 4 * (n + 1) * inner) + (L // 2) * 2 * 2 * d * d
    return (embed_flops_per_frame(m) + 2 * d * m["mel_dim"]) * n + per_pos * (n + 1) + time_flops(m)
