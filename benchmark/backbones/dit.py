"""F5-TTS's DiT (``model/backbones/dit.py``)."""

from benchmark import weights as W
from benchmark.backbones._common import embed_flops_per_frame, embeddings, time_flops


def layout(m):
    d, inner, L = m["dim"], m["heads"] * m["dim_head"], m["depth"]
    return {**embeddings(m),
            "blocks": {"attn_norm": {"linear": W.linear(d, 6 * d, depth=L)},
                       "attn": {k: W.linear(d, inner, depth=L) for k in ("to_q", "to_k", "to_v")}
                       | {"to_out": W.linear(inner, d, depth=L)},
                       "ff": {"in": W.linear(d, d * m["ff_mult"], depth=L), "out": W.linear(d * m["ff_mult"], d, depth=L)}},
            "norm_out": {"linear": W.linear(d, 2 * d)},
            "proj_out": W.linear(d, m["mel_dim"])}


def program(m):
    """The program's config object and its forward and embedding functions."""
    from f5tts_tpu_torch.models.dit import DiTConfig, dit_embed, dit_forward

    keys = ("dim", "depth", "heads", "dim_head", "ff_mult", "mel_dim", "text_num_embeds", "text_dim", "conv_layers")
    return DiTConfig(**{k: m[k] for k in keys}), dit_forward, dit_embed


def attention(m, n):
    """(layers, heads, sequence length, head dim) of one forward at ``n`` frames."""
    return m["depth"], m["heads"], n, m["dim_head"]


def row_forward_flops(m, n):
    """FLOPs of one row through one forward at ``n`` frames: per frame the
    embeddings, the blocks' six projections and feed-forward, the attention's
    two products (``4 n * heads * d``) and the output projection; per row the
    time embedding and every AdaLN modulation (once per row, from time)."""
    d, inner, L = m["dim"], m["heads"] * m["dim_head"], m["depth"]
    per_frame = (embed_flops_per_frame(m) + L * (2 * 4 * d * inner + 2 * 2 * d * d * m["ff_mult"] + 4 * n * inner)
                 + 2 * d * m["mel_dim"])
    per_row = time_flops(m) + L * 2 * d * 6 * d + 2 * d * 2 * d
    return per_frame * n + per_row
