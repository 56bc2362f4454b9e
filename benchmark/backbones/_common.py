"""Pieces the DiT and the UNetT share: the text and input embeddings."""

from benchmark import weights as W


def convnext_v2(dim, inter, depth):
    return {"dwconv": W.conv1d(dim, dim, 7, groups=dim, depth=depth), "norm_w": W.const((depth, dim), 1.0),
            "norm_b": W.const((depth, dim), 0.0), "pw1": W.linear(dim, inter, depth=depth),
            "grn_gamma": W.const((depth, inter), 0.0), "grn_beta": W.const((depth, inter), 0.0),
            "pw2": W.linear(inter, dim, depth=depth)}


def embeddings(m):
    return {
        "time_embed": {"mlp1": W.linear(256, m["dim"]), "mlp2": W.linear(m["dim"], m["dim"])},
        "text_embed": {"embed": {"w": ((m["text_num_embeds"] + 1, m["text_dim"]), ("n",))}}
        | ({"blocks": convnext_v2(m["text_dim"], 2 * m["text_dim"], m["conv_layers"])} if m["conv_layers"] else {}),
        "input_embed": {"proj": W.linear(2 * m["mel_dim"] + m["text_dim"], m["dim"]),
                        "conv_pos": {"conv1": W.conv1d(m["dim"], m["dim"], 31, 16),
                                     "conv2": W.conv1d(m["dim"], m["dim"], 31, 16)}},
    }


def embed_flops_per_frame(m):
    """Input projection and the two grouped k-31 convolutions (16 groups)."""
    return 2 * (2 * m["mel_dim"] + m["text_dim"]) * m["dim"] + 2 * 2 * 31 * (m["dim"] // 16) * m["dim"]


def time_flops(m):
    return 2 * (256 * m["dim"] + m["dim"] * m["dim"])
