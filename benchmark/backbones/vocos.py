"""Vocos (charactr/vocos-mel-24khz): ConvNeXt-V1 backbone and iSTFT head."""

from benchmark import weights as W


def layout(v):
    d, L = v["dim"], v["num_layers"]
    return {"embed": W.conv1d(v["input_channels"], d, 7), "norm_w": W.const((d,), 1.0), "norm_b": W.const((d,), 0.0),
            "blocks": {"dwconv": W.conv1d(d, d, 7, groups=d, depth=L), "norm_w": W.const((L, d), 1.0),
                       "norm_b": W.const((L, d), 0.0), "pw1": W.linear(d, v["intermediate_dim"], depth=L),
                       "pw2": W.linear(v["intermediate_dim"], d, depth=L), "gamma": W.const((L, d), 1.0 / L)},
            "final_norm_w": W.const((d,), 1.0), "final_norm_b": W.const((d,), 0.0),
            "head": W.linear(d, v["n_fft"] + 2)}


def program(v):
    """The program's engine options for this vocoder (``EngineConfig`` keywords)."""
    from f5tts_tpu_torch.models.vocos import VocosConfig

    return {"vocoder_type": "vocos",
            "vocoder": VocosConfig(**{k: v[k] for k in ("input_channels", "dim", "intermediate_dim", "num_layers",
                                                        "n_fft", "hop_length")})}


def frame_flops(v):
    """Per mel frame: the embedding conv, each block's depthwise conv and two
    projections, the head, and the inverse DFT's two products."""
    d, i = v["dim"], v["intermediate_dim"]
    nf = v["n_fft"] // 2 + 1
    return (2 * 7 * v["input_channels"] * d + v["num_layers"] * (2 * 7 * d + 2 * 2 * d * i)
            + 2 * d * (v["n_fft"] + 2) + 2 * 2 * nf * v["n_fft"])
