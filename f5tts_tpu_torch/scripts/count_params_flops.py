"""Parameter and MAC counts of the F5-TTS, E2-TTS and Vocos configurations
(counterpart of ``scripts/count_params_flops.py``).

The parameters are counted on shape-only trees (``init_*_numpy(seed=None)``:
nothing drawn, nothing materialized); the MACs per layer are analytic, in the
reference's convention (thop counts multiply-accumulates).

    python -m f5tts_tpu_torch.scripts.count_params_flops [--seconds 20] [--text-tokens 150]
"""

from __future__ import annotations

import argparse


def dit_flops(cfg, n_frames: int) -> float:
    """MACs per forward (batch 1), thop convention."""
    d, inner = cfg.dim, cfg.heads * cfg.dim_head
    tokens = n_frames
    per_block = (
        tokens * d * 6 * d  # adaln modulation
        + 4 * tokens * d * inner  # qkvo
        + 2 * tokens * tokens * cfg.dim_head * cfg.heads  # qk + av
        + 2 * tokens * d * d * cfg.ff_mult  # ff
    )
    text = cfg.conv_layers * tokens * (cfg.text_dim * 7 + 2 * cfg.text_dim * cfg.text_dim * 2)
    input_embed = tokens * (2 * cfg.mel_dim + cfg.text_dim) * d + 2 * tokens * d * (d // 16) * 31
    out = tokens * d * 2 * d + tokens * d * cfg.mel_dim
    return cfg.depth * per_block + text + input_embed + out


def counts() -> list[tuple[str, object, int]]:
    """``(name, config, parameters)`` of every model the script reports."""
    from f5tts_tpu_torch.models.convert import init_dit_numpy, init_unett_numpy, init_vocos_numpy
    from f5tts_tpu_torch.models.dit import DiTConfig, param_count
    from f5tts_tpu_torch.models.unett import UNetTConfig
    from f5tts_tpu_torch.models.vocos import VocosConfig

    return [(name, cfg, param_count(init(cfg, seed=None))) for name, init, cfg in [
        ("F5TTS_Base (DiT)", init_dit_numpy, DiTConfig.base()),
        ("F5TTS_Small (DiT)", init_dit_numpy, DiTConfig.small()),
        ("E2TTS_Base (UNetT)", init_unett_numpy, UNetTConfig.base()),
        ("Vocos", init_vocos_numpy, VocosConfig()),
    ]]


def main(argv=None) -> None:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.count_params_flops")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--text-tokens", type=int, default=150)
    args = p.parse_args(argv)
    frames = int(args.seconds * 24000 / 256)
    for name, cfg, n in counts():
        line = f"{name}: {n/1e6:.1f}M params"
        if hasattr(cfg, "depth") and hasattr(cfg, "ff_mult") and name.startswith(("F5", "E2")) and "DiT" in name:
            line += f", {dit_flops(cfg, frames)/1e9:.1f} GMACs/fwd @ {args.seconds:.0f}s"
        print(line)


if __name__ == "__main__":
    main()
