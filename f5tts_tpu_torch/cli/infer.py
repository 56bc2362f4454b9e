"""Inference CLI of the PyTorch port (counterpart of ``f5tts_tpu/cli/infer.py``).

    python -m f5tts_tpu_torch.cli.infer --demo-tiny -t "Hello world." -o out.wav --device cpu
    python -m f5tts_tpu_torch.cli.infer --random-init --model F5TTS_Base -t "..." -o out.wav
    python -m f5tts_tpu_torch.cli.infer --ckpt-file f5_base.npz --vocoder-ckpt vocos.npz \\
        --vocab-file vocab.txt -r ref.wav -s "ref text." -t "..." -o out.wav

Checkpoints are the ``.npz`` params trees written by ``f5tpu-convert``. Runs on
``cuda`` by default; ``--device cpu`` runs the kernels' plain versions. TOML
configs, multi-voice tags and the BigVGAN vocoder are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def add_engine_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The model, sampler and device flags ``build_engine`` reads (shared
    with ``cli/speech_edit.py``)."""
    p.add_argument("-m", "--model", default="F5TTS_Base", choices=["F5TTS_Base", "F5TTS_Small"])
    p.add_argument("-p", "--ckpt-file", default="", help="DiT params .npz (f5tpu-convert output)")
    p.add_argument("--vocoder-ckpt", default="", help="Vocos params .npz (f5tpu-convert output)")
    p.add_argument("-v", "--vocab-file", default="", help="vocab.txt (one char per line)")
    p.add_argument("--demo-tiny", action="store_true", help="random-init tiny model (no checkpoint)")
    p.add_argument("--random-init", action="store_true", help="random-init at the real --model geometry")
    p.add_argument("--nfe", type=int, default=0, help="model evals per guidance branch; 0 = method default")
    p.add_argument("--method", default="ralston", choices=["euler", "midpoint", "heun", "ralston", "rk4"])
    p.add_argument("--cfg-strength", type=float, default=2.0)
    p.add_argument("--sway", type=float, default=-1.0)
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--cross-fade", type=float, default=0.15)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("f5tts_tpu_torch.cli.infer", description="F5-TTS inference (PyTorch / CUDA)")
    add_engine_args(p)
    p.add_argument("-r", "--ref-audio", default="", help="reference audio wav")
    p.add_argument("-s", "--ref-text", default="", help="reference transcript")
    p.add_argument("-t", "--gen-text", default="", help="text to synthesize")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--seed", type=int, default=None, help="noise seed")
    p.add_argument("--quality", default="default", choices=["default", "strict"],
                   help="strict: estimate each row's solver error and re-solve rows over the engine's threshold "
                        "with the exact reference recipe (euler, 32 steps)")
    return p


_LATIN_VOCAB = {" ": 0, **{chr(i): i - 31 for i in range(33, 127)}}


def text_vocab(args):
    """The tokenizer and the DiT's ``text_num_embeds``, as the JAX CLI picks
    them: ``--vocab-file``'s size when given; otherwise the Latin tokenizer,
    with 256 embeddings for ``--demo-tiny`` and the tokenizer's size (95) at
    the real geometry (``--random-init``)."""
    from f5tts_tpu_torch.text.tokenizer import Tokenizer

    if args.vocab_file:
        tok = Tokenizer.from_file(args.vocab_file)
        return tok, tok.vocab_size
    tok = Tokenizer(_LATIN_VOCAB)
    return tok, 256 if args.demo_tiny else tok.vocab_size


def build_engine(args):
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.models.convert import init_dit_numpy, init_vocos_numpy, load_params_npz
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.models.vocos import VocosConfig
    from f5tts_tpu_torch.ops.mel import MelConfig
    from f5tts_tpu_torch.sampling.euler import DEFAULT_NFE, SamplerConfig, default_time_grid, nfe_to_steps

    tok, n_embeds = text_vocab(args)
    if args.demo_tiny:
        mel_cfg = MelConfig(n_mels=20)
        dit_cfg = DiTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20,
                            text_num_embeds=n_embeds, text_dim=32, conv_layers=1, max_pos=1024)
        voc_cfg = VocosConfig(input_channels=20, dim=48, intermediate_dim=96, num_layers=2)
        dit_params = init_dit_numpy(dit_cfg, seed=0)
        voc_params = init_vocos_numpy(voc_cfg, seed=1)
    else:
        mel_cfg = MelConfig()
        base = DiTConfig.small() if args.model == "F5TTS_Small" else DiTConfig.base()
        dit_cfg = dataclasses.replace(base, text_num_embeds=n_embeds)
        voc_cfg = VocosConfig()
        if args.random_init:
            dit_params = init_dit_numpy(dit_cfg, seed=0)
            voc_params = init_vocos_numpy(voc_cfg, seed=1)
        else:
            if not (args.ckpt_file and args.vocoder_ckpt and args.vocab_file):
                sys.exit("need --ckpt-file, --vocoder-ckpt and --vocab-file (or --demo-tiny / --random-init)")
            dit_params = load_params_npz(args.ckpt_file)
            voc_params = load_params_npz(args.vocoder_ckpt)
    nfe = args.nfe or DEFAULT_NFE[args.method]
    steps = nfe_to_steps(nfe, args.method)
    engine_cfg = EngineConfig(
        mel=mel_cfg, vocoder=voc_cfg,
        sampler=SamplerConfig(steps=steps, method=args.method, cfg_strength=args.cfg_strength,
                              sway_sampling_coef=args.sway, time_grid=default_time_grid(args.method, steps)),
        compute_dtype=args.dtype, cross_fade_duration=args.cross_fade, speed=args.speed,
    )
    return TTSEngine(dit_params, dit_cfg, voc_params, tok, engine_cfg, device=args.device)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if not args.gen_text:
        sys.exit("no --gen-text given")

    from f5tts_tpu_torch.audio.io import read_wav, write_wav
    from f5tts_tpu_torch.audio.preprocess import clip_ref_audio, ensure_sentence_punctuation

    if args.ref_audio:
        ref_audio, ref_sr = read_wav(args.ref_audio)
        ref_audio = clip_ref_audio(ref_audio, ref_sr)
    elif args.demo_tiny or args.random_init:
        ref_sr = 24000
        ref_audio = (np.sin(2 * np.pi * 220 * np.arange(ref_sr) / ref_sr) * 0.1).astype(np.float32)
    else:
        sys.exit("need --ref-audio")
    ref_text = ensure_sentence_punctuation(args.ref_text or "reference audio.")

    engine = build_engine(args)
    wave, sr, _ = engine.synthesize(
        args.gen_text, ref_audio, ref_sr, ref_text,
        speed=args.speed, nfe_step=args.nfe or None, cfg_strength=args.cfg_strength,
        seed=args.seed, cross_fade_duration=args.cross_fade, quality=args.quality,
    )
    write_wav(args.output, wave, sr)
    print(f"wrote {args.output}: {len(wave) / sr:.2f}s at {sr} Hz")


if __name__ == "__main__":
    main()
