"""Inference CLI of the PyTorch port (counterpart of ``f5tts_tpu/cli/infer.py``).

    python -m f5tts_tpu_torch.cli.infer --demo-tiny -t "Hello world." -o out.wav --device cpu
    python -m f5tts_tpu_torch.cli.infer --random-init --model E2TTS_Base -t "..." -o out.wav
    python -m f5tts_tpu_torch.cli.infer --ckpt-file model.safetensors --vocoder-ckpt vocos.bin \\
        --vocab-file vocab.txt -r ref.wav -s "ref text." -t "..." -o out.wav
    python -m f5tts_tpu_torch.cli.infer -c examples/basic.toml --device cpu

Models: ``F5TTS_Base``/``F5TTS_Small`` (DiT) and ``E2TTS_Base``/``E2TTS_Small``
(UNetT); vocoders: ``vocos`` and ``bigvgan`` (with the ``bigvgan`` mel flavor).
Checkpoints: torch ``.pt``/``.safetensors`` files, ``.npz`` params trees
(``cli/convert.py``) or a ``Trainer`` directory. A TOML config (``-c``) sets
any flag left at its default and registers ``[voices.NAME]`` reference voices
for ``[name]`` tags in the text. Runs on ``cuda`` by default; ``--device cpu``
runs the kernels' plain versions. ``--demo-tiny`` builds a tiny random model
of the ``--model`` family (the JAX CLI's is always the DiT).
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np


def add_engine_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The model, sampler and device flags ``build_engine`` reads (shared
    with ``cli/speech_edit.py`` and ``cli/infer_batch.py``)."""
    p.add_argument("-m", "--model", default="F5TTS_Base",
                   choices=["F5TTS_Base", "F5TTS_Small", "E2TTS_Base", "E2TTS_Small"])
    p.add_argument("-p", "--ckpt-file", default="",
                   help="backbone checkpoint: torch .pt/.safetensors, .npz params tree or a Trainer directory")
    p.add_argument("-v", "--vocab-file", default="", help="vocab.txt (one char per line)")
    p.add_argument("--vocoder", default="vocos", choices=["vocos", "bigvgan"],
                   help="vocoder family (bigvgan implies the bigvgan mel flavor)")
    p.add_argument("--vocoder-ckpt", default="",
                   help="vocoder checkpoint: vocos pytorch_model.bin / bigvgan generator, or an .npz params tree")
    p.add_argument("--demo-tiny", action="store_true", help="random-init tiny model (no checkpoint)")
    p.add_argument("--random-init", action="store_true", help="random-init at the real --model geometry")
    p.add_argument("--nfe", type=int, default=0, help="model evals per guidance branch; 0 = method default")
    p.add_argument("--method", default="auto", choices=["auto", "euler", "midpoint", "heun", "ralston", "rk4"],
                   help="ODE integrator; auto = ralston unless --cfg-interval/--cfg-cache/--time-grid asks for euler")
    p.add_argument("--cfg-strength", type=float, default=2.0)
    p.add_argument("--sway", type=float, default=-1.0)
    p.add_argument("--time-grid", default="", help="comma list of ODE time knots 0..1 (overrides --nfe/--sway)")
    p.add_argument("--cfg-interval", default="", help="lo,hi: guidance only on steps with t in [lo, hi)")
    p.add_argument("--cfg-cache", type=int, default=1,
                   help="refresh the null branch every k-th step and reuse it in between; 1 = off")
    p.add_argument("--quality", default="default", choices=["default", "strict"],
                   help="strict: estimate each row's solver error and re-solve rows over the engine's threshold "
                        "with the exact reference recipe (euler, 32 steps)")
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--cross-fade", type=float, default=0.15)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("f5tts_tpu_torch.cli.infer", description="F5-TTS / E2-TTS inference (PyTorch / CUDA)")
    p.add_argument("-c", "--config", default=None, help="TOML config file (flags override)")
    add_engine_args(p)
    p.add_argument("-r", "--ref-audio", default="", help="reference audio wav")
    p.add_argument("-s", "--ref-text", default="", help="reference transcript")
    p.add_argument("-t", "--gen-text", default="", help="text to synthesize")
    p.add_argument("-f", "--gen-file", default="", help="file with the text to synthesize")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--seed", type=int, default=None, help="noise seed")
    p.add_argument("--fix-duration", type=float, default=None, help="total duration in seconds (reference included)")
    p.add_argument("--remove-silence", action="store_true", help="collapse long silences in the output")
    return p


_PARSER = build_argparser()


def load_config(args, parser: argparse.ArgumentParser = _PARSER):
    """Apply ``args.config`` (TOML): every key whose flag is still at
    ``parser``'s default takes the file's value; ``[voices.NAME]`` tables go to
    ``args.voices``. Relative asset paths resolve against the file's
    directory when they do not exist as given."""
    args.voices = {}
    if not getattr(args, "config", None):
        return args
    import tomllib

    with open(args.config, "rb") as f:
        cfg = tomllib.load(f)
    args.voices = cfg.pop("voices", {})
    for k, v in cfg.items():
        k = k.replace("-", "_")
        if hasattr(args, k) and parser.get_default(k) == getattr(args, k):
            setattr(args, k, v)
    base = os.path.dirname(os.path.abspath(args.config))

    def resolve(path):
        if path and not os.path.isabs(path) and not os.path.exists(path):
            cand = os.path.join(base, path)
            if os.path.exists(cand):
                return cand
        return path

    for k in ("ckpt_file", "vocab_file", "vocoder_ckpt", "ref_audio", "gen_file"):
        if hasattr(args, k):
            setattr(args, k, resolve(getattr(args, k)))
    for spec in args.voices.values():
        if "ref_audio" in spec:
            spec["ref_audio"] = resolve(spec["ref_audio"])
    return args


_LATIN_VOCAB = {" ": 0, **{chr(i): i - 31 for i in range(33, 127)}}


def text_vocab(args):
    """The tokenizer and the backbone's ``text_num_embeds``, as the JAX CLI
    picks them: ``--vocab-file``'s size when given; otherwise the Latin
    tokenizer, with 256 embeddings for ``--demo-tiny`` and the tokenizer's
    size (95) at the real geometry (``--random-init``)."""
    from f5tts_tpu_torch.text.tokenizer import Tokenizer

    if args.vocab_file:
        tok = Tokenizer.from_file(args.vocab_file)
        return tok, tok.vocab_size
    tok = Tokenizer(_LATIN_VOCAB)
    return tok, 256 if args.demo_tiny else tok.vocab_size


def build_engine(args):
    from f5tts_tpu_torch.cli.convert import backbone_config
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.models import convert as C
    from f5tts_tpu_torch.models.bigvgan import BigVGANConfig
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.models.unett import UNetTConfig, unett_embed, unett_forward
    from f5tts_tpu_torch.models.vocos import VocosConfig
    from f5tts_tpu_torch.ops.mel import MelConfig
    from f5tts_tpu_torch.sampling.euler import (DEFAULT_NFE, SamplerConfig, default_time_grid, nfe_to_steps,
                                                parse_cfg_interval)

    tok, n_embeds = text_vocab(args)
    e2 = args.model.startswith("E2TTS")
    use_bigvgan = args.vocoder == "bigvgan"
    flavor = "bigvgan" if use_bigvgan else "vocos"
    if args.demo_tiny:
        mel_cfg = MelConfig(n_mels=20, flavor=flavor)
        tiny = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=n_embeds,
                    text_dim=32, conv_layers=1, max_pos=1024)
        dit_cfg = UNetTConfig(**tiny) if e2 else DiTConfig(**tiny)
        voc_cfg = VocosConfig(input_channels=20, dim=48, intermediate_dim=96, num_layers=2)
        bcfg = BigVGANConfig.demo_tiny()
    else:
        mel_cfg = MelConfig(flavor=flavor)
        dit_cfg = backbone_config(args.model, n_embeds)
        voc_cfg = VocosConfig()
        bcfg = BigVGANConfig(mel_dim=mel_cfg.n_mels)
    if args.demo_tiny or args.random_init:
        dit_params = C.init_unett_numpy(dit_cfg, seed=0) if e2 else C.init_dit_numpy(dit_cfg, seed=0)
        voc_params = C.init_bigvgan_numpy(bcfg, seed=1) if use_bigvgan else C.init_vocos_numpy(voc_cfg, seed=1)
    else:
        if not (args.ckpt_file and args.vocoder_ckpt and args.vocab_file):
            sys.exit("need --ckpt-file, --vocoder-ckpt and --vocab-file (or --demo-tiny / --random-init)")
        load = C.load_e2_checkpoint if e2 else C.load_f5_checkpoint
        dit_params = load(args.ckpt_file, dit_cfg)
        voc_params = (C.load_bigvgan_checkpoint(args.vocoder_ckpt, bcfg) if use_bigvgan
                      else C.load_vocos_checkpoint(args.vocoder_ckpt, voc_cfg))

    method = args.method
    if method == "auto":  # the euler-only knobs pick euler; else the serving default
        method = "euler" if (args.cfg_interval or args.cfg_cache > 1 or args.time_grid) else "ralston"
    steps = nfe_to_steps(args.nfe or DEFAULT_NFE[method], method)
    sampler = SamplerConfig(
        steps=steps, method=method, cfg_strength=args.cfg_strength, sway_sampling_coef=args.sway,
        time_grid=(tuple(float(v) for v in args.time_grid.split(",")) if args.time_grid
                   else default_time_grid(method, steps)),
        cfg_interval=parse_cfg_interval(args.cfg_interval) if args.cfg_interval else (0.0, 1.0),
        cfg_cache_period=args.cfg_cache)
    engine_cfg = EngineConfig(
        mel=mel_cfg, vocoder=voc_cfg, sampler=sampler, compute_dtype=args.dtype,
        cross_fade_duration=args.cross_fade, speed=args.speed,
        **({"vocoder_type": "bigvgan", "bigvgan": bcfg} if use_bigvgan else {}))
    fns = {"forward_fn": unett_forward, "embed_fn": unett_embed} if e2 else {}
    return TTSEngine(dit_params, dit_cfg, voc_params, tok, engine_cfg, device=args.device, **fns)


def demo_ref(sr: int = 24000) -> np.ndarray:
    """The 1-s 220 Hz tone that stands in for a reference clip with random weights."""
    return (np.sin(2 * np.pi * 220 * np.arange(sr) / sr) * 0.1).astype(np.float32)


def main(argv=None):
    args = load_config(_PARSER.parse_args(argv))
    gen_text = args.gen_text
    if args.gen_file:
        with open(args.gen_file, encoding="utf-8") as f:
            gen_text = f.read()
    if not gen_text:
        sys.exit("no --gen-text/--gen-file given")

    from f5tts_tpu_torch.audio.io import read_wav, write_wav
    from f5tts_tpu_torch.audio.preprocess import clip_ref_audio, ensure_sentence_punctuation, remove_long_silences
    from f5tts_tpu_torch.audio.stitch import crossfade_concat
    from f5tts_tpu_torch.text.chunker import split_style_segments

    if args.ref_audio:
        ref_audio, ref_sr = read_wav(args.ref_audio)
        ref_audio = clip_ref_audio(ref_audio, ref_sr)
    elif args.demo_tiny or args.random_init:
        ref_sr, ref_audio = 24000, demo_ref()
    else:
        sys.exit("need --ref-audio")
    ref_text = ensure_sentence_punctuation(args.ref_text or "reference audio.")

    engine = build_engine(args)
    voices = {"main": (ref_audio, ref_sr, ref_text)}  # [voices.NAME] tables of the TOML config
    for name, spec in args.voices.items():
        v_audio, v_sr = read_wav(spec["ref_audio"])
        voices[name] = (clip_ref_audio(v_audio, v_sr), v_sr, ensure_sentence_punctuation(spec.get("ref_text", "")))
    known = {v.lower() for v in voices} | {"regular"}
    for m in re.finditer(r"[\[{]([\w.-]+)[\]}]", gen_text):
        if m.group(1).lower() not in known:
            print(f"note: [{m.group(1)}] is not a known voice; leaving it as text", file=sys.stderr)

    waves, sr = [], 24000
    for voice, seg_text in split_style_segments(gen_text, voices, default="main"):
        v_audio, v_sr, v_text = voices[voice]
        wave, sr, _ = engine.synthesize(
            seg_text, v_audio, v_sr, v_text, speed=args.speed, fix_duration_secs=args.fix_duration,
            nfe_step=args.nfe or None, cfg_strength=args.cfg_strength, seed=args.seed,
            cross_fade_duration=args.cross_fade, quality=args.quality)
        waves.append(wave)
    if not waves:
        sys.exit("no synthesizable text left after voice-tag parsing")
    final = crossfade_concat(waves, 0.0) if len(waves) > 1 else waves[0]
    if args.remove_silence:
        final = remove_long_silences(final, sr)
    write_wav(args.output, final, sr)
    print(f"wrote {args.output}: {len(final) / sr:.2f}s at {sr} Hz")


if __name__ == "__main__":
    main()
