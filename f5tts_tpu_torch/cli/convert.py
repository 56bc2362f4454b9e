"""Checkpoint conversion CLI of the port (counterpart of ``f5tts_tpu/cli/convert.py``):
a torch checkpoint, or a checkpoint directory of the port's ``Trainer``, to
the ``.npz`` params tree that every loader of both packages reads. It writes
the same keys and arrays as the JAX package's ``f5tpu-convert``, without JAX.

    python -m f5tts_tpu_torch.cli.convert --ckpt model_1200000.safetensors --model F5TTS_Base \\
        --vocab vocab.txt --out f5_base.npz
    python -m f5tts_tpu_torch.cli.convert --ckpt runs/ckpts --model F5TTS_Base --vocab vocab.txt \\
        --out f5_trained.npz                       # a Trainer directory (EMA)
    python -m f5tts_tpu_torch.cli.convert --vocoder-ckpt pytorch_model.bin --vocoder-out vocos.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def backbone_config(model: str, vocab_size: int):
    """The config of a registry name at a vocabulary size: ``F5TTS_Base`` |
    ``F5TTS_Small`` (DiT) or ``E2TTS_Base`` | ``E2TTS_Small`` (UNetT)."""
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.models.unett import UNetTConfig

    if model.startswith("E2TTS"):
        base = UNetTConfig.small() if model == "E2TTS_Small" else UNetTConfig.base()
    else:
        base = DiTConfig.small() if model == "F5TTS_Small" else DiTConfig.base()
    return dataclasses.replace(base, text_num_embeds=vocab_size)


def _size(tree) -> int:
    if isinstance(tree, dict):
        return sum(_size(v) for v in tree.values())
    return 0 if tree is None else tree.size


def main(argv=None):
    p = argparse.ArgumentParser("f5tts_tpu_torch.cli.convert", description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", default="", help="torch .pt/.safetensors or a Trainer checkpoint directory")
    p.add_argument("--model", default="F5TTS_Base", help="F5TTS_Base | F5TTS_Small | E2TTS_Base | E2TTS_Small")
    p.add_argument("--vocab", default="", help="vocab.txt (sets text_num_embeds)")
    p.add_argument("--out", default="", help="output .npz for the backbone")
    p.add_argument("--raw-weights", action="store_true", help="Trainer directory: export the raw params, not the EMA")
    p.add_argument("--vocoder-ckpt", default="", help="vocos torch checkpoint")
    p.add_argument("--vocoder-out", default="", help="output .npz for the vocoder")
    args = p.parse_args(argv)
    if not (args.ckpt or args.vocoder_ckpt):
        p.error("nothing to convert: pass --ckpt and/or --vocoder-ckpt")

    from f5tts_tpu_torch.models import convert as C

    if args.ckpt:
        if not args.out:
            p.error("--ckpt needs --out")
        if not args.vocab:
            p.error("--ckpt needs --vocab (vocab size fixes the text embedding)")
        from f5tts_tpu_torch.text.tokenizer import Tokenizer

        cfg = backbone_config(args.model, Tokenizer.from_file(args.vocab).vocab_size)
        if os.path.isdir(args.ckpt):
            params = C.load_trained_checkpoint(args.ckpt, use_ema=not args.raw_weights)
        elif args.model.startswith("E2TTS"):
            params = C.convert_e2_unett(C.load_torch_state_dict(args.ckpt), cfg)
        else:
            params = C.convert_f5_dit(C.load_torch_state_dict(args.ckpt), cfg)
        C.save_params_npz(args.out, params)
        print(f"wrote {args.out}: {args.model} ({_size(params) / 1e6:.1f}M params)")

    if args.vocoder_ckpt:
        if not args.vocoder_out:
            p.error("--vocoder-ckpt needs --vocoder-out")
        C.save_params_npz(args.vocoder_out, C.load_vocos_checkpoint(args.vocoder_ckpt))
        print(f"wrote {args.vocoder_out}: vocos")


if __name__ == "__main__":
    main()
