"""Speech-editing CLI of the port (counterpart of ``f5tts_tpu/cli/speech_edit.py``):
regenerate spans of an utterance so it says new text; frames outside the
spans are kept verbatim. ``--fix-durations`` gives the spans new lengths. Span
times come from the user.

    python -m f5tts_tpu_torch.cli.speech_edit --demo-tiny --device cpu --audio in.wav \\
        --target-text "the new transcript." --parts 0.5,1.0 -o edited.wav

Runs on ``cuda`` by default; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from f5tts_tpu_torch.cli.infer import add_engine_args

    p = argparse.ArgumentParser("f5tts_tpu_torch.cli.speech_edit", description="speech editing (PyTorch / CUDA)")
    p.add_argument("--audio", required=True, help="wav to edit")
    p.add_argument("--target-text", required=True, help="full transcript after the edit")
    p.add_argument("--parts", required=True,
                   help="semicolon list of start,end seconds to regenerate, e.g. '1.42,2.44;4.04,4.9'")
    p.add_argument("--fix-durations", default="", help="semicolon list of new span lengths in seconds")
    p.add_argument("-o", "--output", default="edited.wav")
    p.add_argument("--seed", type=int, default=None)
    add_engine_args(p)
    args = p.parse_args(argv)

    try:
        parts = [tuple(float(x) for x in span.split(",")) for span in args.parts.split(";") if span]
    except ValueError:
        sys.exit(f"bad --parts {args.parts!r}; expected 'start,end;start,end' seconds")
    fixes = [float(x) for x in args.fix_durations.split(";") if x] or None
    if fixes is not None and len(fixes) != len(parts):
        sys.exit("--fix-durations must have one entry per edit span")

    from f5tts_tpu_torch.audio.io import read_wav, write_wav
    from f5tts_tpu_torch.cli.infer import build_engine

    engine = build_engine(args)
    audio, sr = read_wav(args.audio)
    wave, out_sr, _ = engine.speech_edit(audio, sr, args.target_text, parts, fixes, steps=args.nfe or None,
                                         cfg_strength=args.cfg_strength, seed=args.seed)
    write_wav(args.output, wave, out_sr)
    print(f"wrote {args.output}: {len(wave) / out_sr:.2f}s")


if __name__ == "__main__":
    main()
