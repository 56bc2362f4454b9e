"""CSV batch inference of the port (counterpart of ``f5tts_tpu/cli/infer_batch.py``):
rows that share a reference voice are planned against it once, and the rows
of every pending request go through the engine's batched path together
(``synthesize_rows``), flushed whenever they fill the largest batch bucket.

CSV columns: ``text`` (required), optional ``prompt_path``, ``prompt_text``,
``language``, ``id``. Writes ``<out_dir>/[<language>/]<id|row>.wav``.

    python -m f5tts_tpu_torch.cli.infer_batch --csv rows.csv --demo-tiny --device cpu --out-dir out
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from collections import defaultdict


def build_argparser() -> argparse.ArgumentParser:
    from f5tts_tpu_torch.cli.infer import add_engine_args

    p = argparse.ArgumentParser("f5tts_tpu_torch.cli.infer_batch", description="CSV batch inference (PyTorch / CUDA)")
    p.add_argument("--csv", required=True)
    p.add_argument("--out-dir", default="batch_out")
    p.add_argument("--ref-audio", default="", help="reference wav for rows without a prompt_path")
    p.add_argument("--ref-text", default="", help="reference transcript for rows without a prompt_text")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--fix-duration", type=float, default=None)
    p.add_argument("-c", "--config", default=None, help="TOML config file (flags override)")
    return add_engine_args(p)


def main(argv=None):
    from f5tts_tpu_torch.audio.io import read_wav, write_wav
    from f5tts_tpu_torch.audio.preprocess import clip_ref_audio, ensure_sentence_punctuation
    from f5tts_tpu_torch.cli.infer import build_engine, demo_ref, load_config

    parser = build_argparser()
    args = load_config(parser.parse_args(argv), parser)
    with open(args.csv, encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        sys.exit("empty csv")

    engine = build_engine(args)
    os.makedirs(args.out_dir, exist_ok=True)
    groups: dict[str, list[int]] = defaultdict(list)  # rows by reference voice
    for i, row in enumerate(rows):
        groups[row.get("prompt_path") or args.ref_audio].append(i)

    top = engine.cfg.batch_buckets[-1]
    pending: list[tuple[int, object]] = []

    def flush():
        all_rows = [r for _, plan in pending for r in plan.rows]
        results = engine.synthesize_rows(all_rows)
        pos = 0
        for i, plan in pending:
            wave, sr, _ = engine.finalize_request(plan, results[pos : pos + len(plan.rows)])
            pos += len(plan.rows)
            row = rows[i]
            out_dir = os.path.join(args.out_dir, row["language"]) if row.get("language") else args.out_dir
            os.makedirs(out_dir, exist_ok=True)
            out = os.path.join(out_dir, f"{row.get('id') or f'row{i:05d}'}.wav")
            write_wav(out, wave, sr)
            print(f"wrote {out} ({len(wave) / sr:.2f}s)")
        pending.clear()

    for ref_path, idxs in groups.items():
        if ref_path:
            ref_audio, ref_sr = read_wav(ref_path)
            ref_audio = clip_ref_audio(ref_audio, ref_sr)
            ref_text = rows[idxs[0]].get("prompt_text") or args.ref_text
        elif args.demo_tiny or args.random_init:
            ref_sr, ref_audio = 24000, demo_ref()
            ref_text = args.ref_text or "reference audio."
        else:
            sys.exit("row missing prompt_path and no --ref-audio given")
        ref_text = ensure_sentence_punctuation(ref_text)
        for i in idxs:
            pending.append((i, engine.prepare_request(
                rows[i]["text"], ref_audio, ref_sr, ref_text, speed=args.speed, nfe_step=args.nfe or None,
                cfg_strength=args.cfg_strength, seed=args.seed, cross_fade_duration=args.cross_fade,
                fix_duration_secs=args.fix_duration, quality=args.quality)))
            if sum(len(plan.rows) for _, plan in pending) >= top:
                flush()
    if pending:
        flush()


if __name__ == "__main__":
    main()
