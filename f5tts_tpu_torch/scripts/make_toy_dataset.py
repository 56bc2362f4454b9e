"""A synthetic toy dataset (``manifest.jsonl`` + mel ``.npy`` files), so the
training pipeline runs end to end without real audio (counterpart of
``scripts/make_toy_dataset.py``; the same files for the same ``--seed``).

    python -m f5tts_tpu_torch.scripts.make_toy_dataset --out /tmp/toy_ds --items 64
    python -m f5tts_tpu_torch.cli.train --dataset-dir /tmp/toy_ds --model demo_tiny --device cpu
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.make_toy_dataset")
    p.add_argument("--out", required=True)
    p.add_argument("--items", type=int, default=64)
    p.add_argument("--n-mels", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    words = "aaniya kathe ondu eradu mooru naalku aidu aaru elu entu".split()
    with open(os.path.join(args.out, "manifest.jsonl"), "w", encoding="utf-8") as f:
        for i in range(args.items):
            frames = int(rng.integers(60, 400))  # 0.64 - 4.3 s at 93.75 frames/s
            mel = (rng.standard_normal((frames, args.n_mels)) * 0.5 - 2.0).astype(np.float32)
            name = f"utt{i:04d}.npy"
            np.save(os.path.join(args.out, name), mel)
            text = " ".join(rng.choice(words, size=rng.integers(3, 10)))
            f.write(json.dumps({"mel": name, "text": text + ".", "frames": frames}) + "\n")
    print(f"wrote {args.items} items to {args.out}")


if __name__ == "__main__":
    main()
