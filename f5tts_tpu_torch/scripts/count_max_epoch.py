"""Epochs that fit in an update budget at a frame budget per update
(counterpart of ``scripts/count_max_epoch.py``).

    python -m f5tts_tpu_torch.scripts.count_max_epoch [--dataset-hours 95000] \\
        [--frames-per-update 307200] [--total-updates 1200000]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.count_max_epoch")
    p.add_argument("--dataset-hours", type=float, default=95_000, help="total audio hours (Emilia ZH+EN ~95k h)")
    p.add_argument("--frames-per-update", type=int, default=307_200, help="38400 frames x 8 devices")
    p.add_argument("--total-updates", type=int, default=1_200_000)
    args = p.parse_args(argv)
    frames_per_second = 24_000 / 256
    dataset_frames = args.dataset_hours * 3600 * frames_per_second
    updates_per_epoch = dataset_frames / args.frames_per_update
    print(f"updates/epoch: {updates_per_epoch:,.0f}")
    print(f"epochs in {args.total_updates:,} updates: {args.total_updates / updates_per_epoch:.2f}")
    print(f"audio-hours per update: {args.frames_per_update / frames_per_second / 3600:.2f}")


if __name__ == "__main__":
    main()
