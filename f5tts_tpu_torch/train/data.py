"""Training data: frame-packed dynamic batching (counterpart of
``f5tts_tpu/train/data.py``).

- duration filter 0.3-30 s;
- items sorted by frame length and packed greedily up to ``batch_frames``
  with at most ``max_samples`` utterances, then a seeded shuffle of the
  batches (the same numpy RNG order as the JAX package, so both yield the same
  batches);
- pad-collate to the batch max, rounded up to a ``frame_bucket`` multiple;
- ``from_hf_dataset`` takes an already-loaded (in-memory or local) Hugging
  Face ``datasets.Dataset`` with decoded audio; it never touches the hub.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from f5tts_tpu_torch.ops.mel import MelConfig


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass
class Item:
    mel_path: str | None
    wav_path: str | None
    text: str
    n_frames: int
    hf_index: int | None = None  # row in the source HF dataset (survives filtering)


class FramePackedDataset:
    """Items from a manifest; yields padded numpy batches."""

    def __init__(self, items: list[Item], tokenizer, mel_cfg: MelConfig = MelConfig(),
                 min_secs: float = 0.3, max_secs: float = 30.0):
        fps = mel_cfg.frames_per_second
        self.items = [it for it in items if min_secs * fps <= it.n_frames <= max_secs * fps]
        self.tokenizer = tokenizer
        self.mel_cfg = mel_cfg

    @classmethod
    def from_dir(cls, dataset_dir: str, vocab_file: str = "", mel_cfg: MelConfig = MelConfig()):
        """``manifest.jsonl`` lines: {"mel": path, "text": str, "frames": int}
        or {"wav": path, "text": str, "secs": float}."""
        from f5tts_tpu_torch.text.tokenizer import Tokenizer

        items, texts = [], []
        with open(os.path.join(dataset_dir, "manifest.jsonl"), encoding="utf-8") as f:
            for line in f:
                rec = json.loads(line)
                texts.append(rec["text"])
                if "mel" in rec:
                    path = os.path.join(dataset_dir, rec["mel"])
                    frames = rec.get("frames") or int(np.load(path, mmap_mode="r").shape[0])
                    items.append(Item(path, None, rec["text"], frames))
                else:
                    frames = int(rec["secs"] * mel_cfg.frames_per_second)
                    items.append(Item(None, os.path.join(dataset_dir, rec["wav"]), rec["text"], frames))
        tok = Tokenizer.from_file(vocab_file) if vocab_file else Tokenizer.from_texts(texts)
        return cls(items, tok, mel_cfg)

    @classmethod
    def from_hf_dataset(cls, dataset, text_column: str = "text", audio_column: str = "audio",
                        vocab_file: str = "", mel_cfg: MelConfig = MelConfig()):
        """Items from a Hugging Face dataset whose rows carry decoded audio
        (``{"array", "sampling_rate"}``); the log-mel is computed when a batch
        is collated. Pass a loaded dataset object: nothing is downloaded."""
        from f5tts_tpu_torch.text.tokenizer import Tokenizer

        items, texts, arrays = [], [], []
        for i, row in enumerate(dataset):
            audio = row[audio_column]
            arr, sr = np.asarray(audio["array"], np.float32), int(audio["sampling_rate"])
            texts.append(row[text_column])
            arrays.append((arr, sr))
            items.append(Item(None, None, row[text_column], int(len(arr) / sr * mel_cfg.frames_per_second), hf_index=i))
        tok = Tokenizer.from_file(vocab_file) if vocab_file else Tokenizer.from_texts(texts)
        ds = cls(items, tok, mel_cfg)
        ds._hf_arrays = arrays
        return ds

    def _load_mel(self, idx: int) -> np.ndarray:
        it = self.items[idx]
        if it.hf_index is not None and hasattr(self, "_hf_arrays"):
            from f5tts_tpu_torch.audio.preprocess import resample
            from f5tts_tpu_torch.ops.mel import bucketed_log_mel

            arr, sr = self._hf_arrays[it.hf_index]
            return bucketed_log_mel(resample(arr, sr, self.mel_cfg.sample_rate), self.mel_cfg, device="cpu")
        if it.mel_path:
            return np.load(it.mel_path).astype(np.float32)
        from f5tts_tpu_torch.audio.io import read_wav
        from f5tts_tpu_torch.audio.preprocess import resample
        from f5tts_tpu_torch.ops.mel import bucketed_log_mel

        wav, sr = read_wav(it.wav_path)  # host-side data loading: the log-mel runs on the CPU
        return bucketed_log_mel(resample(wav, sr, self.mel_cfg.sample_rate), self.mel_cfg, device="cpu")

    def pack_batches(self, batch_frames: int, max_samples: int, seed: int) -> list[list[int]]:
        order = sorted(range(len(self.items)), key=lambda i: self.items[i].n_frames)
        batches: list[list[int]] = []
        cur: list[int] = []
        cur_frames = 0
        for i in order:
            f = self.items[i].n_frames
            if cur and (cur_frames + f > batch_frames or len(cur) >= max_samples):
                batches.append(cur)
                cur, cur_frames = [], 0
            cur.append(i)
            cur_frames += f
        if cur:
            batches.append(cur)
        rng = np.random.default_rng(seed)
        rng.shuffle(batches)
        return batches

    def batches(self, batch_frames: int, max_samples: int = 64, seed: int = 0,
                skip_batches: int = 0, epochs: int | None = None, frame_bucket: int = 256):
        epoch = 0
        while epochs is None or epoch < epochs:
            for bi, idxs in enumerate(self.pack_batches(batch_frames, max_samples, seed + epoch)):
                if epoch == 0 and bi < skip_batches:  # deterministic step-resume fast-forward
                    continue
                yield self._collate(idxs, frame_bucket)
            epoch += 1

    def _collate(self, idxs: list[int], frame_bucket: int) -> dict:
        mels = [self._load_mel(i) for i in idxs]
        lens = np.asarray([m.shape[0] for m in mels], np.int32)
        n = round_up(int(lens.max()), frame_bucket)
        mel = np.zeros((len(mels), n, mels[0].shape[1]), np.float32)
        for r, m_arr in enumerate(mels):
            mel[r, : m_arr.shape[0]] = m_arr
        text_ids = self.tokenizer.encode([self.items[i].text for i in idxs])
        return {"mel": mel, "text": text_ids, "lens": lens}


def synthetic_batches(model_cfg, frames: int, batch: int, n_batches: int, seed: int = 0):
    """Random full-length batches for smoke tests and for timing the train step."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield {
            "mel": rng.standard_normal((batch, frames, model_cfg.mel_dim)).astype(np.float32),
            "text": rng.integers(0, model_cfg.text_num_embeds, (batch, frames // 4)).astype(np.int32),
            "lens": np.full((batch,), frames, np.int32),
        }


def synthetic_packed_batch(model_cfg, n: int, batch: int, seed: int = 0) -> dict:
    """One random frame-packed batch as ``_collate`` lays it out with its
    256-frame bucket: row lengths drawn from ``(n - 256, n]`` (the first row
    full), padded to ``n``, with one text character per 4 frames (pad -1)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(n - 256, 0) + 1, n + 1, (batch,)).astype(np.int32)
    lens[0] = n
    mel = np.zeros((batch, n, model_cfg.mel_dim), np.float32)
    text = np.full((batch, n // 4), -1, np.int32)
    for r, ln in enumerate(lens):
        mel[r, :ln] = rng.standard_normal((ln, model_cfg.mel_dim))
        text[r, : max(1, ln // 4)] = rng.integers(0, model_cfg.text_num_embeds, (max(1, ln // 4),))
    return {"mel": mel, "text": text, "lens": lens}
