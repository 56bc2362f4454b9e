"""The comparison that decides ``correct`` for the serving cells.

After the window has closed and the program's state is freed, a sample of
the rows the window served (drawn from the seed, the longest always in it) is
worked out again by the plain reference (``benchmark/reference/``) from the
same inputs: the voice's clip and transcript, the request's text and seed,
and the weights. The reference re-derives the conditioning mel, the token
ids, the duration and the noise; it reads the program's plan only for each
row's chunk of text, and checks that the chunks give back the request's words.
It takes its buckets, text pad, longest duration and sampler from the cell's
files, as the program's engine is handed them.

Numbers compared, each pooled over the sample (the norms of all its rows'
differences over the norms of all its reference rows):

- ``mel_err``: ``||mel - mel_ref|| / ||mel_ref||`` over the rows' generated frames;
- ``wave_err``: the same over the rows' waves, against the reference's
  vocoder over the program's own mels.

A row whose chunking, duration or length departs from the reference's reads
``inf``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark.reference import layers as L
from benchmark.reference import sampler as S

TARGET_RMS = 0.1  # F5-TTS raises a quieter reference clip to this RMS


def prepared_ref_text(text: str) -> str:
    """F5-TTS's transcript rules: end in ". ", then one more space after a
    one-byte last character."""
    if not text.endswith(". ") and not text.endswith("。"):
        text = text + " " if text.endswith(".") else text + ". "
    if text and len(text[-1].encode("utf-8")) == 1:
        text += " "
    return text


def voice_inputs(config: dict, voice: dict, device) -> dict:
    """The clip as the program holds it (50 ms of silence appended by the
    reference-clip rule; the synthetic clips have none to trim), its RMS gain
    and conditioning mel (the vocoder family's front end)."""
    v = config["vocoder"]
    voc = S.family(v["family"])
    audio = np.concatenate([voice["audio"], np.zeros(int(0.05 * voc.SR), np.float32)]).astype(np.float64)
    rms = float(np.sqrt(np.mean(audio * audio)))
    if 0 < rms < TARGET_RMS:
        audio = audio * (TARGET_RMS / rms)
    frames = len(audio) // v["hop_length"]
    return {"rms": rms, "frames": frames, "cond": voc.log_mel(v, audio.astype(np.float32), device),
            "text": prepared_ref_text(voice["text"])}


@contextlib.contextmanager
def full_fp32():
    """float32 products as float32, not TF32, for the reference."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_rows(weights, config, engine: dict, vocab, items: list[dict], device, precision=None,
                   block: int = 8) -> list:
    """``items``: ``{"voice": voice_inputs, "text": row text, "duration",
    "seed"}``; ``engine``: the engine options the cell's files state
    (``duration_buckets``, ``text_pad``, ``max_duration``). Returns per item
    ``(gen mel, wave, n)`` (numpy, and the row's duration bucket), or None
    where the row's text or duration departs from the reference's plan.
    ``precision`` "fp8": the control (``reference/layers.py:PRECISION``)."""
    out: list = [None] * len(items)
    by_n: dict[int, list[int]] = {}
    rows = []
    for i, it in enumerate(items):
        v = it["voice"]
        chunk = it["text"][len(v["text"]):]
        dur = min(S.duration_frames(v["frames"], v["text"], chunk), engine["max_duration"])
        if not it["text"].startswith(v["text"]) or dur != it["duration"]:
            rows.append(None)
            continue
        n = S.bucket_of(max(dur, v["frames"] + 2), engine["duration_buckets"])
        rows.append({"cond": v["cond"], "text": S.token_ids(vocab, it["text"], engine["text_pad"]), "duration": dur,
                     "seed": it["seed"], "n": n})
        by_n.setdefault(n, []).append(i)
    for n, idx in by_n.items():
        for k in range(0, len(idx), block):
            part = idx[k : k + block]
            with full_fp32():
                L.PRECISION["all"] = precision
                try:
                    res = S.solve(weights, config, [rows[i] for i in part], device=device)
                finally:
                    L.PRECISION["all"] = None
            for i, (gen, wave) in zip(part, res):
                out[i] = (gen.cpu().numpy(), wave.cpu().numpy(), n)
    return out


def reference_vocoder(weights, config, mels: list, ns: list[int], device) -> list:
    """The reference's vocoder over given generated mels, each zero-padded to
    its row's bucket as the program decodes it, cut to the samples of its
    generated frames."""
    v = config["vocoder"]
    voc = S.family(v["family"])
    out = []
    with full_fp32():
        for mel, n in zip(mels, ns):
            x = torch.zeros((1, n, mel.shape[-1]), device=device)
            x[0, : mel.shape[0]] = torch.as_tensor(np.asarray(mel), dtype=torch.float32, device=device)
            out.append(voc.decode(v, weights["vocoder"], x)[0, : voc.samples(v, mel.shape[0])].cpu().numpy())
    return out


def pooled_err(pairs) -> float:
    """``||a - b|| / ||b||`` over all ``(a, b)`` pairs together (inf if any
    pair's shapes differ, or if there is nothing to compare)."""
    num = den = 0.0
    for a, b in pairs:
        a = torch.as_tensor(np.asarray(a), dtype=torch.float64)
        b = torch.as_tensor(np.asarray(b), dtype=torch.float64)
        if a.shape != b.shape:
            return math.inf
        num += float(torch.sum((a - b) ** 2))
        den += float(torch.sum(b * b))
    return math.sqrt(num / den) if den > 0 else math.inf


def judge_rows(ctx, items: list[dict], got: list) -> tuple[float, float]:
    """``mel_err`` and ``wave_err`` of the program's ``got`` rows (``(mel,
    wave)``), pooled over the sample: the mels against the reference's solve
    (the backbone through the sampler), the waves against the reference's
    vocoder over the program's own mels (the vocoder alone: through the
    whole solve, the vocoder's sensitivity to the mel's rounding, which
    differs from seed to seed with the weights, would set the number). With
    the control ``reference:fp8`` the reference held in fp8 stands in for the
    program. A row the reference cannot plan, or whose chunks drop words,
    reads inf."""
    from benchmark import serving

    cell = ctx.cell
    weights = serving.make_weights(cell, ctx.seed, ctx.device)
    vocab = S.read_vocab(serving.vocab_path(cell))
    engine = serving.engine_options(cell)
    ref = reference_rows(weights, cell.config, engine, vocab, items, ctx.device)
    if ctx.control == "reference:fp8":
        got = reference_rows(weights, cell.config, engine, vocab, items, ctx.device, precision="fp8")
    if any(r is None or g is None or not it["covered"] for it, r, g in zip(items, ref, got)):
        return math.inf, math.inf
    voc = reference_vocoder(weights, cell.config, [g[0] for g in got], [r[2] for r in ref], ctx.device)
    return pooled_err((g[0], r[0]) for g, r in zip(got, ref)), pooled_err((g[1], v) for g, v in zip(got, voc))


def chunks_cover(paragraph: str, row_texts: list[str], ref_text: str) -> bool:
    """The request's chunks, joined, give back its words in order."""
    chunks = [t[len(ref_text):] for t in row_texts]
    return " ".join(chunks).split() == paragraph.split()


def sample(rng: np.random.Generator, sizes: list[int], k: int) -> list[int]:
    """``k`` indices drawn from ``rng``, the largest ``sizes`` entry always among them."""
    if not sizes:
        return []
    longest = int(np.argmax(sizes))
    rest = [i for i in range(len(sizes)) if i != longest]
    picked = rng.choice(rest, size=min(k - 1, len(rest)), replace=False).tolist() if rest and k > 1 else []
    return [longest, *picked]
