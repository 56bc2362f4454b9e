"""The flow-matching solve of F5-TTS's inference (``CFM.sample``) as the
configurations serve it, and what it needs from the host side.

- Noise: one ``torch.Generator`` per row seed on the CPU, ``randn(n, mel)``
  for the row's duration bucket ``n``, zero past the row's clipped duration.
- Guidance: ``v = pred + (pred - null) * cfg``; the null branch drops the
  audio condition and the text.
- Time: the sampler's ``time_grid`` where the configuration states one, else
  ``linspace(0, 1, steps + 1)`` warped by sway sampling
  ``t + s * (cos(pi / 2 * t) - 1 + t)``; the sampler's explicit Runge-Kutta
  method per interval, every evaluation guided.
- The result pastes the conditioning frames back; the generated frames are
  rolled to the origin, zeroed past the generated length and vocoded.

The sampler's settings are the configuration's ``serving.sampler`` (the
program's ``SamplerConfig`` fields: ``method``, ``steps``, ``cfg_strength``,
``sway_sampling_coef``, optionally ``time_grid``).
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from benchmark.reference.layers import rnd, text_embed

# Butcher tableaus of the explicit methods: (stage coefficients, weights)
TABLEAUS = {
    "euler": ([], [1.0]),
    "midpoint": ([[0.5]], [0.0, 1.0]),
    "heun": ([[1.0]], [0.5, 0.5]),
    "ralston": ([[2.0 / 3.0]], [0.25, 0.75]),
    "rk4": ([[0.5], [0.0, 0.5], [0.0, 0.0, 1.0]], [1 / 6, 1 / 3, 1 / 3, 1 / 6]),
}


def family(name: str):
    """The reference module of a backbone or vocoder family."""
    return importlib.import_module(f"benchmark.reference.{name}")


def read_vocab(path: str) -> dict[str, int]:
    with open(path, encoding="utf-8") as f:
        return {line[:-1] if line.endswith("\n") else line: i for i, line in enumerate(f)}


def token_ids(vocab: dict[str, int], text: str, pad: int) -> np.ndarray:
    """Characters to ids (unknown = 0, the space), padded with -1 to ``pad``."""
    text = text.translate(str.maketrans({";": ",", "“": '"', "”": '"', "‘": "'", "’": "'"}))
    ids = np.full((pad,), -1, np.int64)
    row = [vocab.get(c, 0) for c in text][:pad]
    ids[: len(row)] = row
    return ids


def duration_frames(ref_frames: int, ref_text: str, gen_text: str) -> int:
    """F5-TTS's duration estimate: the reference's frames per UTF-8 byte."""
    ref_bytes = max(len(ref_text.encode("utf-8")), 1)
    return ref_frames + int(ref_frames / ref_bytes * len(gen_text.encode("utf-8")))


def bucket_of(frames: int, buckets) -> int:
    return next((b for b in buckets if frames <= b), buckets[-1])


def row_noise(seed: int, n: int, mel: int, clipped: int) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    y = torch.randn((n, mel), generator=g, dtype=torch.float32)
    y[clipped:] = 0.0
    return y


def time_grid(sampler: dict) -> torch.Tensor:
    if sampler.get("time_grid") is not None:
        return torch.tensor(sampler["time_grid"], dtype=torch.float32)
    t = np.linspace(0.0, 1.0, sampler["steps"] + 1)
    sway = sampler["sway_sampling_coef"] or 0.0
    return torch.tensor(t + sway * (np.cos(math.pi / 2 * t) - 1 + t), dtype=torch.float32)


@torch.no_grad()
def solve(weights, config: dict, rows: list[dict], *, device):
    """Rows of one duration bucket ``n`` solved together by the backbone and
    vocoder of ``weights`` (``{"backbone": tree, "vocoder": tree}``) as
    ``config`` (a configuration file) states them. Each row: ``cond``
    ``(ref_frames, mel)`` tensor, ``text`` ids ``(nt,)``, ``duration``,
    ``seed``, ``n``. Returns ``[(gen mel (gen_len, mel), wave)]``."""
    cfg, sampler = config["model"], config["serving"]["sampler"]
    fwd = family(config["family"]).forward
    cfg_strength = sampler["cfg_strength"]
    p = weights["backbone"]
    n, mel_dim, b = rows[0]["n"], cfg["mel_dim"], len(rows)
    frames = torch.arange(n, device=device)
    cond = torch.zeros((b, n, mel_dim), device=device)
    cond_lens = torch.tensor([r["cond"].shape[0] for r in rows], device=device)
    for i, r in enumerate(rows):
        cond[i, : r["cond"].shape[0]] = r["cond"]
    text = torch.stack([torch.as_tensor(r["text"]) for r in rows]).to(device)
    lens = torch.maximum((text != -1).sum(-1), cond_lens)
    cond_mask = frames[None] < lens[:, None]
    dur = torch.tensor([min(r["duration"], n) for r in rows], device=device)
    clipped = torch.clamp(torch.maximum(lens + 1, dur), max=n)
    mask = frames[None] < clipped[:, None]
    step_cond = cond * cond_mask[..., None]
    y = rnd(torch.stack([row_noise(r["seed"], n, mel_dim, int(c)) for r, c in zip(rows, clipped.tolist())]).to(device))

    drop = torch.cat([torch.zeros(b, dtype=torch.bool), torch.ones(b, dtype=torch.bool)]).to(device)
    mask2, cond2 = torch.cat([mask, mask]), torch.cat([step_cond, step_cond])
    temb = text_embed(p["text_embed"], torch.cat([text, text]), n, drop, mask2)

    def velocity(t, x):
        out = fwd(p, cfg, torch.cat([x, x]), cond2, temb, t.expand(2 * b), drop, mask2)
        pred, null = out[:b], out[b:]
        return rnd(pred + (pred - null) * cfg_strength)

    stages, weights_b = TABLEAUS[sampler["method"]]
    grid = time_grid(sampler).to(device)
    for t0, t1 in zip(grid[:-1], grid[1:]):
        dt = t1 - t0
        ks = [velocity(t0, y)]
        for a in stages:
            ks.append(velocity(t0 + sum(a) * dt, rnd(y + dt * sum(c * k for c, k in zip(a, ks)))))
        y = rnd(y + dt * sum(c * k for c, k in zip(weights_b, ks)))
    out = torch.where(cond_mask[..., None], cond, y)

    idx = (frames[None] + cond_lens[:, None]) % n
    gen = torch.gather(out, 1, idx[..., None].expand(-1, -1, mel_dim))
    gen_len = dur - cond_lens
    gen = gen * (frames[None] < gen_len[:, None])[..., None]
    v = config["vocoder"]
    wave = family(v["family"]).decode(v, weights["vocoder"], gen)
    return [(gen[i, : int(g)], wave[i, : family(v["family"]).samples(v, int(g))]) for i, g in enumerate(gen_len.tolist())]
