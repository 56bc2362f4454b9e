"""What the serving cells share: the weights and the engine built from a
configuration file, and the synthetic voices and texts.

The engine is the program's ``TTSEngine`` with the options the cell's files
state: the configuration's ``serving.engine`` (``EngineConfig`` keywords:
dtype, quantization, buckets, caps, chunking) and ``serving.sampler``
(``SamplerConfig`` keywords), the vocoder family's options, and the traffic
mix's ``engine`` keywords over them; on weights the benchmark draws on the
card from the run's seed. After the window ``departures`` counts where the
engine the window ran holds other options or weights of another type than
stated. Each voice is a synthetic speech-like clip drawn from the seed,
stored as 16-bit PCM as a WAV file would hold it, with a transcript drawn
from the traffic's fixed word list.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import weights as W
from benchmark.backbones import family

SR = 24000


# ---------------------------------------------------------------------------
# weights and the program's engine
# ---------------------------------------------------------------------------


def layout(config: dict) -> dict:
    return {"backbone": family(config["family"]).layout(config["model"]),
            "vocoder": family(config["vocoder"]["family"]).layout(config["vocoder"])}


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def engine_options(cell) -> dict:
    """The engine keywords the cell's files state, as JSON values: the
    configuration's ``serving.engine`` with the traffic mix's ``engine`` over it."""
    return {**cell.config["serving"]["engine"], **cell.traffic.get("engine", {})}


def make_weights(cell, seed: int, device) -> dict:
    """fp32 tensors on ``device`` holding values of the serving dtype."""
    return W.make(layout(cell.config), W.seed_of(seed, "weights"), device,
                  round_to=DTYPES[engine_options(cell)["compute_dtype"]])


def vocab_path(cell) -> str:
    return cell.path("configs", cell.config["vocab"])


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def stated_engine(cell) -> dict:
    """``EngineConfig`` keywords as the cell's files state them."""
    from f5tts_tpu_torch.sampling.euler import SamplerConfig

    config = cell.config
    sampler = {k: _tuples(v) for k, v in config["serving"]["sampler"].items()}
    return {**family(config["vocoder"]["family"]).program(config["vocoder"]),
            **{k: _tuples(v) for k, v in engine_options(cell).items()}, "sampler": SamplerConfig(**sampler)}


def build_engine(cell, seed: int, device, **overrides):
    """The program's engine on the seed's weights (one host copy, which the
    engine casts to the serving dtype and uploads), with the options the
    cell's files state; ``overrides`` (a control's) over them."""
    config = cell.config
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.text.tokenizer import Tokenizer

    host = W.to_numpy(make_weights(cell, seed, device))
    model_cfg, fwd, emb = family(config["family"]).program(config["model"])
    tok = Tokenizer.from_file(vocab_path(cell))
    return TTSEngine(host["backbone"], model_cfg, host["vocoder"], tok,
                     EngineConfig(**{**stated_engine(cell), **overrides}), device=device, forward_fn=fwd, embed_fn=emb)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def departures(engine, cell) -> int:
    """Where the engine a window ran departs from what the cell's files state:
    each stated option it holds otherwise, and each tensor of its backbone's
    and vocoder's weights not held in the stated dtype (a quantized or
    lower-precision copy). A sound run reads 0."""
    stated = stated_engine(cell)
    off = sum(getattr(engine.cfg, k, None) != v for k, v in stated.items())
    dtype = DTYPES[stated["compute_dtype"]]
    return off + sum(t.dtype != dtype for t in _leaves([engine.dit_params, engine.vocos_params]))


# ---------------------------------------------------------------------------
# voices and texts
# ---------------------------------------------------------------------------


def word_list(cell) -> list[str]:
    with open(cell.path("traffic", cell.traffic["words"]), encoding="utf-8") as f:
        return [w for w in f.read().split() if w]


def sentence(rng, words, n_words: int) -> str:
    """``n_words`` words ending in ``.`` (Latin) or ``।`` (Devanagari), with
    an occasional comma."""
    ws = [str(w) for w in rng.choice(words, n_words)]
    for i in range(1, n_words - 1):
        if rng.random() < 0.08:
            ws[i] += ","
    end = "।" if not ws[-1][-1].isascii() else "."
    return " ".join(ws) + end


def paragraph(rng, words, n_words: int) -> str:
    out, left = [], n_words
    while left > 0:
        k = min(left, int(rng.integers(6, 15)))
        out.append(sentence(rng, words, k))
        left -= k
    return " ".join(out)


def voice_clip(rng, seconds: float, rms: float) -> np.ndarray:
    """A voiced, never silent clip: harmonics of a gliding pitch under a
    syllable-rate envelope, with breath noise and a faint 1 kHz tone; as
    16-bit PCM values / 32768."""
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(100, 220) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.3, 0.8) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h for h in range(1, 16))
    env = 0.55 + 0.45 * np.abs(np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, np.pi)))
    x = x * env + 0.05 * rng.standard_normal(len(t))
    x = x * (rms / np.sqrt(np.mean(x * x)))
    # a 1 kHz tone, one whole period per millisecond, keeps every millisecond
    # above the reference-clip rule's -42 dBFS, so the rule trims nothing
    x = x + 0.02 * np.sin(2 * np.pi * 1000 * t)
    return (np.rint(np.clip(x, -1, 1) * 32767) / 32768).astype(np.float32)


def voices(cell, seed: int) -> list[dict]:
    """``[{"name", "audio", "text"}]``: clip lengths and transcripts from the
    traffic file (fixed: ``ref_chars_per_s`` characters a second), clip
    signals from the run's seed."""
    traffic = cell.traffic
    words = word_list(cell)
    text_rng = np.random.default_rng(traffic["pool_seed"])
    sig_rng = np.random.default_rng(W.seed_of(seed, "voices"))
    out = []
    for i, secs in enumerate(traffic["voice_seconds"]):
        ws: list[str] = []
        while len(" ".join(ws)) < traffic["ref_chars_per_s"] * secs:
            ws.append(str(text_rng.choice(words)))
        text = " ".join(ws) + ("." if ws[-1][-1].isascii() else "।")
        out.append({"name": f"voice{i}", "audio": voice_clip(sig_rng, secs, traffic["voice_rms"]), "text": text})
    return out
