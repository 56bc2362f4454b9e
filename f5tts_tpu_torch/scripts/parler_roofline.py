"""Where the Parler branch's time goes, and its decode against the card's
HBM bound (counterpart of ``scripts/parler_roofline.py``).

At each batch of ``--batches``, on indic-parler-tts's seeded trees in bf16
(``desc_pad`` 64, a 64-token prompt), the median of ``--iters`` calls after
a warm call, each ended in a host sync (host clock):

1. the T5 encode (``t5_encode``);
2. the decode (``parler_generate``) at temperature 1 with per-row seeds,
   greedy, and at half the frames (per-step linearity); with
   ``--depth-knockout`` also a 12-layer decode (if it halves, the cost is per
   layer; if not, it is per step). These take no warm call of their own
   after the first decode;
3. the DAC (``dac_decode_codes``).

The bound: each decode step streams the decoder's weights ``W`` and the KV
cache's average prefix from HBM, ``t_step >= (W + cache(b)) / BW`` with the
card's 3.35 TB/s (``utils/timing.py``), the JAX script's formula.
``run(...)`` is the work of ``main`` on given trees; ``roofline_row`` its
arithmetic.

    python -m f5tts_tpu_torch.scripts.parler_roofline                     # one CUDA card
    python -m f5tts_tpu_torch.scripts.parler_roofline --device cpu --geometry tiny --batches 2 --frames 8 --iters 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from f5tts_tpu_torch.models import parler as P
from f5tts_tpu_torch.models.convert import (init_dac_numpy, init_parler_decoder_numpy, init_t5_numpy,
                                            parler_params_from_numpy)
from f5tts_tpu_torch.train.tree import tree_leaves, tree_map
from f5tts_tpu_torch.utils.device import resolve_device
from f5tts_tpu_torch.utils.timing import PEAK_BYTES, card_line, median_seconds

DESC_PAD, PROMPT_LEN = 64, 64
TINY = (P.T5Config(vocab=60, d_model=24, d_kv=6, d_ff=32, heads=4, layers=2, rel_buckets=8, rel_max_dist=20),
        P.ParlerDecoderConfig(vocab=40, codebooks=4, hidden=32, layers=2, heads=4, ffn=48, cross_dim=24,
                              prompt_vocab=60),
        P.DacConfig(num_codebooks=4, codebook_size=40, codebook_dim=6, latent_dim=24, decoder_dim=16, rates=(4, 2)))


def param_bytes(tree, itemsize: int = 2) -> int:
    """Bytes of every leaf at ``itemsize`` bytes an element (bf16: 2)."""
    return sum(int(np.prod(v.shape)) * itemsize for _, v in tree_leaves(tree))


def roofline_row(b: int, frames: int, steps: int, dec_cfg: P.ParlerDecoderConfig, w_dec: int, frame_rate: float,
                 times: dict, bw: float = PEAK_BYTES, prompt_len: int = PROMPT_LEN) -> dict:
    """The JAX script's row from seconds ``times`` (``t5``, ``decode``,
    ``decode_greedy``, ``decode_half``, ``dac``, optional ``decode_half_depth``):
    the average cache prefix is the prompt, BOS and half the steps, K and V of
    every layer in bf16."""
    avg_ctx = prompt_len + 1 + steps / 2
    cache_bytes = dec_cfg.layers * 2 * b * dec_cfg.n_kv * avg_ctx * dec_cfg.head_dim * 2
    t_step_bound = (w_dec + cache_bytes) / bw
    t_dec = times["decode"]
    t_step = t_dec / steps
    audio_s = b * frames / frame_rate
    total = times["t5"] + t_dec + times["dac"]
    return {
        "batch": b,
        "t5_ms": times["t5"] * 1e3, "decode_ms": t_dec * 1e3, "dac_ms": times["dac"] * 1e3,
        "decode_greedy_ms": times["decode_greedy"] * 1e3,
        "decode_half_frames_ms": times["decode_half"] * 1e3,
        **({"decode_half_depth_ms": times["decode_half_depth"] * 1e3} if "decode_half_depth" in times else {}),
        "step_us": t_step * 1e6,
        "step_bound_us": t_step_bound * 1e6,
        "bw_efficiency": t_step_bound / t_step,
        "audio_s_per_s_decode_only": audio_s / t_dec,
        "audio_s_per_s_pipeline": audio_s / total,
        "pct_t5": 100 * times["t5"] / total, "pct_decode": 100 * t_dec / total,
        "pct_dac": 100 * times["dac"] / total,
    }


def make_inputs(b: int, t5_cfg: P.T5Config, dec_cfg: P.ParlerDecoderConfig, rng: np.random.Generator,
                device="cpu") -> dict:
    """Description ids and a prompt of ``PROMPT_LEN`` tokens, every position valid."""
    def ids(vocab, n):
        return torch.as_tensor(rng.integers(2, vocab, (b, n)), dtype=torch.int32, device=device)

    return {"ids": ids(t5_cfg.vocab, DESC_PAD), "mask": torch.ones((b, DESC_PAD), dtype=torch.bool, device=device),
            "prompt": ids(dec_cfg.prompt_vocab, PROMPT_LEN),
            "pmask": torch.ones((b, PROMPT_LEN), dtype=torch.bool, device=device), "seeds": list(range(b))}


def encode(t5, t5_cfg, inputs: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return P.t5_encode(t5, t5_cfg, inputs["ids"], inputs["mask"], compute_dtype=dtype)


def decode(dec, dec_cfg, dac_cfg, enc, inputs: dict, frames: int, temperature: float,
           dtype=torch.bfloat16) -> torch.Tensor:
    """The codes ``(b, K, frames)``: sampled with per-row seeds, or greedy at
    temperature 0; the EOS never stops a row (``eos_token=-1``)."""
    codes, _ = P.parler_generate(dec, dec_cfg, enc, inputs["mask"], frames, 0, prompt_ids=inputs["prompt"],
                                 prompt_mask=inputs["pmask"], eos_token=-1, temperature=temperature, top_k=0,
                                 max_code=dac_cfg.codebook_size,
                                 row_seeds=None if temperature <= 0 else inputs["seeds"], compute_dtype=dtype)
    return codes


def half_depth(dec, dec_cfg):
    """The decoder's first half of its layers: ``(params, config)``."""
    half = dec_cfg.layers // 2
    return {**dec, "blocks": tree_map(lambda x: x[:half], dec["blocks"])}, dataclasses.replace(dec_cfg, layers=half)


def run(trees, cfgs, batches, frames: int = 430, iters: int = 3, depth_knockout: bool = False, device="cuda",
        dtype=torch.bfloat16, log=print) -> dict:
    """``trees`` = the port's (t5, decoder, dac) tensors, ``cfgs`` their
    configs: a row per batch."""
    dev = torch.device(device)
    card = card_line(dev)
    (t5, dec, dac), (t5_cfg, dec_cfg, dac_cfg) = trees, cfgs
    w_dec = param_bytes(dec)
    steps = frames + dec_cfg.codebooks - 1
    frame_rate = dac_cfg.sampling_rate / dac_cfg.hop
    rng = np.random.default_rng(0)
    results = {"frames": frames, "steps": steps, "dec_param_bytes": w_dec, "card": card, "rows": []}

    last = {}

    def timed(fn, warmup: int = 1):
        def call():
            last["out"] = fn()
            return float(last["out"].float().sum())  # a host fetch

        return median_seconds(call, dev, iters, warmup)[0]

    for b in batches:
        inputs = make_inputs(b, t5_cfg, dec_cfg, rng, dev)
        times = {"t5": timed(lambda: encode(t5, t5_cfg, inputs, dtype))}
        enc = last["out"]
        times["decode"] = timed(lambda: decode(dec, dec_cfg, dac_cfg, enc, inputs, frames, 1.0, dtype))
        codes = last["out"]
        # the decode path is warm now: the other decodes take no warm call
        times["decode_greedy"] = timed(lambda: decode(dec, dec_cfg, dac_cfg, enc, inputs, frames, 0.0, dtype), 0)
        times["decode_half"] = timed(lambda: decode(dec, dec_cfg, dac_cfg, enc, inputs, frames // 2, 1.0, dtype), 0)
        times["dac"] = timed(lambda: P.dac_decode_codes(dac, codes, dac_cfg, compute_dtype=dtype))
        if depth_knockout:
            half, half_cfg = half_depth(dec, dec_cfg)
            times["decode_half_depth"] = timed(
                lambda: decode(half, half_cfg, dac_cfg, enc, inputs, frames, 1.0, dtype), 0)
        row = roofline_row(b, frames, steps, dec_cfg, w_dec, frame_rate, times)
        results["rows"].append(row)
        log(json.dumps({"card": card, **{k: (round(v, 3) if isinstance(v, float) else v) for k, v in row.items()}}))
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.parler_roofline")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--geometry", default="full", choices=["full", "tiny"],
                   help="full = indic-parler-tts; tiny = a 2-layer T5, decoder and DAC (CPU smoke)")
    p.add_argument("--frames", type=int, default=430)
    p.add_argument("--batches", default="8,16,32")
    p.add_argument("--depth-knockout", action="store_true",
                   help="also time a half-depth (12-layer) decode at each batch")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--out", default=None, help="JSON result file (default: stdout only)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfgs = TINY if args.geometry == "tiny" else (P.T5Config(), P.ParlerDecoderConfig(), P.DacConfig())
    trees = parler_params_from_numpy(init_t5_numpy(cfgs[0], seed=0), init_parler_decoder_numpy(cfgs[1], seed=1),
                                     init_dac_numpy(cfgs[2], seed=2), dev, torch.bfloat16)
    results = run(trees, cfgs, [int(x) for x in args.batches.split(",")], args.frames, args.iters,
                  args.depth_knockout, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
