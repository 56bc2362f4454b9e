"""Component times on the card (counterpart of ``scripts/component_bench.py``):
one fused-CFG DiT step (``dit_forward`` at F5-TTS Base, b 16 = 2 x 8 rows,
1024 frames, bf16) with each attention path, ``plain``
(``ops/attention.py:sdpa``, fp32 scores in PyTorch: the JAX script's
``xla``) and ``flash`` (the kernel), and the Vocos decode of 8 x 1024
frames. Each time is the median of five calls after a warm call, each ended
in a host sync (host clock). Informs kernel work; not the bench.

    python -m f5tts_tpu_torch.scripts.component_bench                     # one CUDA card
    CB_BATCH=2 CB_FRAMES=64 python -m f5tts_tpu_torch.scripts.component_bench --device cpu --geometry tiny

``CB_BATCH`` (the CFG-doubled batch) and ``CB_FRAMES`` as in the JAX
script. ``step_inputs``/``dit_step``/``vocos_step`` are what ``run`` times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from f5tts_tpu_torch.models.convert import (dit_params_from_numpy, init_dit_numpy, init_vocos_numpy,
                                            vocos_params_from_numpy)
from f5tts_tpu_torch.models.dit import DiTConfig, dit_forward
from f5tts_tpu_torch.models.vocos import VocosConfig, vocos_decode
from f5tts_tpu_torch.utils.device import resolve_device
from f5tts_tpu_torch.utils.timing import card_line, median_seconds

ATTN_PATHS = ("plain", "flash")


def step_inputs(cfg: DiTConfig, b: int, n: int, rng: np.random.Generator, dtype=torch.bfloat16, device="cpu") -> dict:
    """The JAX script's step inputs: x (also the cond), text ids below 90
    (or the vocabulary's size), time 0.4, the second half of the rows
    dropped (the null branch), every frame valid."""
    drop = torch.tensor([False] * (b // 2) + [True] * (b - b // 2), device=device)
    return {"x": torch.as_tensor(rng.standard_normal((b, n, cfg.mel_dim)), device=device).to(dtype),
            "text": torch.as_tensor(rng.integers(0, min(90, cfg.text_num_embeds), (b, 512)), dtype=torch.int32,
                                    device=device),
            "time": torch.full((b,), 0.4, dtype=torch.float32, device=device), "drop": drop,
            "mask": torch.ones((b, n), dtype=torch.bool, device=device)}


@torch.no_grad()
def dit_step(params, cfg: DiTConfig, inp: dict, compute_dtype=torch.bfloat16) -> torch.Tensor:
    return dit_forward(params, cfg, inp["x"], inp["x"], inp["text"], inp["time"], inp["drop"], inp["drop"],
                       inp["mask"], compute_dtype=compute_dtype)


@torch.no_grad()
def vocos_step(vparams, vcfg: VocosConfig, mel: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    return vocos_decode(vparams, mel, vcfg, compute_dtype=compute_dtype)


def run(cfg: DiTConfig, vcfg: VocosConfig, b: int = 16, n: int = 1024, iters: int = 5, device="cuda",
        log=print) -> dict:
    """The step with each attention path and the vocoder decode: median ms."""
    dev = resolve_device(device)
    card = card_line(dev)
    rng = np.random.default_rng(0)
    params = dit_params_from_numpy(init_dit_numpy(cfg, seed=0), dev, torch.bfloat16)
    out = {}
    for attn in ATTN_PATHS:
        acfg = dataclasses.replace(cfg, attn_impl=attn)
        inp = step_inputs(acfg, b, n, rng, device=dev)
        med, _ = median_seconds(lambda: float(dit_step(params, acfg, inp)[..., :1].float().sum()), dev, iters)
        out[f"dit_step_{attn}_ms"] = med * 1e3
        log(f"dit_step attn={attn} (b {b}, n {n}, bf16): {med * 1e3:.2f} ms -> est 32-step sampler "
            f"{32 * med:.3f} s on {card}")
    del params
    vparams = vocos_params_from_numpy(init_vocos_numpy(vcfg, seed=1), dev, torch.bfloat16)
    mel = torch.as_tensor(rng.standard_normal((b // 2, n, vcfg.input_channels)), device=dev).to(torch.bfloat16)
    med, _ = median_seconds(lambda: float(vocos_step(vparams, vcfg, mel)[..., :1].sum()), dev, iters)
    out["vocos_decode_ms"] = med * 1e3
    log(f"vocos decode (b {b // 2}, n {n}, bf16): {med * 1e3:.2f} ms on {card}")
    return {"batch": b, "frames": n, "card": card, **out}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.component_bench")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--geometry", default="base", choices=["base", "tiny"],
                   help="base = F5-TTS Base + Vocos; tiny = a 4-layer DiT and a 2-layer Vocos (CPU smoke)")
    args = p.parse_args(argv)
    if args.geometry == "tiny":
        from f5tts_tpu_torch.scripts.quality_harness import TINY as cfg

        vcfg = VocosConfig(input_channels=cfg.mel_dim, dim=48, intermediate_dim=96, num_layers=2)
    else:
        cfg, vcfg = DiTConfig.base(), VocosConfig()
    out = run(cfg, vcfg, int(os.environ.get("CB_BATCH", 16)), int(os.environ.get("CB_FRAMES", 1024)),
              device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
