"""Periodic sample synthesis during training (counterpart of
``f5tts_tpu/train/sample_hook.py``): a training-quality signal you can hear.
Every firing takes the EMA weights (by default), solves a fixed prompt set,
writes each generated mel as ``.npy`` (and a 24 kHz ``.wav`` when a Vocos is
given) and logs each prompt's generated-mel RMS.

The prompt set is padded once to one bucket (a multiple of 64 frames) and
its noise comes from the fixed seeds ``0..b-1``, so firings at different
steps are comparable.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from f5tts_tpu_torch.models import backbone_fns
from f5tts_tpu_torch.models.cfm import CFMConfig
from f5tts_tpu_torch.sampling.euler import SamplerConfig, nfe_to_steps, sample_cfm
from f5tts_tpu_torch.train.tree import tree_leaves


def prompts_from_batch(batch: dict, k: int = 2) -> list[dict]:
    """Fixed prompts from a training batch: the first half of each row's mel
    is the conditioning, the model regenerates the second half against the
    row's full text (rows shorter than 8 frames are skipped)."""
    prompts = []
    for i in range(min(k, batch["mel"].shape[0])):
        ln = int(batch["lens"][i])
        if ln < 8:
            continue
        prompts.append({
            "cond_mel": np.asarray(batch["mel"][i, : ln // 2], np.float32),
            "text": np.asarray(batch["text"][i], np.int32),
            "duration": ln,
        })
    return prompts


def make_sample_hook(
    model_cfg: CFMConfig,
    out_dir: str,
    prompts: list[dict],
    *,
    nfe_step: int = 16,
    method: str = "euler",
    cfg_strength: float = 2.0,
    vocoder=None,  # optional (vocos params: numpy tree or tensors, VocosConfig): also write wavs
    logger=None,  # callable(**metrics)
    compute_dtype: torch.dtype = torch.float32,
    use_ema: bool = True,
):
    """Returns ``hook(state, step) -> metrics`` for ``Trainer(sample_hook=...)``.

    Writes ``{out_dir}/step{N}_p{i}.npy`` (the generated frames of prompt i)
    and, with a vocoder, ``step{N}_p{i}.wav`` at 24 kHz; returns (and logs)
    ``sample_mel_rms_p{i}``. The solve runs on the device of the state's
    params."""
    if not prompts:
        raise ValueError("sample hook needs at least one prompt")
    _, forward_fn, embed_fn = backbone_fns(model_cfg.model)  # the sampler is backbone-generic
    mel_dim = model_cfg.model.mel_dim
    bucket = max(int(p["duration"]) for p in prompts)
    bucket = int(np.ceil(bucket / 64) * 64)  # one bucket for every firing
    nt = max(len(p["text"]) for p in prompts)
    b = len(prompts)
    cond = np.zeros((b, bucket, mel_dim), np.float32)
    text = np.full((b, nt), -1, np.int32)
    lens = np.zeros((b,), np.int32)
    durs = np.zeros((b,), np.int32)
    for i, p in enumerate(prompts):
        f = min(len(p["cond_mel"]), bucket)
        cond[i, :f] = p["cond_mel"][:f]
        text[i, : len(p["text"])] = p["text"]
        lens[i] = f
        durs[i] = min(int(p["duration"]), bucket)
    sampler = SamplerConfig(steps=nfe_to_steps(nfe_step, method), method=method, cfg_strength=cfg_strength)
    seeds = np.arange(b)  # fixed noise: firings are comparable
    voc = {}

    def synth(params) -> np.ndarray:
        dev = tree_leaves(params)[0][1].device
        out = sample_cfm(params, model_cfg.model, cond=torch.as_tensor(cond, device=dev),
                         cond_lens=torch.as_tensor(lens, device=dev), text=torch.as_tensor(text, device=dev),
                         duration=torch.as_tensor(durs, device=dev), sampler=sampler, seeds=seeds,
                         compute_dtype=compute_dtype, forward_fn=forward_fn, embed_fn=embed_fn)
        return out.float().cpu().numpy()

    def decode(gen: np.ndarray, dev) -> np.ndarray:
        from f5tts_tpu_torch.models.convert import vocos_params_from_numpy
        from f5tts_tpu_torch.models.vocos import vocos_decode

        vparams, vcfg = vocoder
        if "params" not in voc:  # a numpy tree (a converted .npz) goes to the device once
            tensors = isinstance(tree_leaves(vparams)[0][1], torch.Tensor)
            voc["params"] = vparams if tensors else vocos_params_from_numpy(vparams, dev)
        with torch.no_grad():
            wave = vocos_decode(voc["params"], torch.as_tensor(gen, device=dev)[None], vcfg)[0]
        return wave.float().cpu().numpy()

    def hook(state, step: int) -> dict:
        os.makedirs(out_dir, exist_ok=True)
        params = state["ema"] if use_ema else state["params"]
        mel = synth(params)  # (b, bucket, mel)
        dev = tree_leaves(params)[0][1].device
        metrics = {}
        for i in range(b):
            gen = mel[i, lens[i] : durs[i]]
            np.save(os.path.join(out_dir, f"step{step}_p{i}.npy"), gen)
            metrics[f"sample_mel_rms_p{i}"] = float(np.sqrt(np.mean(np.square(gen))))
            if vocoder is not None:
                from f5tts_tpu_torch.audio.io import write_wav

                write_wav(os.path.join(out_dir, f"step{step}_p{i}.wav"), decode(gen, dev), 24_000)
        if logger is not None:
            logger(step=step, **metrics)
        return metrics

    return hook
