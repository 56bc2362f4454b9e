"""A full-size trainer checkpoint through the port's real loading path
(counterpart of ``scripts/e2e_real_ckpt.py``):

    trainer-layout .pt -> python -m f5tts_tpu_torch.cli.convert -> .npz
        -> load_f5_checkpoint -> TTSEngine.synthesize_rows -> wave

The ``.pt`` holds ``model_state_dict`` and ``ema_model_state_dict``
(``ema_model.*`` keys, ``initted``/``step``, the stale
``mel_spec.mel_stft.*`` buffers a loader must drop), as the reference
trainer writes it. Its weights are a seeded ``init_dit_numpy`` tree at F5-TTS
Base width with IndicF5's 2545-symbol vocabulary, exported to the reference's
key layout; the EMA dict is the same leaves plus ``1e-3`` seeded normal
noise, so a loader that took the online dict would fail the check.

Parity: two fp32 ``sample_cfm`` solves from one explicit ``y0`` (the
reference's per-row ``torch.manual_seed(77)`` noise), Euler at ``--nfe``:
the tree read back from the ``.npz`` against the EMA tree held in memory
(``mel_rel``, bit-equal expected: the file path moves floats without
arithmetic), and the online tree, which must differ by more than 1e-4
relative. ``run(...)`` is the work of ``main`` at any ``DiTConfig``.

    python -m f5tts_tpu_torch.scripts.e2e_real_ckpt --dtype bf16          # one CUDA card
    python -m f5tts_tpu_torch.scripts.e2e_real_ckpt --device cpu --nfe 2 --bucket 256

The ``.pt`` (~2.7 GB at Base), its ``.npz`` and vocabulary live under the
temporary directory and are removed unless ``--keep-ckpt``; ``--out`` writes
the JSON result (default: stdout only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from f5tts_tpu_torch.engine.engine import EngineConfig, RowSpec, TTSEngine
from f5tts_tpu_torch.models.convert import (convert_f5_dit, dit_params_from_numpy, export_f5_state_dict,
                                            init_dit_numpy, init_vocos_numpy, load_f5_checkpoint, strip_ema)
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.models.vocos import VocosConfig
from f5tts_tpu_torch.ops.mel import MelConfig
from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm
from f5tts_tpu_torch.text.tokenizer import Tokenizer
from f5tts_tpu_torch.train.tree import tree_leaves
from f5tts_tpu_torch.utils.device import resolve_device
from f5tts_tpu_torch.utils.timing import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
INDICF5_VOCAB = 2545
TEXT = "end to end checkpoint test"
REF_FRAMES, SEED = 64, 77
ONLINE_MIN_REL = 1e-4  # the online tree's solve must differ at least this much
PARITY_REL = 1e-6  # the file's solve against the in-memory EMA solve (bit-equal expected)


def base_config() -> DiTConfig:
    return dataclasses.replace(DiTConfig.base(), text_num_embeds=INDICF5_VOCAB)


def make_checkpoint(path: str, cfg: DiTConfig, seed: int = 0) -> tuple[dict, dict, int]:
    """Write the trainer-layout ``.pt`` of a seeded tree; returns the online
    and the EMA state dicts as written (numpy; the EMA one with its
    ``ema_model.`` keys and stale buffers) and the parameter count."""
    online = export_f5_state_dict(init_dit_numpy(cfg, seed), cfg)
    n_params = sum(v.size for v in online.values())
    rng = np.random.default_rng(seed + 1)
    # the reference CFM's mel front end, as stale buffers a loader must drop
    stale = {"mel_spec.mel_stft.mel_scale.fb": np.zeros((513, cfg.mel_dim), np.float32),
             "mel_spec.mel_stft.spectrogram.window": np.hanning(1024).astype(np.float32)}
    ema = {"ema_model." + k: v + np.float32(1e-3) * rng.standard_normal(v.shape, dtype=np.float32)
           for k, v in online.items()}
    ema.update({"ema_model." + k: v for k, v in stale.items()})

    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

    ckpt = {"model_state_dict": tensors({**online, **stale}),
            "ema_model_state_dict": {**tensors(ema), "initted": torch.tensor(True), "step": torch.tensor(123_456)},
            "scheduler_state_dict": {}, "step": 123_456}
    torch.save(ckpt, path)
    return online, ema, n_params


def write_vocab(path: str, size: int) -> None:
    """A vocabulary of ``size`` lines: the space, then ``tok0`` ... (the
    checkpoint's text embedding has ``size + 1`` rows)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(" \n")
        for i in range(size - 1):
            f.write(f"tok{i}\n")


def convert(pt: str, vocab: str, npz: str, in_process: bool = False) -> None:
    """The port's convert CLI on the checkpoint (``--model F5TTS_Base``): a
    subprocess, as a user runs it, or ``main`` in this process."""
    argv = ["--ckpt", pt, "--model", "F5TTS_Base", "--vocab", vocab, "--out", npz]
    if in_process:
        from f5tts_tpu_torch.cli import convert as cli

        cli.main(argv)
        return
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    subprocess.run([sys.executable, "-m", "f5tts_tpu_torch.cli.convert", *argv], check=True, cwd=REPO, env=env)


def parity_inputs(tokenizer: Tokenizer, text_pad: int, bucket: int, cond_mel: np.ndarray, duration: int,
                  mel_dim: int) -> dict:
    """The parity solve's numpy inputs: one row, the reference's noise."""
    text_ids = tokenizer.encode([TEXT], pad_to=text_pad)
    cond = np.zeros((1, bucket, mel_dim), np.float32)
    cond[0, :REF_FRAMES] = cond_mel
    y0 = np.zeros((1, bucket, mel_dim), np.float32)
    y0[0, :duration] = torch.randn(duration, mel_dim, generator=torch.Generator().manual_seed(SEED)).numpy()
    return {"cond": cond, "cond_lens": np.array([REF_FRAMES], np.int32), "text": text_ids,
            "duration": np.array([duration], np.int32), "y0": y0}


def parity_solve(tree: dict, cfg: DiTConfig, inputs: dict, nfe: int, device) -> np.ndarray:
    """fp32 Euler solve of ``tree`` from ``inputs``' explicit noise."""
    params = dit_params_from_numpy(tree, device, torch.float32)
    t = {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}
    mel = sample_cfm(params, cfg, cond=t["cond"], cond_lens=t["cond_lens"], text=t["text"], duration=t["duration"],
                     sampler=SamplerConfig(method="euler", steps=nfe), y0=t["y0"], compute_dtype=torch.float32)
    return mel.cpu().numpy()


def _rel(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    err = float(np.sqrt(np.mean((got - want) ** 2)))
    return err, err / max(float(np.sqrt(np.mean(want**2))), 1e-9)


def run(cfg: DiTConfig, voc_cfg: VocosConfig, ckpt: str, *, nfe: int = 4, bucket: int = 512, dtype: str = "float32",
        device="cuda", in_process: bool = False, keep_ckpt: bool = False, log=print) -> tuple[dict, dict]:
    """The checkpoint written, converted, served and checked: ``(result,
    arrays)``; ``arrays`` holds the parity inputs and the three solves' mels
    (``loaded``, ``ema``, ``online``) and the paths of the files."""
    dev = resolve_device(device)
    card = card_line(dev)
    stem = ckpt[:-3] if ckpt.endswith(".pt") else ckpt
    npz, vocab = stem + ".npz", stem + "_vocab.txt"
    try:
        t0 = time.perf_counter()
        online_sd, ema_sd, n_params = make_checkpoint(ckpt, cfg)
        size_gb = os.path.getsize(ckpt) / 1e9
        log(f"wrote {ckpt}: {n_params / 1e6:.1f}M params, {size_gb:.2f} GB, {time.perf_counter() - t0:.1f} s "
            f"(host clock; {card})")
        write_vocab(vocab, cfg.text_num_embeds)
        t0 = time.perf_counter()
        convert(ckpt, vocab, npz, in_process)
        log(f"convert CLI -> {npz} ({time.perf_counter() - t0:.1f} s, host clock; {card})")

        t0 = time.perf_counter()
        tree = load_f5_checkpoint(npz, cfg)
        n_loaded = sum(v.size for _, v in tree_leaves(tree))
        if n_loaded != n_params:
            raise RuntimeError(f"the .npz holds {n_loaded} parameters, the checkpoint {n_params}")
        log(f"load_f5_checkpoint({npz}): {n_loaded / 1e6:.1f}M params ({time.perf_counter() - t0:.1f} s, host "
            f"clock; {card})")

        rng = np.random.default_rng(0)
        cond_mel = (rng.standard_normal((REF_FRAMES, cfg.mel_dim)) * 0.5 - 1.0).astype(np.float32)
        duration = min(bucket - 16, 256 + REF_FRAMES)
        engine = TTSEngine(tree, cfg, init_vocos_numpy(voc_cfg, seed=1), Tokenizer.from_texts([TEXT]),
                           EngineConfig(mel=MelConfig(n_mels=cfg.mel_dim), vocoder=voc_cfg,
                                        sampler=SamplerConfig(method="euler", steps=nfe),
                                        duration_buckets=(bucket,), batch_buckets=(1,), compute_dtype=dtype),
                           device=dev)
        row = RowSpec(text=TEXT, cond_mel=cond_mel, ref_frames=REF_FRAMES, duration=duration, steps=nfe,
                      cfg_strength=2.0, seed=SEED)
        t0 = time.perf_counter()
        wave, mel = engine.synthesize_rows([row])[0]
        log(f"engine ({dtype}): wave {wave.shape}, mel {mel.shape} in {time.perf_counter() - t0:.3f} s on {card} "
            f"(first call, host clock)")
        if not (np.isfinite(wave).all() and np.abs(wave).max() > 0):
            raise RuntimeError("the engine's wave is not finite or silent")
        inputs = parity_inputs(engine.tokenizer, engine.cfg.text_pad, bucket, cond_mel, duration, cfg.mel_dim)
        del engine

        # the dicts held in memory since they were written, as trees
        ema_tree, online_tree = convert_f5_dit(strip_ema(ema_sd), cfg), convert_f5_dit(online_sd, cfg)
        del ema_sd, online_sd
        t0 = time.perf_counter()
        mels = {name: parity_solve(t, cfg, inputs, nfe, dev)
                for name, t in (("loaded", tree), ("ema", ema_tree), ("online", online_tree))}
        log(f"three fp32 parity solves in {time.perf_counter() - t0:.3f} s on {card} (host clock)")
    finally:
        if not keep_ckpt:
            for path in (ckpt, npz, vocab):
                if os.path.exists(path):
                    os.remove(path)

    gen = slice(REF_FRAMES, duration)
    err, rel = _rel(mels["loaded"][0, gen], mels["ema"][0, gen])
    _, online_rel = _rel(mels["online"][0, gen], mels["ema"][0, gen])
    ok = rel <= PARITY_REL and online_rel > ONLINE_MIN_REL
    log(f"mel parity, .npz tree vs in-memory EMA tree: rmse {err:.3e} (rel {rel:.3e}, tol {PARITY_REL}); online "
        f"tree rel {online_rel:.3e} (must exceed {ONLINE_MIN_REL})")
    result = {"params_m": n_params / 1e6, "ckpt_gb": size_gb, "nfe": nfe, "bucket": bucket, "device": dev.type,
              "dtype": dtype, "mel_rmse": err, "mel_rel": rel, "online_mel_rel": online_rel, "parity_ok": ok,
              "wave_samples": int(wave.shape[0]), "card": card}
    return result, {"inputs": inputs, "mels": mels, "pt": ckpt, "npz": npz, "vocab": vocab}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.e2e_real_ckpt")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"], help="the engine's compute dtype")
    p.add_argument("--nfe", type=int, default=4, help="Euler steps of the engine and the parity solves")
    p.add_argument("--bucket", type=int, default=512)
    p.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "f5_base_e2e.pt"))
    p.add_argument("--keep-ckpt", action="store_true")
    p.add_argument("--out", default=None, help="JSON result file (default: stdout only)")
    args = p.parse_args(argv)
    result, _ = run(base_config(), VocosConfig(), args.ckpt, nfe=args.nfe, bucket=args.bucket,
                    dtype="float32" if args.dtype == "f32" else "bfloat16", device=args.device,
                    keep_ckpt=args.keep_ckpt)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if not result["parity_ok"]:
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
