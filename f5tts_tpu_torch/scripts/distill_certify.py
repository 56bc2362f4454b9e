"""Distill a few-step student from a toy-trained field and certify it
(counterpart of ``scripts/distill_certify.py``).

Per run: toy-train a teacher at the given geometry on structured synthetic
data -> solve the 512-step Euler truth (in 64-knot segments) and the Euler-32
recipe on the certification prompts -> distill a K-step student
(``train/distill.py``) on random prompts of the same family (never the
certification prompts) -> measure each solve's error to the truth.

Certified = the student's mel-L2 to truth <= the recipe's own mel-L2 to
truth: its K-forward rollout (guidance in the weights, no CFG pair) is at
least as accurate a solve of the same guided ODE.

    python -m f5tts_tpu_torch.scripts.distill_certify --geometry tiny --toy-train 1000 \\
        --student-steps 8 --distill-steps 300 --device cpu
    python -m f5tts_tpu_torch.scripts.distill_certify --geometry base --toy-train 1500 \\
        --dtype bf16 --solve-cache /tmp/dc1500          # one CUDA card

``run(...)`` is the same pipeline as a function (it returns the result dict).
Runs on ``cuda`` unless ``--device cpu``. The noise is the port's per-row
seeded noise, so its errors are the port's own, not the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from f5tts_tpu_torch.eval.quality import quality_report
from f5tts_tpu_torch.models.convert import load_params_npz, params_from_numpy, save_params_npz
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm, sample_noise_from_seeds
from f5tts_tpu_torch.scripts.quality_harness import (CONFIGS, TINY, build_prompts, n_forwards,  # noqa: F401
                                                      structured_toy_batch, toy_field)
from f5tts_tpu_torch.train.distill import DistillConfig, deepen_student, distill, student_sampler
from f5tts_tpu_torch.train.tree import tree_map
from f5tts_tpu_torch.utils.device import resolve_device

SEGMENT_STEPS = 64  # a long solve runs as segments of this many knots


def make_prompt_fn(cfg: DiTConfig, batch: int, bucket: int, cond_frames: int):
    """Random serving-shaped prompts of the certification family, drawn fresh
    per training step (the certification prompts are held out)."""

    def prompt_fn(rng: np.random.Generator):
        t = np.arange(cond_frames)[:, None] / 93.75
        freqs = rng.uniform(0.5, 4.0, (batch, 1, cfg.mel_dim))
        phase = rng.uniform(0, 2 * np.pi, (batch, 1, cfg.mel_dim))
        cond = np.zeros((batch, bucket, cfg.mel_dim), np.float32)
        cond[:, :cond_frames] = np.sin(2 * np.pi * freqs * t[None] + phase) * 0.7 - 1.5
        durations = rng.integers(int(0.6 * bucket), bucket + 1, (batch,)).astype(np.int32)
        nt = int(0.12 * bucket)
        text = rng.integers(0, cfg.text_num_embeds, (batch, nt)).astype(np.int32)
        for r in range(batch):
            text[r, rng.integers(nt // 2, nt + 1):] = -1
        return {"cond": cond, "cond_lens": np.full((batch,), cond_frames, np.int32), "text": text,
                "duration": durations, "seeds": rng.integers(1 << 20, 1 << 30, (batch,)).astype(np.int32)}

    return prompt_fn


_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def run(geometry: str = "tiny", toy_train_steps: int = 500, student_steps: int = 8, substeps: int = 8,
        distill_steps: int = 300, distill_batch: int = 4, lr: float = 1e-4, prompts: int = 6,
        bucket: int | None = None, cond_frames: int | None = None, dtype: str = "f32",
        distill_dtype: str | None = None, device=None, sway: float = -1.0, progressive: str | None = None,
        knot_weighting: str = "none", loss_chunk: int = -1, deepen: int = 1, solve_cache: str | None = None,
        out: str | None = None, log=print) -> dict:
    """The certification pipeline; returns (and writes to ``out``, if given)
    the result dict with one row per solve: forwards, mel-L2 and MCD to the
    truth, the ratio to the recipe's error, certified or not."""
    dev = resolve_device(device)
    say = log or (lambda *a: None)
    if geometry == "tiny":
        cfg, bucket, cond_frames = TINY, bucket or 128, cond_frames or 24
    else:
        cfg = DiTConfig.base() if geometry == "base" else DiTConfig.small()
        bucket, cond_frames = bucket or 1024, cond_frames or 128
    cd = _DTYPES[dtype]

    tpath = os.path.join(solve_cache, "teacher.npz") if solve_cache else None
    if tpath and os.path.exists(tpath):
        teacher = params_from_numpy(load_params_npz(tpath), dev)
        say(f"loaded teacher from {tpath}")
    else:
        say(f"toy-training {toy_train_steps} steps at {geometry}...")
        t0 = time.perf_counter()
        teacher = toy_field(cfg, toy_train_steps, dev, log=log)
        say(f"  toy-train {time.perf_counter() - t0:.0f}s")
        if tpath:
            os.makedirs(solve_cache, exist_ok=True)
            save_params_npz(tpath, tree_map(lambda t: t.cpu().numpy(), teacher))

    cond, lens, text, durations, seeds = build_prompts(cfg, prompts, bucket, cond_frames)
    gen_mask = (np.arange(bucket)[None, :] >= lens[:, None]) & (np.arange(bucket)[None, :] < durations[:, None])
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    prompt_kw = dict(cond=as_dev(cond), cond_lens=as_dev(lens), text=as_dev(text), duration=as_dev(durations))
    y0 = sample_noise_from_seeds(seeds, bucket, cfg.mel_dim, as_dev(durations), cd)

    def solve(params, sampler, model_cfg=None):
        mcfg = model_cfg or cfg
        steps = sampler.steps
        if steps <= SEGMENT_STEPS:
            out_ = sample_cfm(params, mcfg, sampler=sampler, y0=y0, compute_dtype=cd, **prompt_kw)
        else:
            out_ = y0
            for a in range(0, steps, SEGMENT_STEPS):
                b = min(a + SEGMENT_STEPS, steps)
                out_ = sample_cfm(params, mcfg, sampler=sampler, y0=out_, compute_dtype=cd, knot_range=(a, b),
                                  paste_back=(b == steps), **prompt_kw)
        return out_.float().cpu().numpy()

    def cached(name, fn):
        if not solve_cache:
            return fn()
        os.makedirs(solve_cache, exist_ok=True)
        path = os.path.join(solve_cache, f"{name}.npy")
        if os.path.exists(path):
            say(f"loaded {name} from cache")
            return np.load(path)
        arr = fn()
        np.save(path, arr)
        return arr

    t0 = time.perf_counter()
    truth = cached("truth", lambda: solve(teacher, CONFIGS["truth"]))
    say(f"truth solved {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    recipe = cached("recipe", lambda: solve(teacher, CONFIGS["base"]))
    say(f"recipe solved {time.perf_counter() - t0:.1f}s")
    recipe_err = quality_report(recipe, truth, gen_mask)["mel_l2"]
    say(f"recipe err-to-truth: {recipe_err:.5f}")

    prompt_fn = make_prompt_fn(cfg, distill_batch, bucket, cond_frames)
    ddtype = cd if distill_dtype is None else _DTYPES[distill_dtype]
    student_cfg, student_init = cfg, teacher
    if deepen > 1:
        student_init, student_cfg = deepen_student(teacher, cfg, deepen)
        say(f"capacity sweep: student depth {cfg.depth} -> {student_cfg.depth} (identity-init copies)")

    ladder = [int(k) for k in progressive.split(",")] if progressive else [student_steps]
    student_steps = ladder[-1]
    t0 = time.perf_counter()
    cur_teacher, cur_single = student_init, False
    for stage, K in enumerate(ladder):
        if loss_chunk == -1:  # auto: the largest divisor of K with chunk * batch <= 16 gradient rows
            kc = max(c for c in range(1, K + 1) if K % c == 0 and c * distill_batch <= 16)
        else:
            kc = loss_chunk
        dcfg = DistillConfig(student_steps=K, substeps=substeps, learning_rate=lr, lr_decay_steps=distill_steps,
                             sway_sampling_coef=None if np.isnan(sway) else sway, teacher_single_branch=cur_single,
                             knot_weighting=knot_weighting, loss_chunk=0 if kc >= K else kc)
        say(f"distilling stage {stage + 1}/{len(ladder)}: K={K} m={substeps} "
            f"teacher={'student' if cur_single else 'cfg-pair'} for {distill_steps} steps...")
        student = distill(cur_teacher, student_cfg, dcfg, prompt_fn, distill_steps, compute_dtype=ddtype, logger=log,
                          device=dev)
        cur_teacher, cur_single = student, True
    distill_s = time.perf_counter() - t0
    say(f"  distill {distill_s:.1f}s")

    rows = []
    teacher_at_k = SamplerConfig(steps=student_steps, cfg_strength=2.0, sway_sampling_coef=-1.0)
    for name, params, sampler, mcfg in (
        ("recipe euler-32", teacher, CONFIGS["base"], cfg),
        (f"student K={student_steps}", student, student_sampler(dcfg), student_cfg),
        ("teacher euler@K (ablation)", teacher, teacher_at_k, cfg),
    ):
        got = recipe if name.startswith("recipe") else solve(params, sampler, mcfg)
        rep = quality_report(got, truth, gen_mask)
        ratio = rep["mel_l2"] / max(recipe_err, 1e-12)
        fwd = n_forwards(sampler) * (deepen if name.startswith("student") else 1)  # a deepened forward costs more
        rows.append({"name": name, "forwards": fwd, "mel_l2": rep["mel_l2"], "mcd_db": rep["mcd_db"],
                     "x_recipe_err": ratio, "certified": bool(ratio <= 1.0 + 1e-9)})
        say(f"| {name} | {fwd} | {rep['mel_l2']:.5f} | {ratio:.3f} | {'YES' if ratio <= 1.0 else 'no'} |")

    result = {"geometry": geometry, "toy_train": toy_train_steps, "student_steps": student_steps,
              "substeps": substeps, "distill_steps": distill_steps, "distill_batch": distill_batch, "dtype": dtype,
              "bucket": bucket, "recipe_err": recipe_err, "progressive": progressive,
              "knot_weighting": knot_weighting, "deepen": deepen, "sway": sway, "device": str(dev),
              "distill_s": distill_s, "rows": rows}
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
        say(f"wrote {out}")
    return result


def main(argv=None):
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.distill_certify")
    p.add_argument("--geometry", default="tiny", choices=["tiny", "small", "base"])
    p.add_argument("--toy-train", type=int, default=500)
    p.add_argument("--student-steps", type=int, default=8)
    p.add_argument("--substeps", type=int, default=8)
    p.add_argument("--distill-steps", type=int, default=300)
    p.add_argument("--distill-batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--prompts", type=int, default=6)
    p.add_argument("--bucket", type=int, default=None)
    p.add_argument("--cond-frames", type=int, default=None)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--distill-dtype", default=None, choices=[None, "f32", "bf16"],
                   help="compute dtype of the distillation steps only (the certification solves keep --dtype)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--sway", type=float, default=-1.0, help="student knot-grid sway coefficient (nan = uniform)")
    p.add_argument("--progressive", default=None,
                   help="comma ladder of K values, e.g. '32,16,8': later stages distill from the previous "
                        "(single-branch) student; --distill-steps per stage; overrides --student-steps")
    p.add_argument("--knot-weighting", default="none", choices=["none", "adaptive"])
    p.add_argument("--loss-chunk", type=int, default=-1,
                   help="knots per gradient chunk (-1 = auto: the largest divisor of K with chunk * batch <= 16 "
                        "rows; 0 = single shot)")
    p.add_argument("--deepen", type=int, default=1, help="student depth multiplier (identity-init copies)")
    p.add_argument("--solve-cache", default=None)
    p.add_argument("--out", default="DISTILL_TORCH.json")
    a = p.parse_args(argv)
    return run(a.geometry, a.toy_train, a.student_steps, a.substeps, a.distill_steps, a.distill_batch, a.lr,
               a.prompts, a.bucket, a.cond_frames, a.dtype, a.distill_dtype, a.device, a.sway, a.progressive,
               a.knot_weighting, a.loss_chunk, a.deepen, a.solve_cache, a.out)


if __name__ == "__main__":
    main()
