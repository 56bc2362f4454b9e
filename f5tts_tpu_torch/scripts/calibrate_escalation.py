"""Calibrate the ``quality="strict"`` escalation threshold
(``EngineConfig.strict_threshold``) on the toy-field ladder (counterpart of
``scripts/calibrate_escalation.py``).

For each field (toy-train depth -> field sharpness): the serving default's
true solver error against the recipe's (``x recipe-err``, the certification
quantity of ``quality_harness``), and the per-row error estimate the default
solve gives for free (``sample_cfm(return_error_estimate=True)``). A usable
threshold separates the fields where the default certifies (ratio <= 1)
from those where it does not.

    python -m f5tts_tpu_torch.scripts.calibrate_escalation --device cpu      # the tiny ladder
    python -m f5tts_tpu_torch.scripts.calibrate_escalation --geometry base \\
        --fields 400,800,1500 --truth-steps 512                            # one CUDA card

``calibrate(...)`` is the work of ``main`` on given fields and noise. A
field is toy-trained only when one of its solves is not in
``--solve-cache`` (``f{depth}_{tag}.npz``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_noise_from_seeds
from f5tts_tpu_torch.scripts.quality_harness import build_prompts, gen_mask, geometry, make_solver, toy_field
from f5tts_tpu_torch.utils.device import resolve_device

DEFAULT = SamplerConfig(method="ralston", steps=10, cfg_strength=2.0, sway_sampling_coef=-1.0)
RECIPE = SamplerConfig(method="euler", steps=32, cfg_strength=2.0, sway_sampling_coef=-1.0)


def calibrate(fields: dict, cfg: DiTConfig, y0: torch.Tensor, prompts, truth_steps: int = 512,
              dtype: torch.dtype = torch.float32, solve_cache: str | None = None, log=print) -> list[dict]:
    """One row per field. ``fields`` maps a toy-train depth to a callable that
    gives that field's params (called only when a solve is not cached)."""
    mask = gen_mask(prompts[1], prompts[3], prompts[0].shape[1])
    rows = []
    for depth, field in fields.items():
        if log:
            log(f"--- field: toy-train {depth} ---")
        solver = []

        def solve(sampler, estimate=False, tag=""):
            cpath = os.path.join(solve_cache, f"f{depth}_{tag}.npz") if solve_cache else None
            if cpath and os.path.exists(cpath):
                z = np.load(cpath)
                return (z["mel"], z["est"]) if estimate else z["mel"]
            if not solver:
                solver.append(make_solver(field(), cfg, prompts, y0, dtype, log))
            t0 = time.perf_counter()
            out = solver[0](sampler, estimate)
            mel, est = out if estimate else (out, None)
            if log:
                log(f"  solved {tag or sampler.method}{sampler.steps} in {time.perf_counter() - t0:.0f}s")
            if cpath:
                os.makedirs(solve_cache, exist_ok=True)
                np.savez(cpath, mel=mel, est=est if est is not None else np.zeros(1))
            return out

        truth = solve(SamplerConfig(method="euler", steps=truth_steps, cfg_strength=2.0, sway_sampling_coef=-1.0),
                      tag="truth")
        recipe_mel = solve(RECIPE, tag="recipe")
        default_mel, est = solve(DEFAULT, estimate=True, tag="default")

        def err(x):
            d = (np.asarray(x, np.float64) - truth.astype(np.float64)) ** 2 * mask[..., None]
            return np.sqrt(d.sum(axis=(1, 2)) / (mask.sum(axis=1) * cfg.mel_dim))

        err_recipe, err_default = err(recipe_mel), err(default_mel)
        row = {
            "field": depth,
            "recipe_err": float(np.sqrt(np.mean(err_recipe**2))),
            "default_err": float(np.sqrt(np.mean(err_default**2))),
            "ratio": float(np.sqrt(np.mean(err_default**2)) / np.sqrt(np.mean(err_recipe**2))),
            "est_mean": float(est.mean()),
            "est_max": float(est.max()),
            "est_per_row": est.tolist(),
            "ratio_per_row": (err_default / np.maximum(err_recipe, 1e-12)).tolist(),
        }
        rows.append(row)
        if log:
            log(json.dumps(row, indent=1))
    return rows


_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.calibrate_escalation")
    p.add_argument("--geometry", default="tiny", choices=["tiny", "base"])
    p.add_argument("--fields", default="200,500,1000,2000", help="comma list of toy-train depths (one field each)")
    p.add_argument("--prompts", type=int, default=6)
    p.add_argument("--truth-steps", type=int, default=512)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default="CALIBRATION.json")
    p.add_argument("--solve-cache", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, bucket, cond_frames = geometry(args.geometry)
    dtype = _DTYPES[args.dtype]
    prompts = build_prompts(cfg, args.prompts, bucket, cond_frames)
    y0 = sample_noise_from_seeds(prompts[4], bucket, cfg.mel_dim, torch.as_tensor(prompts[3], device=dev), dtype)
    fields = {d: (lambda d=d: toy_field(cfg, d, dev)) for d in (int(v) for v in args.fields.split(","))}
    rows = calibrate(fields, cfg, y0, prompts, args.truth_steps, dtype, args.solve_cache)

    print("\n| field | x recipe-err | est mean | est max | certified |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['field']} | {r['ratio']:.2f} | {r['est_mean']:.4f} "
              f"| {r['est_max']:.4f} | {'YES' if r['ratio'] <= 1.0 else 'no'} |")
    ok = [r for r in rows if r["ratio"] <= 1.0]
    bad = [r for r in rows if r["ratio"] > 1.0]
    if ok and bad:
        lo = max(r["est_max"] for r in ok)
        hi = min(r["est_mean"] for r in bad)
        print(f"\nseparating threshold range: ({lo:.4f}, {hi:.4f}) "
              f"{'— SEPARABLE' if lo < hi else '— NOT separable at per-field granularity'}")
    result = {"geometry": args.geometry, "rows": rows}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
