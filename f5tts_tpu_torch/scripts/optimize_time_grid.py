"""Search ODE knot grids for the RK2 serving default (counterpart of
``scripts/optimize_time_grid.py``).

The sway warp (``t + s(cos(pi t / 2) - 1 + t)``) was tuned for Euler; a
second-order integrator may prefer other knots. This searches knot grids for
Ralston at K intervals against the certification standard: mel-L2 to a
512-step truth solve of the same guided ODE over the Euler-32 recipe's own
distance, on toy-trained tiny-geometry fields at several smoothness levels
(500/1000/2000 train steps). Objective: the worst ratio over the fields.
The knots reach the sampler as a tensor (``time_grid_array``), so every
candidate is one solve.

    python -m f5tts_tpu_torch.scripts.optimize_time_grid --intervals 8,10 --device cpu

Writes the best grid per K and its per-field ratios to ``--out``. A found
grid ships only after ``quality_harness --extra-grid`` certifies it.
``search(...)`` is the work of ``main`` on given fields and noise;
``descend(...)`` is the coordinate descent both grid searches share.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from f5tts_tpu_torch.eval.quality import mel_l2
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm, sample_noise_from_seeds
from f5tts_tpu_torch.scripts.quality_harness import build_prompts, gen_mask, geometry, prompt_tensors, toy_field
from f5tts_tpu_torch.utils.device import resolve_device


def sway_knots(k: int, coef: float = -1.0) -> np.ndarray:
    t = np.linspace(0.0, 1.0, k + 1)
    return t + coef * (np.cos(np.pi / 2 * t) - 1 + t)


def grid_solver(cfg: DiTConfig, k: int, prompts, y0: torch.Tensor):
    """``solve(params, knots)``: the fp32 numpy mel of a Ralston solve on the
    ``k + 1`` knots, fp32, from ``y0``."""
    kw = prompt_tensors(prompts, y0.device)
    sampler = SamplerConfig(steps=k, method="ralston")

    def solve(params, knots) -> np.ndarray:
        knots = torch.as_tensor(np.asarray(knots, np.float32), device=y0.device)
        return sample_cfm(params, cfg, sampler=sampler, time_grid_array=knots, y0=y0, **kw).float().cpu().numpy()

    return solve


def descend(worst, k: int, sweeps: int, margin: float, log=print, label: str = "worst-ratio") -> tuple[np.ndarray, float]:
    """The best of a parametrized family (sway coefficient x power warp), then
    coordinate descent on the interior knots: a move is taken when it lowers
    ``worst(knots)`` by more than ``margin``; the step halves after a sweep
    that took none."""
    best_g, best_s = None, np.inf
    for coef in (None, -0.5, -0.8, -1.0, -1.2, -1.5):
        for pw in (0.75, 0.9, 1.0, 1.15, 1.4):
            t = np.linspace(0.0, 1.0, k + 1) ** pw
            g = t if coef is None else t + coef * (np.cos(np.pi / 2 * t) - 1 + t)
            s = worst(g)
            if s < best_s:
                best_g, best_s = g, s
    if log:
        log(f"k={k}: family init {label} {best_s:.3f}")
    step = 0.25
    for sweep in range(sweeps):
        improved = False
        for i in range(1, k):
            for sign in (+1, -1):
                g = best_g.copy()
                lo, hi = g[i - 1], g[i + 1]
                g[i] = np.clip(g[i] + sign * step * (hi - lo), lo + 0.02 * (hi - lo), hi - 0.02 * (hi - lo))
                s = worst(g)
                if s < best_s - margin:
                    best_g, best_s = g, s
                    improved = True
        if log:
            log(f"k={k} sweep {sweep}: {label} {best_s:.3f}")
        if not improved:
            step *= 0.5
    return best_g, best_s


def search(fields: dict, cfg: DiTConfig, y0: torch.Tensor, prompts, intervals, sweeps: int = 6,
           log=print) -> dict:
    """``{k: result}`` for each K in ``intervals``; ``fields`` maps a toy-train
    length to its params (tensors on ``y0``'s device)."""
    mask = gen_mask(prompts[1], prompts[3], prompts[0].shape[1])
    kw = prompt_tensors(prompts, y0.device)
    truths, base_errs = {}, {}
    for fs, params in fields.items():
        truths[fs] = sample_cfm(params, cfg, sampler=SamplerConfig(steps=512), y0=y0, **kw).float().cpu().numpy()
        base = sample_cfm(params, cfg, sampler=SamplerConfig(steps=32), y0=y0, **kw).float().cpu().numpy()
        base_errs[fs] = mel_l2(base, truths[fs], mask)
        if log:
            log(f"field {fs}: recipe err {base_errs[fs]:.5f}")

    results = {}
    for k in intervals:
        solve = grid_solver(cfg, k, prompts, y0)

        def ratios(knots) -> dict:
            return {fs: mel_l2(solve(fields[fs], knots), truths[fs], mask) / base_errs[fs] for fs in fields}

        def worst(knots) -> float:
            return max(ratios(knots).values())

        best_g, best_s = descend(worst, k, sweeps, 1e-4, log)
        results[k] = {
            "knots": [round(float(v), 6) for v in best_g],
            "worst_ratio": round(best_s, 4),
            "per_field_ratio": {str(fs): round(v, 4) for fs, v in ratios(best_g).items()},
            "sway_baseline_worst": round(worst(sway_knots(k)), 4),
            "nfe_per_branch": 2 * k,
        }
        if log:
            log(f"k={k}: best {json.dumps(results[k])}")
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.optimize_time_grid")
    p.add_argument("--intervals", default="8,10")
    p.add_argument("--fields", default="500,1000,2000")
    p.add_argument("--prompts", type=int, default=6)
    p.add_argument("--sweeps", type=int, default=6)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default="TIME_GRID_SEARCH.json")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, bucket, cond_frames = geometry("tiny")
    prompts = build_prompts(cfg, args.prompts, bucket, cond_frames)
    y0 = sample_noise_from_seeds(prompts[4], bucket, cfg.mel_dim, torch.as_tensor(prompts[3], device=dev))
    field_steps = [int(v) for v in args.fields.split(",")]
    fields = {}
    for fs in field_steps:
        print(f"toy-training field ({fs} steps)...", flush=True)
        fields[fs] = toy_field(cfg, fs, dev)
    results = search(fields, cfg, y0, prompts, [int(v) for v in args.intervals.split(",")], args.sweeps)
    out = {"geometry": "tiny", "standard": "mel-L2 to 512-step truth / recipe's own error, worst field",
           "fields": field_steps, "results": results}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
