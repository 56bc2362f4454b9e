"""Knot-grid search at Base geometry (counterpart of
``scripts/optimize_time_grid_base.py``).

Grids found at the tiny geometry did not carry over to Base, so this
searches on Base-geometry toy-trained fields directly, each candidate one
Ralston solve with the knots as a tensor, against the cached 512-step truth
and Euler-32 recipe of the Base certification (``quality_harness
--solve-cache``: ``truth.npy`` and ``base.npy``). The winner must then be
certified on a holdout field (``quality_harness --extra-grid``) before any
default changes.

    python -m f5tts_tpu_torch.scripts.optimize_time_grid_base --intervals 8 --solve-cache /tmp/qbase

Each field's cache is ``--solve-cache`` for 400 steps and
``<solve-cache>_<N>`` for N; its toy-trained params are kept in
``<solve-cache>/field_params_<N>.npz``. ``search_base(...)`` is the work of
``main`` on given fields, caches and noise. Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from f5tts_tpu_torch.eval.quality import mel_l2
from f5tts_tpu_torch.models.convert import load_params_npz, params_from_numpy, save_params_npz
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.sampling.euler import sample_noise_from_seeds
from f5tts_tpu_torch.scripts.optimize_time_grid import descend, grid_solver
from f5tts_tpu_torch.scripts.quality_harness import build_prompts, gen_mask, geometry, toy_field
from f5tts_tpu_torch.train.tree import tree_map
from f5tts_tpu_torch.utils.device import resolve_device


def search_base(fields: dict, truths: dict, bases: dict, cfg: DiTConfig, y0: torch.Tensor, prompts, intervals,
                sweeps: int = 5, log=print) -> dict:
    """``{k: result}`` for each K; ``fields``, ``truths`` and ``bases`` map a
    toy-train length to its params, its truth mel and its recipe mel."""
    mask = gen_mask(prompts[1], prompts[3], prompts[0].shape[1])
    base_errs = {fs: mel_l2(bases[fs], truths[fs], mask) for fs in fields}
    results = {}
    for k in intervals:
        solve = grid_solver(cfg, k, prompts, y0)
        n_evals = [0]

        def ratios(knots) -> dict:
            n_evals[0] += 1
            return {fs: mel_l2(solve(fields[fs], knots), truths[fs], mask) / base_errs[fs] for fs in fields}

        t0 = time.perf_counter()
        best_g, best_s = descend(lambda g: max(ratios(g).values()), k, sweeps, 1e-3,
                                 log and (lambda m: log(f"{m} ({n_evals[0]} evals, {time.perf_counter() - t0:.0f}s)")),
                                 label="ratio")
        results[k] = {"knots": [round(float(v), 6) for v in best_g],
                      "worst_ratio": round(best_s, 4),
                      "per_field_ratio": {str(fs): round(v, 4) for fs, v in ratios(best_g).items()},
                      "nfe_per_branch": 2 * k, "evals": n_evals[0]}
        if log:
            log(f"k={k}: best {json.dumps(results[k])}")
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.optimize_time_grid_base")
    p.add_argument("--intervals", default="8")
    p.add_argument("--fields", default="400",
                   help="comma list of toy-train lengths; each needs its truth/base in --solve-cache (400) or "
                        "<solve-cache>_<N>; objective = the worst ratio over the fields")
    p.add_argument("--prompts", type=int, default=6)
    p.add_argument("--sweeps", type=int, default=5)
    p.add_argument("--solve-cache", default=os.path.join(tempfile.gettempdir(), "qbase_cache"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default="TIME_GRID_BASE.json")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, bucket, cond_frames = geometry("base")
    prompts = build_prompts(cfg, args.prompts, bucket, cond_frames)
    y0 = sample_noise_from_seeds(prompts[4], bucket, cfg.mel_dim, torch.as_tensor(prompts[3], device=dev))
    mask = gen_mask(prompts[1], prompts[3], bucket)

    field_steps = [int(v) for v in args.fields.split(",")]
    fields, truths, bases = {}, {}, {}
    for fs in field_steps:
        cdir = args.solve_cache if fs == 400 else f"{args.solve_cache}_{fs}"
        truths[fs] = np.load(os.path.join(cdir, "truth.npy"))
        bases[fs] = np.load(os.path.join(cdir, "base.npy"))
        print(f"field {fs}: recipe err (cached) {mel_l2(bases[fs], truths[fs], mask):.5f}", flush=True)
        pcache = os.path.join(args.solve_cache, f"field_params_{fs}.npz")
        if os.path.exists(pcache):
            fields[fs] = params_from_numpy(load_params_npz(pcache), dev)
            print(f"  params loaded from {pcache}", flush=True)
        else:
            print(f"  toy-training ({fs} steps)...", flush=True)
            fields[fs] = toy_field(cfg, fs, dev)
            save_params_npz(pcache, tree_map(lambda t: t.cpu().numpy(), fields[fs]))
    results = search_base(fields, truths, bases, cfg, y0, prompts, [int(v) for v in args.intervals.split(",")],
                          args.sweeps)
    out = {"geometry": "base", "search_fields": field_steps,
           "note": "search-field ratio only; certify on a holdout field before shipping", "results": results}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
