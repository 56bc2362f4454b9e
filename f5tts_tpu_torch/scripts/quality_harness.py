"""Certify reduced-compute sampler configurations against the reference
recipe (counterpart of ``scripts/quality_harness.py``).

The reference serves NFE 32 / CFG 2.0 / sway -1.0, guidance on every step.
Two measurements per knob, on a fixed prompt set with the same weights and
noise:

1. **Error to truth (the certification).** Every config, the recipe
   included, solves the same guided ODE; they differ only in how accurately
   they integrate it. "Truth" is a 512-step Euler solve on the same sway
   grid. A config is certified when its distance to truth is at or below the
   recipe's own.
2. **Drift from the recipe's output** (secondary): the distance to the
   NFE-32 recipe's output, against the recipe's own NFE 32 -> 64
   discretization distance (``anchor64``).

Weights: ``--ckpt`` (torch, ``.npz`` or a trainer directory, the JAX
package's orbax ones included) or a seeded random init at ``--geometry``,
optionally ``--toy-train N`` steps on structured synthetic data so the field
is a trained, smooth one. Writes a markdown table and the ``--out`` JSON.

    python -m f5tts_tpu_torch.scripts.quality_harness --geometry tiny --toy-train 300 --device cpu
    python -m f5tts_tpu_torch.scripts.quality_harness --geometry base --dtype bf16 \\
        --configs base,anchor64,ralston8,mid8,truth --solve-cache /tmp/qh     # one CUDA card

``certify(...)`` is the work of ``main`` on given params and noise (the
tests hand it the JAX package's). Runs on ``cuda`` unless ``--device cpu``;
the noise is the port's per-row seeded noise. Long solves run as segments of
``QH_SEGMENT_STEPS`` (64) knots.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from f5tts_tpu_torch.eval.quality import quality_report
from f5tts_tpu_torch.models.cfm import CFMConfig, cfm_draws, cfm_loss
from f5tts_tpu_torch.models.convert import init_dit_numpy, params_from_numpy
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.sampling.euler import EVALS_PER_STEP, SamplerConfig, sample_cfm, sample_noise_from_seeds
from f5tts_tpu_torch.train.trainer import adamw_apply, init_opt_state
from f5tts_tpu_torch.train.tree import tree_leaves, tree_map
from f5tts_tpu_torch.utils.device import resolve_device

TINY = DiTConfig(dim=64, depth=4, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=32, text_dim=32,
                 conv_layers=2)


def _cfg(steps: int, **kw) -> SamplerConfig:
    return SamplerConfig(steps=steps, cfg_strength=2.0, sway_sampling_coef=kw.pop("sway", -1.0), **kw)


CONFIGS: dict[str, SamplerConfig] = {
    "base": _cfg(32),
    "anchor64": _cfg(64),
    "truth": _cfg(512),
    # midpoint (RK2): 2 evals an interval, so midN costs 2N evals
    **{f"mid{n}": _cfg(n, method="midpoint") for n in (6, 8, 10, 16)},
    **{f"heun{n}": _cfg(n, method="heun") for n in (8, 10, 16)},
    **{f"ralston{n}": _cfg(n, method="ralston") for n in (8, 10, 16)},
    **{f"rk4_{n}": _cfg(n, method="rk4") for n in (4, 5, 8)},
    # r = the null branch reused within a step (the pair on the first eval only)
    **{f"mid{n}r": _cfg(n, method="midpoint", cfg_null_reuse=True) for n in (10, 12, 14)},
    **{f"heun{n}r": _cfg(n, method="heun", cfg_null_reuse=True) for n in (10, 12, 14)},
    **{f"rk4_{n}r": _cfg(n, method="rk4", cfg_null_reuse=True) for n in (5, 6, 8)},
    # sway-coefficient variants of the RK2 grid
    **{f"mid10_s{tag}": _cfg(10, sway=c, method="midpoint") for tag, c in (("0", None), ("05", -0.5), ("15", -1.5))},
    **{f"heun10_s{tag}": _cfg(10, sway=c, method="heun") for tag, c in (("0", None), ("05", -0.5))},
    "cache2": _cfg(32, cfg_cache_period=2),
    "cache4": _cfg(32, cfg_cache_period=4),
    "interval05": _cfg(32, cfg_interval=(0.0, 0.5)),
    "nfe16": _cfg(16),
    "nfe16_cache2": _cfg(16, cfg_cache_period=2),
    "cache2x": _cfg(32, cfg_cache_period=2, cfg_cache_mode="extrapolate"),
    "cache4x": _cfg(32, cfg_cache_period=4, cfg_cache_mode="extrapolate"),
    "nfe16_cache2x": _cfg(16, cfg_cache_period=2, cfg_cache_mode="extrapolate"),
}
SEGMENT_STEPS = 64  # a longer solve runs as segments of this many knots (QH_SEGMENT_STEPS overrides)


def structured_toy_batch(rng, cfg: DiTConfig, batch: int, n: int, frames_per_token: int = 8):
    """Synthetic text -> mel data with a learnable mapping: each token id paints
    a fixed spectral pattern over its frame span (plus small noise), so a few
    hundred CFM steps give a smooth trained flow field."""
    patterns = np.random.default_rng(0).standard_normal((cfg.text_num_embeds, cfg.mel_dim)) * 0.8 - 1.0
    nt = n // frames_per_token
    text = rng.integers(0, cfg.text_num_embeds, (batch, nt)).astype(np.int32)
    mel = np.repeat(patterns[text], frames_per_token, axis=1)[:, :n]
    mel = mel + rng.standard_normal(mel.shape) * 0.05
    lens = rng.integers(n // 2, n + 1, (batch,)).astype(np.int32)
    return mel.astype(np.float32), text, lens


def toy_train(params, cfg: DiTConfig, steps: int, batch: int = 8, n: int = 128, log=print):
    """``steps`` of the CFM loss with Adam at 3e-4 (no clip, no weight decay) on
    ``structured_toy_batch`` data; updates the params (tensors) in place."""
    ccfg = CFMConfig(model=cfg)
    leaves = [t for _, t in tree_leaves(params)]
    dev = leaves[0].device
    opt_state = init_opt_state(params, "adamw")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(1)
    for i in range(steps):
        mel, text, lens = (torch.as_tensor(a, device=dev) for a in structured_toy_batch(rng, cfg, batch, n))
        draws = cfm_draws(gen, lens, n, cfg.mel_dim, ccfg)
        loss, _ = cfm_loss(params, ccfg, draws, mel, text, lens)
        loss.backward()
        adamw_apply(params, [t.grad for t in leaves], opt_state, 3e-4, 0.0)
        for t in leaves:
            t.grad = None
        if log and (i % 50 == 0 or i == steps - 1):
            log(f"  toy-train step {i}: loss {float(loss):.4f}")
    return params


def toy_field(cfg: DiTConfig, steps: int, device, log=print):
    """The seeded random init (seed 0) after ``steps`` of ``toy_train``, detached."""
    params = tree_map(lambda t: t.requires_grad_(True), params_from_numpy(init_dit_numpy(cfg, seed=0), device))
    if steps:
        toy_train(params, cfg, steps, log=log)
    return tree_map(lambda t: t.detach(), params)


def n_forwards(s: SamplerConfig) -> int:
    """Batch-b forwards per solve (a fused 2b CFG pair counts 2)."""
    evals_per_step = EVALS_PER_STEP[s.method]
    if s.cfg_null_reuse and s.cfg_strength >= 1e-5:
        return s.steps * (2 + (evals_per_step - 1))
    steps = s.steps * evals_per_step
    if s.cfg_strength < 1e-5:
        return steps
    if s.cfg_cache_period > 1:
        k = s.cfg_cache_period
        groups = s.steps // k
        return steps + groups + (s.steps - groups * k)  # cond every step + null refreshes
    lo, hi = s.cfg_interval
    if (lo, hi) != (0.0, 1.0):
        t = np.linspace(0.0, 1.0, s.steps + 1)
        if s.sway_sampling_coef is not None:
            t = t + s.sway_sampling_coef * (np.cos(np.pi / 2 * t) - 1 + t)
        guided = int(np.sum((t[:-1] >= lo) & (t[:-1] < hi)))
        return evals_per_step * (2 * guided + (s.steps - guided))
    return 2 * steps


def build_prompts(cfg: DiTConfig, k: int, bucket: int, cond_frames: int, seed: int = 7):
    """The fixed certification prompts: smooth harmonic reference mels, text
    ids of varied lengths, durations spread over [60%, 100%] of the bucket,
    noise seeds 1000..1000+k."""
    rng = np.random.default_rng(seed)
    t = np.arange(cond_frames)[:, None] / 93.75
    freqs = rng.uniform(0.5, 4.0, (k, 1, cfg.mel_dim))
    phase = rng.uniform(0, 2 * np.pi, (k, 1, cfg.mel_dim))
    cond = np.zeros((k, bucket, cfg.mel_dim), np.float32)
    cond[:, :cond_frames] = np.sin(2 * np.pi * freqs * t[None] + phase) * 0.7 - 1.5
    durations = np.linspace(0.6 * bucket, bucket, k).astype(np.int32)
    nt = int(0.12 * bucket)
    text = rng.integers(0, cfg.text_num_embeds, (k, nt)).astype(np.int32)
    for r in range(k):
        text[r, int(nt * (0.5 + 0.5 * r / max(k - 1, 1))):] = -1
    seeds = np.arange(1000, 1000 + k, dtype=np.int32)
    lens = np.full((k,), cond_frames, np.int32)
    return cond, lens, text, durations, seeds


def geometry(name: str, bucket: int | None = None, cond_frames: int | None = None) -> tuple[DiTConfig, int, int]:
    """``(cfg, bucket, cond_frames)`` of ``tiny`` (128 / 24) or ``small`` / ``base`` (1024 / 128)."""
    if name == "tiny":
        return TINY, bucket or 128, cond_frames or 24
    return (DiTConfig.base() if name == "base" else DiTConfig.small()), bucket or 1024, cond_frames or 128


def gen_mask(lens: np.ndarray, durations: np.ndarray, bucket: int) -> np.ndarray:
    frames = np.arange(bucket)[None, :]
    return (frames >= lens[:, None]) & (frames < durations[:, None])


def prompt_tensors(prompts, device) -> dict:
    """``sample_cfm``'s prompt arguments from ``build_prompts``' arrays."""
    cond, lens, text, durations, _ = prompts
    return {k: torch.as_tensor(a, device=device) for k, a in
            (("cond", cond), ("cond_lens", lens), ("text", text), ("duration", durations))}


def make_solver(params, cfg: DiTConfig, prompts, y0: torch.Tensor, dtype: torch.dtype, log=print):
    """``solve(sampler, estimate=False)`` -> the fp32 numpy mel (and, with
    ``estimate``, the per-row error estimate) of one solve from ``y0``; a
    solve of more than ``QH_SEGMENT_STEPS`` knots runs as segments."""
    seg = int(os.environ.get("QH_SEGMENT_STEPS", SEGMENT_STEPS))
    kw = prompt_tensors(prompts, y0.device)

    def solve(sampler: SamplerConfig, estimate: bool = False):
        if sampler.steps <= seg:
            out = sample_cfm(params, cfg, sampler=sampler, y0=y0, compute_dtype=dtype,
                             return_error_estimate=estimate, **kw)
            if estimate:
                return out[0].float().cpu().numpy(), out[1].float().cpu().numpy()
            return out.float().cpu().numpy()
        if estimate:
            raise ValueError("the error estimate needs an unsegmented solve")
        t0 = time.perf_counter()
        out = y0
        for a in range(0, sampler.steps, seg):
            b = min(a + seg, sampler.steps)
            out = sample_cfm(params, cfg, sampler=sampler, y0=out, compute_dtype=dtype, knot_range=(a, b),
                             paste_back=(b == sampler.steps), **kw)
            if log:
                log(f"  segment knots {a}..{b} done ({time.perf_counter() - t0:.0f}s)")
        return out.float().cpu().numpy()

    return solve


def solve_all(names, solve, configs: dict, solve_cache: str | None = None, log=print) -> dict:
    """``{name: mel}`` for every name, each read from ``<solve_cache>/<name>.npy``
    when it is there and written there after its solve otherwise."""
    outputs = {}
    for name in names:
        cpath = os.path.join(solve_cache, f"{name}.npy") if solve_cache else None
        if cpath and os.path.exists(cpath):
            outputs[name] = np.load(cpath)
            if log:
                log(f"loaded {name:>14} from solve cache")
            continue
        t0 = time.perf_counter()
        outputs[name] = solve(configs[name])
        if cpath:
            os.makedirs(solve_cache, exist_ok=True)
            np.save(cpath, outputs[name])
        if log:
            log(f"solved {name:>14} in {time.perf_counter() - t0:.1f}s")
    return outputs


def report(outputs: dict, names, configs: dict, mask: np.ndarray) -> tuple[list, float | None, float | None]:
    """``(rows, anchor_l2, base_truth_l2)``: each config's drift from the
    recipe (``base``) and, with a ``truth`` solve, its error to truth and
    whether it is certified."""
    base = outputs["base"]
    anchor = outputs.get("anchor64")
    anchor_l2 = quality_report(anchor, base, mask)["mel_l2"] if anchor is not None else None
    truth = outputs.get("truth")
    base_truth_l2 = quality_report(base, truth, mask)["mel_l2"] if truth is not None else None
    rows = []
    for name in names:
        rep = {"name": name, "forwards": n_forwards(configs[name])}
        if name == "base":
            if base_truth_l2 is not None:
                rep.update(quality_report(base, truth, mask))
                rep["vs_recipe_truth_err"] = 1.0
                rep["certified"] = None
            rows.append(rep)
            continue
        drift = quality_report(outputs[name], base, mask)
        rep["drift_mel_l2"] = drift["mel_l2"]
        rep["drift_mcd_db"] = drift["mcd_db"]
        if anchor_l2:
            rep["vs_discretization"] = drift["mel_l2"] / anchor_l2
        if truth is not None and name != "truth":
            rep.update(quality_report(outputs[name], truth, mask))
            rep["vs_recipe_truth_err"] = rep["mel_l2"] / max(base_truth_l2, 1e-12)
            rep["certified"] = bool(rep["mel_l2"] <= base_truth_l2 * (1.0 + 1e-9))
        rows.append(rep)
    return rows, anchor_l2, base_truth_l2


def certify(params, cfg: DiTConfig, y0: torch.Tensor, prompts, names, configs: dict = CONFIGS,
            dtype: torch.dtype = torch.float32, solve_cache: str | None = None, log=print):
    """The harness's work: every config in ``names`` solved from ``y0`` on
    ``prompts`` (``build_prompts``' arrays) with ``params`` (tensors on
    ``y0``'s device), then ``report``."""
    outputs = solve_all(names, make_solver(params, cfg, prompts, y0, dtype, log), configs, solve_cache, log)
    return report(outputs, names, configs, gen_mask(prompts[1], prompts[3], prompts[0].shape[1]))


def print_tables(rows, anchor_l2, truth: bool) -> None:
    if truth:
        print("\nError-to-truth (512-step solve of the same guided ODE); certified = "
              "at-or-below the reference recipe's own solver error:")
        print("| config | forwards | mel L2 → truth | MCD (dB) → truth | ×recipe-err | certified |")
        print("|---|---|---|---|---|---|")
        for r in sorted([r for r in rows if "vs_recipe_truth_err" in r], key=lambda r: r["forwards"]):
            cert = {True: "YES", False: "no", None: "(recipe)"}.get(r.get("certified"), "—")
            print(f"| {r['name']} | {r['forwards']} | {r['mel_l2']:.4f} | {r['mcd_db']:.3f} "
                  f"| {r['vs_recipe_truth_err']:.2f} | {cert} |")
    print("\nDrift from the recipe's exact output (secondary):")
    print("| config | forwards | mel L2 | MCD (dB) | ×discretization |")
    print("|---|---|---|---|---|")
    for r in rows:
        if "drift_mel_l2" in r:
            ratio = f"{r.get('vs_discretization', float('nan')):.2f}" if anchor_l2 else "—"
            print(f"| {r['name']} | {r['forwards']} | {r['drift_mel_l2']:.4f} | {r['drift_mcd_db']:.3f} | {ratio} |")


_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.quality_harness")
    p.add_argument("--geometry", default="tiny", choices=["tiny", "small", "base"])
    p.add_argument("--ckpt", default=None)
    p.add_argument("--toy-train", type=int, default=0)
    p.add_argument("--prompts", type=int, default=6)
    p.add_argument("--bucket", type=int, default=None)
    p.add_argument("--cond-frames", type=int, default=None)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--attn", default=None, choices=[None, "plain", "flash"])
    p.add_argument("--configs", default=",".join(CONFIGS))
    p.add_argument("--extra-grid", action="append", default=[],
                   help="name:method:k0;k1;...;kN - add a custom-knot config (e.g. the optimize_time_grid winner)")
    p.add_argument("--out", default="QUALITY.json")
    p.add_argument("--solve-cache", default=None,
                   help="directory of per-config solved mels (<name>.npy): a stopped run resumes; the weights "
                        "must be deterministic (fixed seeds, the same --toy-train)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    configs = dict(CONFIGS)
    for spec in args.extra_grid:
        name, method, knots = spec.split(":")
        grid = tuple(float(v) for v in knots.split(";"))
        configs[name] = SamplerConfig(steps=len(grid) - 1, cfg_strength=2.0, method=method, time_grid=grid)

    cfg, bucket, cond_frames = geometry(args.geometry, args.bucket, args.cond_frames)
    if args.attn:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn)
    if args.ckpt:
        from f5tts_tpu_torch.models.convert import load_f5_checkpoint

        params = params_from_numpy(load_f5_checkpoint(args.ckpt, cfg), dev)
        weights = f"ckpt:{args.ckpt}"
    else:
        if args.toy_train:
            print(f"toy-training {args.toy_train} steps at {args.geometry} geometry...")
        params = toy_field(cfg, args.toy_train, dev)
        weights = f"toy-trained:{args.toy_train}" if args.toy_train else "random-init"

    dtype = _DTYPES[args.dtype]
    prompts = build_prompts(cfg, args.prompts, bucket, cond_frames)
    y0 = sample_noise_from_seeds(prompts[4], bucket, cfg.mel_dim, torch.as_tensor(prompts[3], device=dev), dtype)
    names = [n.strip() for n in args.configs.split(",") if n.strip()]
    if "base" not in names:
        names.insert(0, "base")
    rows, anchor_l2, base_truth_l2 = certify(params, cfg, y0, prompts, names, configs, dtype, args.solve_cache)

    header = f"quality harness — {args.geometry} / {weights} / {args.dtype} / bucket {bucket} / {args.prompts} prompts"
    print("\n" + header)
    print_tables(rows, anchor_l2, base_truth_l2 is not None)
    result = {"header": header, "weights": weights, "geometry": args.geometry,
              "anchor_mel_l2": anchor_l2, "base_truth_l2": base_truth_l2, "rows": rows}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"\nwrote {args.out}")
    return result


if __name__ == "__main__":
    main()
