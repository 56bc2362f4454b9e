"""Flow-matching ODE sampler with fused classifier-free guidance
(counterpart of ``f5tts_tpu/sampling/euler.py``).

- The caller supplies mel padded to a bucket length ``n``; per-row
  conditioning and duration are masks.
- Time grid: an explicit ``time_grid``, else ``linspace(0, 1, steps+1)`` with
  the sway warp ``t + s*(cos(pi/2 t) - 1 + t)``; kept in ``compute_dtype``
  (bf16 on the serving path), as the JAX sampler does.
- Integrators: euler, midpoint, heun, ralston, rk4, as a Python loop over the
  grid's intervals.
- CFG: the cond and null branches run as ONE forward of batch ``2b``; the
  step-invariant text embedding is computed once outside the loop.
- Conditioning frames are pasted back over the result (``edit_mask`` keeps
  the infill semantics).
- Noise: one ``torch.Generator`` per row seed, drawn on the CPU in fp32, so a
  row's noise does not depend on its batch position or the device. It cannot
  equal ``jax.random``'s noise; parity with the JAX sampler goes through
  ``y0``.
- Reduced-guidance knobs, to the JAX sampler's semantics: ``cfg_interval``
  (guidance only on steps whose t0 lies in [lo, hi)), ``cfg_cache_period``
  with ``cfg_cache_mode`` hold/extrapolate (the null branch refreshed every
  k-th euler step), ``cfg_null_reuse`` (an RK step's later stages reuse its
  first stage's null). A skipped null branch is simply a b-row forward in
  place of the 2b-row one.
- ``return_error_estimate`` (2-stage methods): the per-row RMSE over generated
  frames of the accumulated RK2-vs-Euler disagreement, which the engine's
  ``quality="strict"`` thresholds; ``knot_range``/``paste_back`` solve a
  segment of the grid; ``time_grid_array`` takes the knots as a tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from f5tts_tpu_torch.models.dit import DiTConfig, dit_embed, dit_forward
from f5tts_tpu_torch.ops.masks import lens_to_mask
from f5tts_tpu_torch.utils.device import to_device


@dataclass(frozen=True)
class SamplerConfig:
    steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float | None = -1.0
    method: str = "euler"  # "euler" | "midpoint" | "heun" | "ralston" | "rk4"
    # multi-eval (RK) integrators: the step's first eval runs the fused
    # cond+null pair, its later evals the b-row cond branch with that null
    cfg_null_reuse: bool = False
    time_grid: tuple[float, ...] | None = None  # explicit knots 0.0 .. 1.0
    # CFG only on steps whose t0 falls in [lo, hi); elsewhere the plain cond
    # branch at batch b. (0, 1) = always
    cfg_interval: tuple[float, float] = (0.0, 1.0)
    # recompute the null branch every k-th step and reuse it in between
    # (guidance stays on every step). Euler only; excludes cfg_interval
    cfg_cache_period: int = 1
    # "hold": reuse the last null velocity; "extrapolate": first-order
    # extrapolation from the last two refreshes
    cfg_cache_mode: str = "hold"

    def __post_init__(self):
        if len(tuple(self.cfg_interval)) != 2:
            raise ValueError(f"cfg_interval must be (lo, hi), got {self.cfg_interval!r}")
        if self.cfg_cache_period < 1:
            raise ValueError("cfg_cache_period must be >= 1")
        if self.cfg_cache_mode not in ("hold", "extrapolate"):
            raise ValueError(f"cfg_cache_mode must be 'hold' or 'extrapolate', got {self.cfg_cache_mode!r}")
        if self.cfg_cache_period > 1:
            if self.method != "euler":
                raise ValueError("cfg_cache_period requires method='euler'")
            if tuple(self.cfg_interval) != (0.0, 1.0):
                raise ValueError("cfg_cache_period and cfg_interval are mutually exclusive")
        if self.method not in EVALS_PER_STEP:
            raise ValueError(f"unknown ODE method {self.method!r}")
        if self.cfg_null_reuse:
            if self.method == "euler":
                raise ValueError("cfg_null_reuse only applies to multi-eval methods")
            if tuple(self.cfg_interval) != (0.0, 1.0) or self.cfg_cache_period > 1:
                raise ValueError("cfg_null_reuse is mutually exclusive with cfg_interval/cfg_cache_period")


# model evaluations per ODE interval (per guidance branch)
EVALS_PER_STEP = {"euler": 1, "midpoint": 2, "heun": 2, "ralston": 2, "rk4": 4}

# user-facing NFE defaults per method (model evals per guidance branch)
DEFAULT_NFE = {"euler": 32, "midpoint": 20, "heun": 20, "ralston": 20, "rk4": 20}


def nfe_to_steps(nfe: int, method: str) -> int:
    """Model evals per guidance branch -> ODE intervals for the integrator."""
    return max(nfe // EVALS_PER_STEP[method], 1)


# Ralston knot grids searched at Base geometry for the JAX package (NFE 16 is
# the shipped fast mode; the NFE-20 grid is kept for the record only).
OPT_GRID_BASE_RALSTON8 = (0.0, 0.153893, 0.287175, 0.475823, 0.516263,
                          0.661497, 0.745711, 0.918548, 1.0)
OPT_GRID_BASE_RALSTON10 = (0.0, 0.007097, 0.061681, 0.108993, 0.21397,
                           0.317674, 0.412215, 0.54601, 0.690983, 0.843566, 1.0)

DEFAULT_TIME_GRIDS: dict[tuple[str, int], tuple[float, ...]] = {
    ("ralston", 8): OPT_GRID_BASE_RALSTON8,
}


def default_time_grid(method: str, steps: int) -> tuple[float, ...] | None:
    return DEFAULT_TIME_GRIDS.get((method, steps))


def serving_default_sampler(**overrides) -> SamplerConfig:
    """The serving default: Ralston RK2 at 10 intervals (NFE 20 per branch) on
    the sway grid, CFG 2.0 / sway -1.0."""
    kw = dict(method="ralston", steps=10)
    kw.update(overrides)
    if kw.get("time_grid") is None:
        kw["time_grid"] = default_time_grid(kw["method"], kw["steps"])
    elif len(kw["time_grid"]) != kw["steps"] + 1:
        raise ValueError(
            f"time_grid has {len(kw['time_grid'])} knots but steps={kw['steps']} "
            f"needs {kw['steps'] + 1}; pass time_grid=None to use the framework default")
    return SamplerConfig(**kw)


def parse_cfg_interval(s: str) -> tuple[float, float]:
    """'lo,hi' -> (lo, hi) with a clear error."""
    parts = [float(v) for v in s.split(",") if v.strip() != ""]
    if len(parts) != 2:
        raise ValueError(f"guidance interval must be 'lo,hi', got {s!r}")
    return (parts[0], parts[1])


def sway_time_grid(steps: int, coef: float | None, t_start: float = 0.0, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    # knots in fp32 as start + i*step (last knot exact), then one rounding to
    # dtype: the values jnp.linspace gives in bf16 as well as fp32
    t = t_start + torch.arange(steps + 1, dtype=torch.float32) * ((1.0 - t_start) / steps)
    t[-1] = 1.0
    t = to_device(t, device if device is not None else "cpu").to(dtype)
    if coef is not None:
        t = t + coef * (torch.cos(math.pi / 2 * t) - 1 + t)
    return t


def sample_noise_from_seeds(seeds, n: int, mel_dim: int, duration: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Per-row noise ``(b, n, mel_dim)`` from independent integer seeds, zeroed
    past each row's duration. Row i's noise depends on ``seeds[i]`` alone."""
    rows = []
    for s in torch.as_tensor(seeds).tolist():
        g = torch.Generator(device="cpu").manual_seed(int(s))
        rows.append(torch.randn((n, mel_dim), generator=g, dtype=torch.float32))
    y0 = to_device(torch.stack(rows), duration.device).to(dtype)
    return torch.where(lens_to_mask(duration, n)[..., None], y0, torch.zeros((), dtype=dtype, device=y0.device))


# embedded-pair coefficient: y_RK2 - y_Euler = c * dt * (k2 - k1)
_EMB_COEF = {"midpoint": 1.0, "heun": 0.5, "ralston": 0.75}


def _rk_step(method: str, evals, y, t0, t1):
    """One ODE step. ``evals(t0, y) -> (k1, later)``: the first stage's
    velocity and the function that evaluates the step's later stages.
    Returns ``(y_next, k1, k2)`` (``k2`` None for euler and rk4); arithmetic in
    ``y``'s dtype."""
    dt = t1 - t0
    k1, later = evals(t0, y)
    if method == "euler":
        return y + dt * k1, k1, None
    if method == "midpoint":
        k2 = later(t0 + 0.5 * dt, y + 0.5 * dt * k1)
        return y + dt * k2, k1, k2
    if method == "heun":
        k2 = later(t1, y + dt * k1)
        return y + dt * 0.5 * (k1 + k2), k1, k2
    if method == "ralston":
        k2 = later(t0 + (2.0 / 3.0) * dt, y + (2.0 / 3.0) * dt * k1)
        return y + dt * (0.25 * k1 + 0.75 * k2), k1, k2
    k2 = later(t0 + 0.5 * dt, y + 0.5 * dt * k1)  # rk4
    k3 = later(t0 + 0.5 * dt, y + 0.5 * dt * k2)
    k4 = later(t1, y + dt * k3)
    return y + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4), k1, None


def _host_knots(sampler: SamplerConfig) -> np.ndarray:
    """The configured knots in float64 on the host: what decides which steps
    are guided and the cache's extrapolation coefficients (as in the JAX
    sampler, which cannot read its traced grid)."""
    if sampler.time_grid is not None:
        return np.asarray(sampler.time_grid, np.float64)
    t = np.linspace(0.0, 1.0, sampler.steps + 1)
    if sampler.sway_sampling_coef is not None:
        t = t + sampler.sway_sampling_coef * (np.cos(np.pi / 2 * t) - 1 + t)
    return t


@torch.no_grad()
def sample_cfm(
    params,
    model_cfg: DiTConfig,
    *,
    cond: torch.Tensor,  # (b, n, mel) padded cond mel
    cond_lens: torch.Tensor,  # (b,) valid cond frames
    text: torch.Tensor,  # (b, nt) int ids, pad -1
    duration: torch.Tensor,  # (b,) total frames incl. cond
    sampler: SamplerConfig = SamplerConfig(),
    y0: torch.Tensor | None = None,  # explicit noise (parity tests)
    seeds=None,  # (b,) int per-row noise seeds
    edit_mask: torch.Tensor | None = None,  # (b, n) bool; False = regenerate
    compute_dtype: torch.dtype = torch.float32,
    knot_range: tuple[int, int] | None = None,
    paste_back: bool = True,
    time_grid_array: torch.Tensor | None = None,
    return_error_estimate: bool = False,
    forward_fn=dit_forward,
    embed_fn=dit_embed,
):
    """Returns the sampled mel ``(b, n, mel)`` (cond frames pasted back).
    ``forward_fn``/``embed_fn`` are the backbone's (``dit_*``, ``unett_*``).

    ``knot_range=(a, b)`` integrates only knots ``t_grid[a..b]`` starting from
    ``y0`` (the previous segment's raw output) and ``paste_back=False``
    returns the raw trajectory state, so a fine solve can run as segments.
    ``time_grid_array`` gives the ``(steps + 1,)`` knots as a tensor (not
    validated). ``return_error_estimate=True`` (2-stage methods, plain
    guidance only) also returns a per-row ``(b,)`` fp32 scalar: the RMSE over
    generated frames of the signed sum of each step's RK2-vs-Euler
    disagreement ``c * dt * (k2 - k1)`` (midpoint c = 1, heun 1/2, ralston
    3/4); it costs one accumulate buffer and no model evals."""
    b, n, mel_dim = cond.shape
    dev = cond.device
    plain_guidance = sampler.cfg_cache_period == 1 and tuple(sampler.cfg_interval) == (0.0, 1.0)
    if return_error_estimate:
        if EVALS_PER_STEP.get(sampler.method) != 2:
            raise ValueError("return_error_estimate requires a 2-stage method (midpoint/heun/ralston)")
        if not plain_guidance:
            raise ValueError("return_error_estimate supports plain full-interval guidance only")
    if time_grid_array is not None and not plain_guidance:
        raise ValueError("time_grid_array supports plain full-interval guidance only")
    if knot_range is not None and not plain_guidance:
        raise ValueError("knot_range supports plain (non-cached, full-interval) guidance only")

    text_lens = (text != -1).sum(-1)
    lens = torch.maximum(text_lens, cond_lens)
    cond_mask = lens_to_mask(lens, n)
    if edit_mask is not None:
        cond_mask = cond_mask & edit_mask
    duration = torch.clamp(torch.maximum(lens + 1, duration), max=n)
    attn_mask = lens_to_mask(duration, n)

    zero = torch.zeros((), dtype=compute_dtype, device=dev)
    cond = cond.to(compute_dtype)
    step_cond = torch.where(cond_mask[..., None], cond, zero)

    if y0 is None:
        if seeds is None:
            raise ValueError("sample_cfm needs y0 or seeds")
        y0 = sample_noise_from_seeds(seeds, n, mel_dim, duration, compute_dtype)
    y = y0.to(device=dev, dtype=compute_dtype)

    use_cfg = sampler.cfg_strength >= 1e-5
    s = sampler.cfg_strength
    f = torch.zeros((b,), dtype=torch.bool, device=dev)
    velocity_pair = cond_forward = None
    if use_cfg:
        # one fused forward of batch 2b: [cond branch; null branch]
        drop2 = torch.cat([f, ~f])
        mask2 = torch.cat([attn_mask, attn_mask])
        text_emb2 = embed_fn(params, model_cfg, torch.cat([text, text]), n, drop2, mask2)
        cond2 = torch.cat([step_cond, step_cond])

        def velocity_pair(t, x):
            out = forward_fn(params, model_cfg, torch.cat([x, x]), cond2, None,
                              t.expand(2 * b).to(compute_dtype), drop2, drop2, mask2,
                              text_emb=text_emb2, compute_dtype=compute_dtype)
            return out[:b], out[b:]

        def velocity(t, x):
            pred, null = velocity_pair(t, x)
            return pred + (pred - null) * s

        if not plain_guidance or sampler.cfg_null_reuse:
            text_emb1 = text_emb2[:b]  # the cond half of the fused embedding

            def cond_forward(t, x):  # the plain cond branch at batch b
                return forward_fn(params, model_cfg, x, step_cond, None, t.expand(b).to(compute_dtype),
                                   f, f, attn_mask, text_emb=text_emb1, compute_dtype=compute_dtype)
    else:
        text_emb = embed_fn(params, model_cfg, text, n, f, attn_mask)

        def velocity(t, x):
            return forward_fn(params, model_cfg, x, step_cond, None, t.expand(b).to(compute_dtype),
                               f, f, attn_mask, text_emb=text_emb, compute_dtype=compute_dtype)

    if time_grid_array is not None:
        t_grid = time_grid_array.to(device=dev, dtype=compute_dtype)
    elif sampler.time_grid is not None:
        tg = sampler.time_grid
        if len(tg) < 2 or tg[0] != 0.0 or tg[-1] != 1.0 or any(b_ <= a_ for a_, b_ in zip(tg, tg[1:])):
            raise ValueError("time_grid must be strictly increasing from 0.0 to 1.0")
        t_grid = to_device(torch.tensor(tg, dtype=compute_dtype), dev)
    else:
        t_grid = sway_time_grid(sampler.steps, sampler.sway_sampling_coef, dtype=compute_dtype, device=dev)
    if knot_range is not None:
        a, bk = knot_range
        if not (0 <= a < bk <= t_grid.shape[0] - 1):
            raise ValueError(f"knot_range {knot_range} out of bounds for {t_grid.shape[0] - 1} steps")
        t_grid = t_grid[a : bk + 1]
    nsteps = t_grid.shape[0] - 1

    def finish(y_final, est=None):
        out = torch.where(cond_mask[..., None], cond, y_final) if paste_back else y_final
        return (out, est) if return_error_estimate else out

    if use_cfg and sampler.cfg_cache_period > 1:
        # guidance caching (euler): a fused 2b forward refreshes the null
        # velocity every k-th step; the k-1 steps in between run the b-row
        # cond branch against the cached (or extrapolated) null
        k = sampler.cfg_cache_period
        ngroups = nsteps // k
        coefs = np.zeros((ngroups, k))
        if sampler.cfg_cache_mode == "extrapolate" and ngroups:
            # null(t) ~ null(T_g) + c * (null(T_g) - null(T_{g-1})), c = (t - T_g) / (T_g - T_{g-1}); group 0 holds
            t_np = _host_knots(sampler)
            refresh = t_np[np.arange(ngroups) * k]
            for g in range(1, ngroups):
                coefs[g] = (t_np[g * k : g * k + k] - refresh[g]) / (refresh[g] - refresh[g - 1])
        coefs_t = torch.as_tensor(coefs).to(device=dev, dtype=y.dtype)
        null_prev = torch.zeros_like(y)
        for g in range(ngroups):
            i0 = g * k
            pred, null = velocity_pair(t_grid[i0], y)
            y = y + (t_grid[i0 + 1] - t_grid[i0]) * (pred + (pred - null) * s)
            for j in range(1, k):
                pj = cond_forward(t_grid[i0 + j], y)
                null_j = null + coefs_t[g, j] * (null - null_prev) if sampler.cfg_cache_mode == "extrapolate" else null
                y = y + (t_grid[i0 + j + 1] - t_grid[i0 + j]) * (pj + (pj - null_j) * s)
            null_prev = null
        for j in range(ngroups * k, nsteps):  # remainder steps (< k of them): full guided pairs
            pred, null = velocity_pair(t_grid[j], y)
            y = y + (t_grid[j + 1] - t_grid[j]) * (pred + (pred - null) * s)
        return finish(y)

    def evals_of(vel):
        """The step's stage evaluations: plain, or with the first stage's null reused."""
        if not (sampler.cfg_null_reuse and use_cfg):
            return lambda t0, y_: (vel(t0, y_), vel)

        def evals(t0, y_):
            pred, null = velocity_pair(t0, y_)

            def later(t, x):
                p = cond_forward(t, x)
                return p + (p - null) * s

            return pred + (pred - null) * s, later

        return evals

    if use_cfg and tuple(sampler.cfg_interval) != (0.0, 1.0):
        lo, hi = sampler.cfg_interval
        guided = [bool(lo <= t0 < hi) for t0 in _host_knots(sampler)[:-1]]
    else:
        guided = [True] * nsteps
    e_acc = torch.zeros_like(y) if return_error_estimate else None
    for i in range(nsteps):
        dt = t_grid[i + 1] - t_grid[i]
        y, k1, k2 = _rk_step(sampler.method, evals_of(velocity if guided[i] else cond_forward), y,
                             t_grid[i], t_grid[i + 1])
        if e_acc is not None:
            e_acc = e_acc + (_EMB_COEF[sampler.method] * dt) * (k2 - k1)
    est = None
    if e_acc is not None:
        # per-row RMSE over generated frames: the normalization of the certification metric
        gen_mask = attn_mask & ~cond_mask
        denom = torch.clamp_min(gen_mask.sum(1) * mel_dim, 1).float()
        est = torch.sqrt((torch.square(e_acc.float()) * gen_mask[..., None]).sum((1, 2)) / denom)
    return finish(y, est)
