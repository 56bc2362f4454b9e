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

The guidance-interval, guidance-caching, null-reuse, error-estimate,
``knot_range`` and ``time_grid_array`` knobs of the JAX sampler are not ported
yet: set to a non-default value they raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from f5tts_tpu_torch.models.dit import DiTConfig, dit_embed, dit_forward
from f5tts_tpu_torch.ops.masks import lens_to_mask


@dataclass(frozen=True)
class SamplerConfig:
    steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float | None = -1.0
    method: str = "euler"  # "euler" | "midpoint" | "heun" | "ralston" | "rk4"
    cfg_null_reuse: bool = False  # not ported yet
    time_grid: tuple[float, ...] | None = None  # explicit knots 0.0 .. 1.0
    cfg_interval: tuple[float, float] = (0.0, 1.0)  # not ported yet
    cfg_cache_period: int = 1  # not ported yet
    cfg_cache_mode: str = "hold"  # not ported yet

    def __post_init__(self):
        if self.method not in EVALS_PER_STEP:
            raise ValueError(f"unknown ODE method {self.method!r}")
        if len(tuple(self.cfg_interval)) != 2:
            raise ValueError(f"cfg_interval must be (lo, hi), got {self.cfg_interval!r}")
        if self.cfg_cache_period < 1:
            raise ValueError("cfg_cache_period must be >= 1")
        if self.cfg_cache_mode not in ("hold", "extrapolate"):
            raise ValueError(f"cfg_cache_mode must be 'hold' or 'extrapolate', got {self.cfg_cache_mode!r}")
        unported = {
            "cfg_interval": tuple(self.cfg_interval) != (0.0, 1.0),
            "cfg_cache_period": self.cfg_cache_period != 1,
            "cfg_cache_mode": self.cfg_cache_mode != "hold",
            "cfg_null_reuse": self.cfg_null_reuse,
        }
        for name, set_ in unported.items():
            if set_:
                raise NotImplementedError(f"SamplerConfig.{name} is not ported to the PyTorch sampler yet")


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


def sway_time_grid(steps: int, coef: float | None, t_start: float = 0.0, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    # knots in fp32 as start + i*step (last knot exact), then one rounding to
    # dtype: the values jnp.linspace gives in bf16 as well as fp32
    t = t_start + torch.arange(steps + 1, dtype=torch.float32) * ((1.0 - t_start) / steps)
    t[-1] = 1.0
    t = t.to(device=device, dtype=dtype)
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
    y0 = torch.stack(rows).to(device=duration.device, dtype=dtype)
    return torch.where(lens_to_mask(duration, n)[..., None], y0, torch.zeros((), dtype=dtype, device=y0.device))


def _integrator(method: str):
    """One ODE step ``(vel, y, t0, t1) -> y``; arithmetic in ``y``'s dtype."""
    def euler(vel, y, t0, t1):
        return y + (t1 - t0) * vel(t0, y)

    def midpoint(vel, y, t0, t1):
        dt = t1 - t0
        k1 = vel(t0, y)
        return y + dt * vel(t0 + 0.5 * dt, y + 0.5 * dt * k1)

    def heun(vel, y, t0, t1):
        dt = t1 - t0
        k1 = vel(t0, y)
        k2 = vel(t1, y + dt * k1)
        return y + dt * 0.5 * (k1 + k2)

    def ralston(vel, y, t0, t1):
        dt = t1 - t0
        k1 = vel(t0, y)
        k2 = vel(t0 + (2.0 / 3.0) * dt, y + (2.0 / 3.0) * dt * k1)
        return y + dt * (0.25 * k1 + 0.75 * k2)

    def rk4(vel, y, t0, t1):
        dt = t1 - t0
        k1 = vel(t0, y)
        k2 = vel(t0 + 0.5 * dt, y + 0.5 * dt * k1)
        k3 = vel(t0 + 0.5 * dt, y + 0.5 * dt * k2)
        k4 = vel(t1, y + dt * k3)
        return y + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    return {"euler": euler, "midpoint": midpoint, "heun": heun, "ralston": ralston, "rk4": rk4}[method]


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
) -> torch.Tensor:
    """Returns the sampled mel ``(b, n, mel)`` (cond frames pasted back)."""
    b, n, mel_dim = cond.shape
    dev = cond.device
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

    f = torch.zeros((b,), dtype=torch.bool, device=dev)
    if sampler.cfg_strength >= 1e-5:
        # one fused forward of batch 2b: [cond branch; null branch]
        drop2 = torch.cat([f, ~f])
        mask2 = torch.cat([attn_mask, attn_mask])
        text_emb2 = dit_embed(params, model_cfg, torch.cat([text, text]), n, drop2, mask2)
        cond2 = torch.cat([step_cond, step_cond])

        def vel(t, x):
            out = dit_forward(params, model_cfg, torch.cat([x, x]), cond2, None,
                             t.expand(2 * b).to(compute_dtype), drop2, drop2, mask2,
                             text_emb=text_emb2, compute_dtype=compute_dtype)
            pred, null = out[:b], out[b:]
            return pred + (pred - null) * sampler.cfg_strength
    else:
        text_emb = dit_embed(params, model_cfg, text, n, f, attn_mask)

        def vel(t, x):
            return dit_forward(params, model_cfg, x, step_cond, None, t.expand(b).to(compute_dtype),
                              f, f, attn_mask, text_emb=text_emb, compute_dtype=compute_dtype)

    if sampler.time_grid is not None:
        tg = sampler.time_grid
        if len(tg) < 2 or tg[0] != 0.0 or tg[-1] != 1.0 or any(b_ <= a_ for a_, b_ in zip(tg, tg[1:])):
            raise ValueError("time_grid must be strictly increasing from 0.0 to 1.0")
        t_grid = torch.tensor(tg, dtype=compute_dtype, device=dev)
    else:
        t_grid = sway_time_grid(sampler.steps, sampler.sway_sampling_coef, dtype=compute_dtype, device=dev)

    step = _integrator(sampler.method)
    for i in range(t_grid.shape[0] - 1):
        y = step(vel, y, t_grid[i], t_grid[i + 1])
    return torch.where(cond_mask[..., None], cond, y)
