"""Per-row-time ODE segment solver (counterpart of
``f5tts_tpu/sampling/segment.py``): the step-level continuous-batching
primitive.

``sample_cfm`` integrates a whole trajectory in one call, so a request that
arrives just after a solve starts waits for all of it. Here the solve is cut
into short segments whose time knots are per-row data:

- every row carries its own ``(k+1)``-knot sub-grid, so rows at different
  points of their trajectories, or with different step counts or guidance
  strengths, share one batched forward;
- a slot whose row has finished (or is empty) gets degenerate knots
  (``t0 == t1``), which make its update ``y + 0 * v``: a no-op while ``v`` is
  finite;
- the host regains control between segments, which is where the step batcher
  (``engine/step_batcher.py``) admits queued rows into free slots and
  finalizes finished ones.

The per-step math is ``sample_cfm``'s (fused 2b-row CFG pair, step-invariant
text embedding, masked conditioning) with time broadcast per row. A guidance
interval (``cfg_interval``) becomes per-row data too: a step is guided when its
start knot lies in ``[lo, hi)``, and an unguided row's combine
``pred + (pred - null) * 0`` is exactly the cond branch. The k intervals of
a segment are a Python loop; nothing here reads a device value on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from f5tts_tpu_torch.models.dit import DiTConfig, dit_embed, dit_forward
from f5tts_tpu_torch.ops.masks import lens_to_mask
from f5tts_tpu_torch.sampling.euler import SamplerConfig, default_time_grid


def resolved_time_grid(sampler: SamplerConfig, steps: int) -> np.ndarray:
    """Host-side (float64) knots of a request at ``steps`` intervals under the
    engine's sampler, as ``TTSEngine.request_sampler`` + ``sample_cfm``
    resolve them on the window path: the configured grid at its own step
    count, else the per-(method, steps) recipe grid, else the sway warp."""
    if sampler.time_grid is not None and steps == sampler.steps:
        return np.asarray(sampler.time_grid, np.float64)
    grid = default_time_grid(sampler.method, steps)
    if grid is not None:
        return np.asarray(grid, np.float64)
    t = np.linspace(0.0, 1.0, steps + 1)
    if sampler.sway_sampling_coef is not None:
        t = t + sampler.sway_sampling_coef * (np.cos(np.pi / 2 * t) - 1 + t)
    return t


def row_masks(cond, cond_lens, text, duration, edit_mask=None):
    """``(cond_mask, attn_mask, clipped duration)``: ``sample_cfm``'s mask and
    conditioning derivation, shared by every program of the segmented solve."""
    n = cond.shape[1]
    text_lens = (text != -1).sum(-1)
    lens = torch.maximum(text_lens, cond_lens)
    cond_mask = lens_to_mask(lens, n)
    if edit_mask is not None:
        cond_mask = cond_mask & edit_mask
    duration = torch.clamp(torch.maximum(lens + 1, duration), max=n)
    return cond_mask, lens_to_mask(duration, n), duration


def pair_text_embedding(params, model_cfg: DiTConfig, text, attn_mask, n: int, embed_fn=dit_embed):
    """The fused pair's step-invariant text embedding ``(2b, n, text_dim)``:
    the cond rows, then the same rows with the text dropped."""
    f = torch.zeros((text.shape[0],), dtype=torch.bool, device=text.device)
    drop2 = torch.cat([f, ~f])
    return embed_fn(params, model_cfg, torch.cat([text, text]), n, drop2, torch.cat([attn_mask, attn_mask]))


@torch.no_grad()
def solve_segment(
    params,
    model_cfg: DiTConfig,
    *,
    cond: torch.Tensor,  # (b, n, mel) padded cond mel
    cond_lens: torch.Tensor,  # (b,)
    text: torch.Tensor,  # (b, nt) int ids, pad -1
    duration: torch.Tensor,  # (b,) total frames incl. cond
    y: torch.Tensor,  # (b, n, mel) raw trajectory state (noise at knot 0)
    t0s: torch.Tensor,  # (k, b) fp32 interval starts, per row
    t1s: torch.Tensor,  # (k, b) fp32 interval ends, per row
    cfg_strength: torch.Tensor,  # (b,) per-row guidance strength
    cfg_interval: tuple[float, float] = (0.0, 1.0),
    method: str = "ralston",
    edit_mask: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
    forward_fn=dit_forward,
    embed_fn=dit_embed,
    text_emb2: torch.Tensor | None = None,  # pair_text_embedding of these rows, when the caller keeps it
) -> torch.Tensor:
    """Advance each row k intervals along its own knots; returns the raw
    trajectory state in ``compute_dtype`` (no paste-back: that is
    ``finalize_rows``)."""
    if method not in ("euler", "midpoint", "heun", "ralston", "rk4"):
        raise ValueError(f"unknown ODE method {method!r}")
    b, n, _ = cond.shape
    cond_mask, attn_mask, _ = row_masks(cond, cond_lens, text, duration, edit_mask)
    zero = torch.zeros((), dtype=compute_dtype, device=cond.device)
    step_cond = torch.where(cond_mask[..., None], cond.to(compute_dtype), zero)
    y = y.to(compute_dtype)

    f = torch.zeros((b,), dtype=torch.bool, device=cond.device)
    drop2 = torch.cat([f, ~f])
    mask2 = torch.cat([attn_mask, attn_mask])
    if text_emb2 is None:
        text_emb2 = pair_text_embedding(params, model_cfg, text, attn_mask, n, embed_fn)
    cond2 = torch.cat([step_cond, step_cond])
    s = cfg_strength[:, None, None].to(compute_dtype)
    lo, hi = cfg_interval
    full_interval = (lo, hi) == (0.0, 1.0)

    def gated_s(t0):
        if full_interval:
            return s
        return s * ((t0 >= lo) & (t0 < hi)).to(compute_dtype)[:, None, None]

    def velocity(t_rows, x, sg):  # t_rows (b,) fp32; sg (b, 1, 1) the step's strength
        out = forward_fn(params, model_cfg, torch.cat([x, x]), cond2, None,
                         torch.cat([t_rows, t_rows]).to(compute_dtype), drop2, drop2, mask2,
                         text_emb=text_emb2, compute_dtype=compute_dtype)
        pred, null = out[:b], out[b:]
        return pred + (pred - null) * sg

    for i in range(t0s.shape[0]):
        t0, t1 = t0s[i], t1s[i]
        dt = (t1 - t0).to(compute_dtype)[:, None, None]
        sg = gated_s(t0)
        k1 = velocity(t0, y, sg)
        if method == "euler":
            y = y + dt * k1
        elif method == "midpoint":
            y = y + dt * velocity(t0 + 0.5 * (t1 - t0), y + 0.5 * dt * k1, sg)
        elif method == "heun":
            k2 = velocity(t1, y + dt * k1, sg)
            y = y + dt * 0.5 * (k1 + k2)
        elif method == "ralston":
            k2 = velocity(t0 + (2.0 / 3.0) * (t1 - t0), y + (2.0 / 3.0) * dt * k1, sg)
            y = y + dt * (0.25 * k1 + 0.75 * k2)
        else:  # rk4
            k2 = velocity(t0 + 0.5 * (t1 - t0), y + 0.5 * dt * k1, sg)
            k3 = velocity(t0 + 0.5 * (t1 - t0), y + 0.5 * dt * k2, sg)
            k4 = velocity(t1, y + dt * k3, sg)
            y = y + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return y


@torch.no_grad()
def finalize_rows(
    decode_fn,
    vocos_params,
    *,
    cond: torch.Tensor,
    cond_lens: torch.Tensor,
    text: torch.Tensor,
    duration: torch.Tensor,
    y: torch.Tensor,
    out_start: torch.Tensor,  # (b,) cond_lens for synthesis rows, 0 for edit rows
    edit_mask: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """Paste the cond frames back over the trajectory's end, roll the
    generated frames to the origin, zero past each row's generated length and
    vocode (``decode_fn(vocos_params, mel)``): the tail of the engine's bucket
    program, run once per batch of finished rows. Returns (fp32 mel, wave)."""
    n = cond.shape[1]
    cond_mask, _, _ = row_masks(cond, cond_lens, text, duration, edit_mask)
    mel_out = torch.where(cond_mask[..., None], cond.to(compute_dtype), y.to(compute_dtype))
    frames = torch.arange(n, device=cond.device)
    idx = (frames[None, :] + out_start[:, None]) % n
    gen = torch.gather(mel_out, 1, idx[..., None].expand(-1, -1, mel_out.shape[-1]))
    gen_len = duration - out_start
    gen = torch.where(frames[None, :, None] < gen_len[:, None, None], gen,
                      torch.zeros((), dtype=gen.dtype, device=gen.device))
    wave = decode_fn(vocos_params, gen)
    return gen.float(), wave
