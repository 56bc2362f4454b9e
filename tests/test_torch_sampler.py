"""Parity of the port's flow-matching sampler (``f5tts_tpu_torch/sampling``)
with ``f5tts_tpu/sampling/euler.py`` on the CPU at a tiny DiT, with explicit
noise ``y0`` (``jax.random`` noise cannot be reproduced in torch): fp32 atol
1e-4 for euler and ralston with fused CFG 2 and ragged rows, and one bf16
case held to a relative L2 bound. Also the port's own noise rule and the
sampler's configuration helpers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import dit as jd
from f5tts_tpu.sampling import euler as je
from f5tts_tpu_torch.models import convert as t_convert
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.sampling import euler as te

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20, text_num_embeds=40, text_dim=32,
            conv_layers=1, max_pos=512)


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(0), jd.DiTConfig(**TINY)))
    rng = np.random.default_rng(1)
    b, n = 2, 128
    data = dict(
        cond=rng.standard_normal((b, n, 20)).astype(np.float32),
        cond_lens=np.array([40, 25], np.int32),
        text=np.where(np.arange(30)[None] < np.array([[30], [18]]), rng.integers(0, 40, (b, 30)), -1).astype(np.int32),
        duration=np.array([128, 90], np.int32),
    )
    y0 = rng.standard_normal((b, n, 20)).astype(np.float32)
    return params, data, y0


def _run_jax(params, data, y0, sampler, dtype):
    cfg = jd.DiTConfig(**TINY)

    @jax.jit
    def run(p, cond, cond_lens, text, duration, y0):
        return je.sample_cfm(p, cfg, cond=cond, cond_lens=cond_lens, text=text, duration=duration,
                             sampler=sampler, y0=y0, compute_dtype=dtype)

    return np.asarray(run(params, *(jnp.asarray(data[k]) for k in ("cond", "cond_lens", "text", "duration")),
                          jnp.asarray(y0)).astype(jnp.float32))


def _run_torch(params, data, y0, sampler, dtype):
    tp = t_convert.dit_params_from_numpy(params, "cpu", None if dtype == torch.float32 else dtype)
    out = te.sample_cfm(tp, td.DiTConfig(**TINY), **{k: torch.as_tensor(v) for k, v in data.items()},
                        sampler=sampler, y0=torch.as_tensor(y0), compute_dtype=dtype)
    return out.float().numpy()


@pytest.mark.parametrize("method,steps", [("euler", 3), ("ralston", 2)])
def test_sample_cfm_fp32(setup, method, steps):
    params, data, y0 = setup
    ref = _run_jax(params, data, y0, je.SamplerConfig(steps=steps, method=method, cfg_strength=2.0), jnp.float32)
    out = _run_torch(params, data, y0, te.SamplerConfig(steps=steps, method=method, cfg_strength=2.0), torch.float32)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_sample_cfm_bf16_relative_l2(setup):
    """bf16 rounds at different places in XLA:CPU and torch; the solve is held
    to a relative L2 error of 2% over the generated frames."""
    params, data, y0 = setup
    sampler_j = je.serving_default_sampler(steps=2)
    sampler_t = te.serving_default_sampler(steps=2)
    ref = _run_jax(jax.tree.map(lambda a: a.astype(jnp.bfloat16), params), data, y0, sampler_j, jnp.bfloat16)
    out = _run_torch(params, data, y0, sampler_t, torch.bfloat16)
    gen = (np.arange(128)[None] >= data["cond_lens"][:, None]) & (np.arange(128)[None] < data["duration"][:, None])
    rel = np.linalg.norm((out - ref)[gen]) / np.linalg.norm(ref[gen])
    assert rel < 0.02, rel


def test_sample_cfm_no_cfg_and_explicit_grid(setup):
    params, data, y0 = setup
    grid = (0.0, 0.3, 1.0)
    ref = _run_jax(params, data, y0, je.SamplerConfig(steps=2, method="heun", cfg_strength=0.0, time_grid=grid), jnp.float32)
    out = _run_torch(params, data, y0, te.SamplerConfig(steps=2, method="heun", cfg_strength=0.0, time_grid=grid), torch.float32)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_noise_is_per_row_and_batch_position_invariant():
    dur = torch.tensor([50, 50, 30])
    a = te.sample_noise_from_seeds([7, 11, 7], 50, 20, dur)
    b = te.sample_noise_from_seeds([11, 7], 50, 20, dur[:2])
    torch.testing.assert_close(a[0], b[1])  # same seed, other batch position
    torch.testing.assert_close(a[1], b[0])
    torch.testing.assert_close(a[2, :30], a[0, :30])
    assert float(a[2, 30:].abs().max()) == 0.0  # zeroed past the row's duration


def test_sampler_helpers_match_jax():
    for m in te.EVALS_PER_STEP:
        for nfe in (1, 4, 16, 20, 32):
            assert te.nfe_to_steps(nfe, m) == je.nfe_to_steps(nfe, m)
    assert te.DEFAULT_NFE == je.DEFAULT_NFE and te.EVALS_PER_STEP == je.EVALS_PER_STEP
    assert te.serving_default_sampler() == te.SamplerConfig(method="ralston", steps=10)
    assert te.serving_default_sampler(steps=8).time_grid == je.serving_default_sampler(steps=8).time_grid
    for steps in (2, 5, 10):
        for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            np.testing.assert_allclose(te.sway_time_grid(steps, -1.0, dtype=dt_t).float().numpy(),
                                       np.asarray(je.sway_time_grid(steps, -1.0, dtype=dt_j).astype(jnp.float32)),
                                       atol=1e-7)
    for knob in (dict(cfg_interval=(0.2, 1.0)), dict(cfg_cache_period=2), dict(method="midpoint", cfg_null_reuse=True)):
        with pytest.raises(NotImplementedError):
            te.SamplerConfig(**knob)
