"""Parity of the port's flow-matching sampler (``f5tts_tpu_torch/sampling``)
with ``f5tts_tpu/sampling/euler.py`` on the CPU at a tiny DiT, with explicit
noise ``y0`` (``jax.random`` noise cannot be reproduced in torch): fp32 atol
1e-4 for euler and ralston with fused CFG 2 and ragged rows, and one bf16
case held to a relative L2 bound; every reduced-guidance knob (interval, cache
hold/extrapolate, null reuse), the embedded error estimate, ``knot_range``
segments and ``time_grid_array`` at the same tolerance. Also the port's own
noise rule and the sampler's configuration helpers."""

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


def _run_jax(params, data, y0, sampler, dtype, **kw):
    """``kw``: static extras of ``sample_cfm`` (``knot_range``, ``paste_back``,
    ``return_error_estimate``); ``time_grid_array`` goes in as an array."""
    cfg = jd.DiTConfig(**TINY)
    grid = kw.pop("time_grid_array", None)

    @jax.jit
    def run(p, cond, cond_lens, text, duration, y0, grid):
        return je.sample_cfm(p, cfg, cond=cond, cond_lens=cond_lens, text=text, duration=duration,
                             sampler=sampler, y0=y0, compute_dtype=dtype, time_grid_array=grid, **kw)

    out = run(params, *(jnp.asarray(data[k]) for k in ("cond", "cond_lens", "text", "duration")), jnp.asarray(y0),
              None if grid is None else jnp.asarray(grid))
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), out)


def _run_torch(params, data, y0, sampler, dtype, **kw):
    tp = t_convert.dit_params_from_numpy(params, "cpu", None if dtype == torch.float32 else dtype)
    if kw.get("time_grid_array") is not None:
        kw["time_grid_array"] = torch.as_tensor(kw["time_grid_array"])
    out = te.sample_cfm(tp, td.DiTConfig(**TINY), **{k: torch.as_tensor(v) for k, v in data.items()},
                        sampler=sampler, y0=torch.as_tensor(y0), compute_dtype=dtype, **kw)
    if isinstance(out, tuple):
        return tuple(o.float().numpy() for o in out)
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
        assert te.SamplerConfig(**knob) == te.SamplerConfig(**knob)  # accepted, as the JAX config accepts them
        je.SamplerConfig(**knob)
    assert te.parse_cfg_interval("0.2, 0.9") == je.parse_cfg_interval("0.2, 0.9") == (0.2, 0.9)
    with pytest.raises(ValueError, match="lo,hi"):
        te.parse_cfg_interval("0.2")


# every knob the JAX sampler has beyond the plain fused-CFG solve, at the
# file's tolerance (fp32, atol/rtol 1e-4), through explicit noise
KNOBS = {
    "interval_euler": dict(steps=4, method="euler", cfg_interval=(0.3, 0.9)),
    "interval_ralston_grid": dict(steps=3, method="ralston", cfg_interval=(0.0, 0.5), time_grid=(0.0, 0.2, 0.6, 1.0)),
    "cache_hold_with_remainder": dict(steps=5, method="euler", cfg_cache_period=2),
    "cache_extrapolate": dict(steps=6, method="euler", cfg_cache_period=3, cfg_cache_mode="extrapolate"),
    "cache_extrapolate_grid": dict(steps=4, method="euler", cfg_cache_period=2, cfg_cache_mode="extrapolate",
                                   time_grid=(0.0, 0.1, 0.35, 0.7, 1.0)),
    "null_reuse_midpoint": dict(steps=2, method="midpoint", cfg_null_reuse=True),
    "null_reuse_rk4": dict(steps=1, method="rk4", cfg_null_reuse=True),
    "cache_without_guidance": dict(steps=3, method="euler", cfg_cache_period=2, cfg_strength=0.0),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_sample_cfm_guidance_knobs_match_jax(setup, knob):
    params, data, y0 = setup
    kw = {"cfg_strength": 2.0, **KNOBS[knob]}
    ref = _run_jax(params, data, y0, je.SamplerConfig(**kw), jnp.float32)
    out = _run_torch(params, data, y0, te.SamplerConfig(**kw), torch.float32)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    plain = _run_torch(params, data, y0, te.SamplerConfig(steps=kw["steps"], method=kw["method"],
                                                          cfg_strength=kw["cfg_strength"],
                                                          time_grid=kw.get("time_grid")), torch.float32)
    if knob != "cache_without_guidance":  # the knob changes the solve (it is not silently ignored)
        assert np.abs(out - plain).max() > 1e-3
    else:
        np.testing.assert_array_equal(out, plain)


@pytest.mark.parametrize("method,reuse", [("ralston", False), ("heun", False), ("midpoint", True)])
def test_error_estimate_matches_jax(setup, method, reuse):
    """The embedded RK2-vs-Euler estimate: the mel as without it, and the
    per-row value against the JAX sampler's (rtol 1e-4)."""
    params, data, y0 = setup
    kw = dict(steps=3, method=method, cfg_strength=2.0, cfg_null_reuse=reuse)
    ref_mel, ref_est = _run_jax(params, data, y0, je.SamplerConfig(**kw), jnp.float32, return_error_estimate=True)
    mel, est = _run_torch(params, data, y0, te.SamplerConfig(**kw), torch.float32, return_error_estimate=True)
    np.testing.assert_allclose(mel, ref_mel, atol=1e-4, rtol=1e-4)
    assert est.shape == (2,) and (est > 0).all()
    np.testing.assert_allclose(est, ref_est, rtol=1e-4)
    np.testing.assert_array_equal(mel, _run_torch(params, data, y0, te.SamplerConfig(**kw), torch.float32))


def test_knot_range_segments_and_time_grid_array_match_jax(setup):
    params, data, y0 = setup
    kw = dict(steps=4, method="ralston", cfg_strength=2.0)
    full = _run_torch(params, data, y0, te.SamplerConfig(**kw), torch.float32)
    # two segments, the first handing its raw state to the second
    mid_j = _run_jax(params, data, y0, je.SamplerConfig(**kw), jnp.float32, knot_range=(0, 3), paste_back=False)
    mid_t = _run_torch(params, data, y0, te.SamplerConfig(**kw), torch.float32, knot_range=(0, 3), paste_back=False)
    np.testing.assert_allclose(mid_t, mid_j, atol=1e-4, rtol=1e-4)
    end_t = _run_torch(params, data, mid_t, te.SamplerConfig(**kw), torch.float32, knot_range=(3, 4))
    np.testing.assert_array_equal(end_t, full)  # the same steps in the same order
    end_j = _run_jax(params, data, mid_j, je.SamplerConfig(**kw), jnp.float32, knot_range=(3, 4))
    np.testing.assert_allclose(end_t, end_j, atol=1e-4, rtol=1e-4)
    # the knots as an array
    grid = np.array([0.0, 0.15, 0.5, 0.8, 1.0], np.float32)
    ref = _run_jax(params, data, y0, je.SamplerConfig(**kw), jnp.float32, time_grid_array=grid)
    out = _run_torch(params, data, y0, te.SamplerConfig(**kw), torch.float32, time_grid_array=grid)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(out, _run_torch(params, data, y0, te.SamplerConfig(
        **kw, time_grid=tuple(float(g) for g in grid)), torch.float32))
    with pytest.raises(ValueError, match="out of bounds"):
        _run_torch(params, data, y0, te.SamplerConfig(**kw), torch.float32, knot_range=(2, 5))


# what the JAX config and sampler refuse, the port refuses with the same error type
BAD_CONFIGS = [
    dict(cfg_interval=(0.1, 0.5, 0.9)), dict(cfg_cache_period=0), dict(cfg_cache_mode="guess"),
    dict(method="ralston", cfg_cache_period=2), dict(cfg_cache_period=2, cfg_interval=(0.2, 0.8)),
    dict(method="rk5"), dict(method="euler", cfg_null_reuse=True),
    dict(method="heun", cfg_null_reuse=True, cfg_interval=(0.2, 0.8)),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=lambda b: "-".join(f"{k}={v}" for k, v in b.items()))
def test_sampler_config_exclusions_match_jax(bad):
    with pytest.raises(ValueError):
        je.SamplerConfig(**bad)
    with pytest.raises(ValueError):
        te.SamplerConfig(**bad)


@pytest.mark.parametrize("sampler_kw,call_kw", [
    (dict(method="euler"), dict(return_error_estimate=True)),
    (dict(method="rk4"), dict(return_error_estimate=True)),
    (dict(method="euler", cfg_cache_period=2), dict(knot_range=(0, 1))),
    (dict(method="heun", cfg_interval=(0.2, 0.8)), dict(return_error_estimate=True)),
    (dict(method="euler", cfg_interval=(0.2, 0.8)), dict(time_grid_array=np.linspace(0, 1, 4, dtype=np.float32))),
])
def test_sample_cfm_refuses_what_jax_refuses(setup, sampler_kw, call_kw):
    params, data, y0 = setup
    with pytest.raises(ValueError):
        _run_jax(params, data, y0, je.SamplerConfig(steps=3, **sampler_kw), jnp.float32, **dict(call_kw))
    with pytest.raises(ValueError):
        _run_torch(params, data, y0, te.SamplerConfig(steps=3, **sampler_kw), torch.float32, **dict(call_kw))
