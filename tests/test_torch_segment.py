"""The port's segment solver (``f5tts_tpu_torch/sampling/segment.py``) against
the JAX package's on the CPU at a tiny geometry (dim 64, depth 2), fp32, JAX
matmul precision ``highest``, atol/rtol 1e-4: ``solve_segment`` on the same
``(cond, text, duration, y, t0s, t1s, cfg)`` for each of the five methods with
rows at mixed progress (one mid-trajectory, one at a degenerate knot pair,
one starting), per-row guidance, the ``cfg_interval`` gate and an
``edit_mask``; ``finalize_rows`` (paste-back, roll, zero, vocode); and
``resolved_time_grid``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import dit as jd
from f5tts_tpu.models import vocos as jv
from f5tts_tpu.sampling import euler as je
from f5tts_tpu.sampling import segment as js
from f5tts_tpu_torch.models import convert as tc
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.models import vocos as tv
from f5tts_tpu_torch.sampling import euler as te
from f5tts_tpu_torch.sampling import segment as ts

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIT = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20, text_num_embeds=40, text_dim=32,
           conv_layers=1, max_pos=256)
VOC = dict(input_channels=20, dim=48, intermediate_dim=96, num_layers=2)
B, N, NT = 3, 64, 24


@pytest.fixture(scope="module")
def setup():
    dp = jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(0), jd.DiTConfig(**DIT)))
    vp = jax.tree.map(np.asarray, jv.init_vocos(jax.random.PRNGKey(1), jv.VocosConfig(**VOC)))
    rng = np.random.default_rng(0)
    text_lens = np.array([[NT], [15], [9]])
    data = dict(
        cond=rng.standard_normal((B, N, 20)).astype(np.float32),
        cond_lens=np.array([12, 20, 7], np.int32),
        text=np.where(np.arange(NT)[None] < text_lens, rng.integers(0, 38, (B, NT)), -1).astype(np.int32),
        duration=np.array([N, 50, 33], np.int32),
        y=rng.standard_normal((B, N, 20)).astype(np.float32),
        # row 0 mid-trajectory, row 1 finished (degenerate knots), row 2 at its start
        t0s=np.array([[0.3, 1.0, 0.0], [0.55, 1.0, 0.2]], np.float32),
        t1s=np.array([[0.55, 1.0, 0.2], [0.8, 1.0, 0.45]], np.float32),
        cfg=np.array([2.0, 0.0, 1.5], np.float32),
    )
    em = np.ones((B, N), bool)
    em[2, 10:20] = False  # row 2 is an edit row
    data["em"] = em
    return dp, vp, tc.dit_params_from_numpy(dp, "cpu", torch.float32), tc.vocos_params_from_numpy(vp, "cpu"), data


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("method,interval,edit", [
    *((m, (0.25, 0.5), True) for m in ("euler", "midpoint", "heun", "ralston", "rk4")),
    ("ralston", (0.0, 1.0), False), ("euler", (0.0, 1.0), False)])
def test_solve_segment_matches_jax(setup, method, interval, edit):
    dp, _, tp, _, d = setup
    em = d["em"] if edit else None
    jy = js.solve_segment(dp, jd.DiTConfig(**DIT), cond=jnp.asarray(d["cond"]), cond_lens=jnp.asarray(d["cond_lens"]),
                          text=jnp.asarray(d["text"]), duration=jnp.asarray(d["duration"]), y=jnp.asarray(d["y"]),
                          t0s=jnp.asarray(d["t0s"]), t1s=jnp.asarray(d["t1s"]), cfg_strength=jnp.asarray(d["cfg"]),
                          cfg_interval=interval, method=method, edit_mask=None if em is None else jnp.asarray(em))
    ty = ts.solve_segment(tp, td.DiTConfig(**DIT), cond=_t(d["cond"]), cond_lens=_t(d["cond_lens"]), text=_t(d["text"]),
                          duration=_t(d["duration"]), y=_t(d["y"]), t0s=_t(d["t0s"]), t1s=_t(d["t1s"]),
                          cfg_strength=_t(d["cfg"]), cfg_interval=interval, method=method,
                          edit_mask=None if em is None else _t(em))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    # the degenerate row is an exact no-op, the others moved
    np.testing.assert_array_equal(ty[1].numpy(), d["y"][1])
    assert float(torch.abs(ty[0] - _t(d["y"][0])).max()) > 1e-3


def test_solve_segment_takes_a_kept_text_embedding(setup):
    """The step batcher keeps each group's pair text embedding between
    segments: passing it in gives the same trajectory bit for bit."""
    _, _, tp, _, d = setup
    cfg = td.DiTConfig(**DIT)
    kw = dict(cond=_t(d["cond"]), cond_lens=_t(d["cond_lens"]), text=_t(d["text"]), duration=_t(d["duration"]),
              y=_t(d["y"]), t0s=_t(d["t0s"]), t1s=_t(d["t1s"]), cfg_strength=_t(d["cfg"]))
    _, attn_mask, _ = ts.row_masks(kw["cond"], kw["cond_lens"], kw["text"], kw["duration"])
    emb = ts.pair_text_embedding(tp, cfg, kw["text"], attn_mask, N)
    assert torch.equal(ts.solve_segment(tp, cfg, **kw), ts.solve_segment(tp, cfg, **kw, text_emb2=emb))
    with pytest.raises(ValueError, match="unknown ODE method"):
        ts.solve_segment(tp, cfg, **kw, method="dopri5")


@pytest.mark.parametrize("edit", [False, True])
def test_finalize_rows_matches_jax(setup, edit):
    dp, vp, _, tvp, d = setup
    out_start = np.where([False, False, edit], 0, d["cond_lens"]).astype(np.int32)
    em = d["em"] if edit else None
    vcfg_j, vcfg_t = jv.VocosConfig(**VOC), tv.VocosConfig(**VOC)
    jg, jw = js.finalize_rows(lambda p, mel: jv.vocos_decode(p, mel, vcfg_j), vp, cond=jnp.asarray(d["cond"]),
                              cond_lens=jnp.asarray(d["cond_lens"]), text=jnp.asarray(d["text"]),
                              duration=jnp.asarray(d["duration"]), y=jnp.asarray(d["y"]),
                              out_start=jnp.asarray(out_start), edit_mask=None if em is None else jnp.asarray(em))
    tg, tw = ts.finalize_rows(lambda p, mel: tv.vocos_decode(p, mel, vcfg_t), tvp, cond=_t(d["cond"]),
                              cond_lens=_t(d["cond_lens"]), text=_t(d["text"]), duration=_t(d["duration"]),
                              y=_t(d["y"]), out_start=_t(out_start), edit_mask=None if em is None else _t(em))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sampler_kw,steps", [
    (dict(method="ralston", steps=10), 10), (dict(method="ralston", steps=10), 8), (dict(method="ralston", steps=10), 3),
    (dict(method="euler", steps=32), 32), (dict(method="euler", steps=32, sway_sampling_coef=None), 7),
    (dict(method="heun", steps=4, time_grid=(0.0, 0.1, 0.4, 0.7, 1.0)), 4),
    (dict(method="heun", steps=4, time_grid=(0.0, 0.1, 0.4, 0.7, 1.0)), 5),
])
def test_resolved_time_grid_matches_jax(sampler_kw, steps):
    got = ts.resolved_time_grid(te.SamplerConfig(**sampler_kw), steps)
    want = js.resolved_time_grid(je.SamplerConfig(**sampler_kw), steps)
    assert got.dtype == np.float64 and np.array_equal(got, want)
