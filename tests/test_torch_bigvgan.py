"""Parity of the port's BigVGAN vocoder (``f5tts_tpu_torch/models/bigvgan.py``)
with ``f5tts_tpu/models/bigvgan.py`` on the CPU: the anti-aliased snake
(atol 1e-5), ``bigvgan_decode`` at the small config of
``tests/test_bigvgan.py`` with and without anti-aliasing (fp32, atol 1e-4;
weights scaled so the tanh does not saturate), and one whole
``TTSEngine.synthesize`` request with ``vocoder_type="bigvgan"`` on the UNetT
backbone against the JAX engine, both engines given the same noise (fp32,
atol 1e-4 on the wave)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.engine import engine as j_engine
from f5tts_tpu.models import bigvgan as jb
from f5tts_tpu.models import unett as ju
from f5tts_tpu.ops.mel import MelConfig as JMelConfig
from f5tts_tpu.sampling import euler as je
from f5tts_tpu.text.tokenizer import Tokenizer as JTokenizer
from f5tts_tpu_torch.engine import engine as t_engine
from f5tts_tpu_torch.models import bigvgan as tb
from f5tts_tpu_torch.models import convert as tc
from f5tts_tpu_torch.models import unett as tu
from f5tts_tpu_torch.ops.mel import MelConfig as TMelConfig
from f5tts_tpu_torch.sampling import euler as te
from f5tts_tpu_torch.text.tokenizer import Tokenizer as TTokenizer

torch.backends.cudnn.allow_tf32 = False

SMALL = dict(mel_dim=20, upsample_initial_channel=64, upsample_rates=(4, 4, 2, 2), upsample_kernel_sizes=(8, 8, 4, 4),
             resblock_kernel_sizes=(3, 7), resblock_dilations=((1, 3), (1, 3)))


def _params(cfg: jb.BigVGANConfig, seed=0) -> dict:
    """JAX ``init_bigvgan`` plus seeded noise on every leaf (random init is
    flip-symmetric in distribution only, and snake alpha/beta start at 0),
    with ``conv_post`` scaled so the output stays inside the tanh's range."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                     jb.init_bigvgan(jax.random.PRNGKey(seed), cfg))
    p["conv_post"]["w"] = p["conv_post"]["w"] * np.float32(0.05)
    return p


def test_anti_aliased_activation():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 37, 5)).astype(np.float32)
    a, b = (rng.standard_normal(5).astype(np.float32) * 0.3 for _ in range(2))
    ref = np.asarray(jb._act(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), True))
    out = tb._act(torch.as_tensor(x).transpose(1, 2), torch.as_tensor(a), torch.as_tensor(b), True).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tb._AA_FILTER, jb._AA_FILTER)


@pytest.mark.parametrize("anti_aliased", [True, False])
def test_bigvgan_decode(anti_aliased):
    jcfg = jb.BigVGANConfig(**SMALL, anti_aliased=anti_aliased)
    tcfg = tb.BigVGANConfig(**SMALL, anti_aliased=anti_aliased)
    p = _params(jcfg)
    mel = np.random.default_rng(0).standard_normal((2, 16, 20)).astype(np.float32)
    ref = np.asarray(jb.bigvgan_decode(p, jnp.asarray(mel), jcfg))
    out = tb.bigvgan_decode(tc.bigvgan_params_from_numpy(p, "cpu"), torch.as_tensor(mel), tcfg).numpy()
    assert out.shape == (2, 16 * 64) and 0.05 < np.abs(ref).max() < 0.99
    np.testing.assert_allclose(out, ref, atol=1e-4)


UNETT = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=20, text_num_embeds=95, text_dim=16,
             conv_layers=1, max_pos=512)
ENGINE_BIGVGAN = dict(mel_dim=20, upsample_initial_channel=32, upsample_rates=(4, 4, 4, 4),
                      upsample_kernel_sizes=(8, 8, 8, 8), resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),))
VOCAB = {" ": 0, **{chr(i): i - 31 for i in range(33, 127)}}


def _fixed_noise(monkeypatch, module, to_array, noise):
    """Every ``sample_cfm`` the engine module calls draws ``noise[:b, :n]``
    in place of its per-seed noise."""
    orig = module.sample_cfm

    def sample_cfm(params, cfg, *, cond, seeds=None, y0=None, **kw):
        b, n = cond.shape[:2]
        return orig(params, cfg, cond=cond, y0=to_array(noise[:b, :n]), **kw)

    monkeypatch.setattr(module, "sample_cfm", sample_cfm)


def test_engine_request_with_bigvgan_matches_jax(monkeypatch):
    """A two-chunk request end to end (planning, batched solve, roll, BigVGAN
    decode, crossfade) on the E2-TTS backbone: the same wave as the JAX
    engine's, ``n * 256`` samples per chunk before the crossfade."""
    jcfg, tcfg = ju.UNetTConfig(**UNETT), tu.UNetTConfig(**UNETT)
    dp = jax.tree.map(np.asarray, ju.init_unett(jax.random.PRNGKey(0), jcfg))
    j_fns = {"forward_fn": ju.unett_forward, "embed_fn": ju.unett_embed}
    t_fns = {"forward_fn": tu.unett_forward, "embed_fn": tu.unett_embed}
    vp = _params(jb.BigVGANConfig(**ENGINE_BIGVGAN), seed=1)
    common = dict(compute_dtype="float32", duration_buckets=(128, 256), text_pad=128, vocoder_type="bigvgan",
                  chunk_frames_budget=256, min_chunk_gen_frames=64)
    noise = np.random.default_rng(3).standard_normal((4, 256, 20)).astype(np.float32)
    _fixed_noise(monkeypatch, j_engine, jnp.asarray, noise)
    _fixed_noise(monkeypatch, t_engine, torch.as_tensor, noise)
    j = j_engine.TTSEngine(dp, jcfg, vp, JTokenizer(VOCAB), j_engine.EngineConfig(
        mel=JMelConfig(n_mels=20, flavor="bigvgan"), sampler=je.SamplerConfig(steps=2, method="ralston"),
        bigvgan=jb.BigVGANConfig(**ENGINE_BIGVGAN), **common), **j_fns)
    t = t_engine.TTSEngine(dp, tcfg, vp, TTokenizer(VOCAB), t_engine.EngineConfig(
        mel=TMelConfig(n_mels=20, flavor="bigvgan"), sampler=te.SamplerConfig(steps=2, method="ralston"),
        bigvgan=tb.BigVGANConfig(**ENGINE_BIGVGAN), **common), device="cpu", **t_fns)
    rng = np.random.default_rng(4)
    ref = (0.1 * np.sin(np.arange(12000) / 9.0) + 0.02 * rng.standard_normal(12000)).astype(np.float32)
    text = "One short clause here, and a second one."
    plan = t.prepare_request(text, ref, 24000, "A ref.", seed=1)
    assert len(plan.rows) == 2
    rows = t.synthesize_rows(plan.rows)
    assert all(len(w) == (r.duration - r.ref_frames) * 256 for (w, _), r in zip(rows, plan.rows))
    j_wave, j_sr, j_mel = j.synthesize(text, ref, 24000, "A ref.", seed=1)
    t_wave, t_sr, t_mel = t.synthesize(text, ref, 24000, "A ref.", seed=1)
    assert t_sr == j_sr == 24000 and t_wave.shape == j_wave.shape
    np.testing.assert_allclose(t_mel, j_mel, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_wave, j_wave, atol=1e-4)
    assert np.abs(t_wave).max() > 1e-3


def test_engine_refuses_an_unknown_vocoder_and_int8_without_dit_blocks():
    with pytest.raises(ValueError, match="vocoder_type"):
        t_engine.EngineConfig(vocoder_type="hifigan")
    cfg = tu.UNetTConfig(**UNETT)
    with pytest.raises(ValueError, match="int8"):
        t_engine.TTSEngine(tc.init_unett_numpy(cfg), cfg, tc.init_vocos_numpy(), TTokenizer(VOCAB),
                           dataclasses.replace(t_engine.EngineConfig(), quantization="int8"), device="cpu",
                           forward_fn=tu.unett_forward, embed_fn=tu.unett_embed)
