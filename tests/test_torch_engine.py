"""The port's engine (``f5tts_tpu_torch/engine``) against the JAX package on the
CPU at a tiny geometry: the per-bucket program (sampler + roll/mask + Vocos)
with explicit noise against the JAX composition of ``engine.py:336-353``
(fp32, atol 1e-4), request planning against the JAX engine's
``prepare_request``, an end-to-end ``synthesize``, and the CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.engine import engine as j_engine
from f5tts_tpu.models import dit as jd
from f5tts_tpu.models import vocos as jv
from f5tts_tpu.ops.mel import MelConfig as JMelConfig
from f5tts_tpu.sampling import euler as je
from f5tts_tpu.text.tokenizer import Tokenizer as JTokenizer
from f5tts_tpu_torch.engine import engine as t_engine
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.models import vocos as tv
from f5tts_tpu_torch.ops.mel import MelConfig as TMelConfig
from f5tts_tpu_torch.sampling import euler as te
from f5tts_tpu_torch.text.tokenizer import Tokenizer as TTokenizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIT = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20, text_num_embeds=95, text_dim=32,
           conv_layers=1, max_pos=1024)
VOC = dict(input_channels=20, dim=48, intermediate_dim=96, num_layers=2)
VOCAB = {" ": 0, **{chr(i): i - 31 for i in range(33, 127)}}


@pytest.fixture(scope="module")
def params():
    dp = jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(0), jd.DiTConfig(**DIT)))
    vp = jax.tree.map(np.asarray, jv.init_vocos(jax.random.PRNGKey(1), jv.VocosConfig(**VOC)))
    return dp, vp


def _torch_engine(params, dtype="float32", **kw):
    dp, vp = params
    cfg = t_engine.EngineConfig(mel=TMelConfig(n_mels=20), vocoder=tv.VocosConfig(**VOC), compute_dtype=dtype,
                                sampler=te.serving_default_sampler(steps=2), **kw)
    return t_engine.TTSEngine(dp, td.DiTConfig(**DIT), vp, TTokenizer(VOCAB), cfg, device="cpu")


def test_bucket_program_matches_jax_composition(params):
    dp, vp = params
    rng = np.random.default_rng(2)
    b, n = 2, 128
    cond = rng.standard_normal((b, n, 20)).astype(np.float32)
    cond_lens = np.array([30, 45], np.int32)
    text = np.where(np.arange(40)[None] < np.array([[40], [25]]), rng.integers(0, 90, (b, 40)), -1).astype(np.int32)
    duration = np.array([128, 100], np.int32)
    y0 = rng.standard_normal((b, n, 20)).astype(np.float32)
    jcfg, vcfg = jd.DiTConfig(**DIT), jv.VocosConfig(**VOC)
    sampler = je.serving_default_sampler(steps=2)

    @jax.jit
    def jax_program(dp, vp, cond, cond_lens, text, duration, y0):  # engine.py:336-353 with explicit noise
        mel_out = je.sample_cfm(dp, jcfg, cond=cond, cond_lens=cond_lens, text=text, duration=duration,
                                sampler=sampler, y0=y0)
        idx = (jnp.arange(n)[None, :] + cond_lens[:, None]) % n
        gen = jnp.take_along_axis(mel_out, idx[..., None], axis=1)
        gen = jnp.where(jnp.arange(n)[None, :, None] < (duration - cond_lens)[:, None, None], gen, 0.0)
        return gen, jv.vocos_decode(vp, gen, vcfg)

    j_gen, j_wave = jax_program(dp, vp, *(jnp.asarray(a) for a in (cond, cond_lens, text, duration, y0)))
    engine = _torch_engine(params)
    t_gen, t_wave = engine.bucket_program(*(torch.as_tensor(a) for a in (cond, cond_lens, text, duration)),
                                          steps=2, cfg_strength=2.0, y0=torch.as_tensor(y0))
    np.testing.assert_allclose(t_gen.numpy(), np.asarray(j_gen), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_wave.numpy(), np.asarray(j_wave), atol=1e-4, rtol=1e-4)


def test_prepare_request_matches_jax(params):
    dp, vp = params
    j = j_engine.TTSEngine(dp, jd.DiTConfig(**DIT), vp, JTokenizer(VOCAB), j_engine.EngineConfig(
        mel=JMelConfig(n_mels=20), vocoder=jv.VocosConfig(**VOC), sampler=je.serving_default_sampler(steps=2)))
    t = _torch_engine(params)
    rng = np.random.default_rng(4)  # broadband: a pure tone leaves mel bins at the log floor's edge
    ref = (0.1 * np.sin(np.arange(48000) / 9.0) + 0.02 * rng.standard_normal(48000)).astype(np.float32)
    text = "Hello world, this is a fairly long sentence. " * 6
    jp = j.prepare_request(text, ref, 24000, "Reference text.", seed=3)
    tp = t.prepare_request(text, ref, 24000, "Reference text.", seed=3)
    assert len(tp.rows) == len(jp.rows) > 1 and tp.rms == pytest.approx(jp.rms)
    for a, b in zip(tp.rows, jp.rows):
        assert (a.text, a.ref_frames, a.duration, a.steps, a.cfg_strength, a.seed) == \
               (b.text, b.ref_frames, b.duration, b.steps, b.cfg_strength, b.seed)
        np.testing.assert_allclose(a.cond_mel, b.cond_mel, atol=1e-4, rtol=1e-5)
    with pytest.raises(NotImplementedError):
        t.prepare_request(text, ref, 24000, "Reference text.", quality="strict")


def test_synthesize_end_to_end(params):
    engine = _torch_engine(params, dtype="bfloat16", duration_buckets=(256, 512), batch_buckets=(1, 2, 4))
    ref = (0.1 * np.sin(np.arange(36000) / 7.0)).astype(np.float32)
    wave, sr, mel = engine.synthesize("One sentence here. And another one follows it, for a second row.",
                                      ref, 24000, "Ref.", seed=0)
    assert sr == 24000 and wave.ndim == 1 and len(wave) > 0 and np.isfinite(wave).all()
    assert mel.shape[1] == 20 and np.isfinite(mel).all()
    again, _, _ = engine.synthesize("One sentence here. And another one follows it, for a second row.",
                                    ref, 24000, "Ref.", seed=0)
    np.testing.assert_array_equal(wave, again)  # seeded noise: reproducible


def test_cli_demo_tiny_writes_a_wav(tmp_path):
    out = tmp_path / "demo.wav"
    proc = subprocess.run(
        [sys.executable, "-m", "f5tts_tpu_torch.cli.infer", "--demo-tiny", "--device", "cpu", "--nfe", "4",
         "-t", "Hello from the port.", "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from f5tts_tpu_torch.audio.io import read_wav

    wave, sr = read_wav(str(out))
    assert sr == 24000 and len(wave) > 0
