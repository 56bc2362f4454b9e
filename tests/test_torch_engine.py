"""The port's engine (``f5tts_tpu_torch/engine``) against the JAX package on the
CPU at a tiny geometry: the per-bucket program (sampler + roll/mask + Vocos)
with explicit noise against the JAX composition of ``engine.py:336-353``
(fp32, atol 1e-4), request planning against the JAX engine's
``prepare_request``, an end-to-end ``synthesize``, ``quality="strict"``
escalation counts against the JAX engine on the same rows, streaming against
the batch path, ``synthesize_batch``, ``warmup``, and the CLI."""

import dataclasses
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
    js = j.prepare_request(text, ref, 24000, "Reference text.", seed=3, quality="strict")
    ts = t.prepare_request(text, ref, 24000, "Reference text.", seed=3, quality="strict")
    assert [r.quality for r in ts.rows] == [r.quality for r in js.rows] == ["strict"] * len(jp.rows)
    assert [r.quality for r in tp.rows] == ["default"] * len(tp.rows)
    for engine in (j, t):
        with pytest.raises(ValueError, match="default|strict"):
            engine.prepare_request(text, ref, 24000, "Reference text.", quality="best")


def _engine_pair(params, sampler_kw, **cfg_kw):
    """The JAX engine and the port's (fp32, CPU) on the same params and config."""
    dp, vp = params
    j = j_engine.TTSEngine(dp, jd.DiTConfig(**DIT), vp, JTokenizer(VOCAB), j_engine.EngineConfig(
        mel=JMelConfig(n_mels=20), vocoder=jv.VocosConfig(**VOC), compute_dtype="float32",
        sampler=je.SamplerConfig(**sampler_kw), **cfg_kw))
    t = t_engine.TTSEngine(dp, td.DiTConfig(**DIT), vp, TTokenizer(VOCAB), t_engine.EngineConfig(
        mel=TMelConfig(n_mels=20), vocoder=tv.VocosConfig(**VOC), compute_dtype="float32",
        sampler=te.SamplerConfig(**sampler_kw), **cfg_kw), device="cpu")
    return j, t


def _strict_rows(engine, row_cls):
    """Two strict rows of one request plus one default row of another voice."""
    ref = (0.1 * np.sin(np.arange(30000) / 9.0)).astype(np.float32)
    plan = engine.prepare_request("First sentence of the request. A second one, to make another row.", ref, 24000,
                                  "Ref.", seed=5, quality="strict", fix_duration_secs=1.6)
    rows = list(plan.rows[:1]) * 2
    first = rows[0]
    return rows + [row_cls(text="Ref. other", cond_mel=first.cond_mel * 0.5, ref_frames=first.ref_frames,
                           duration=first.duration - 7, steps=first.steps, cfg_strength=first.cfg_strength, seed=9)]


@pytest.mark.parametrize("threshold,want", [(0.0, 2), (1e9, 0)])
def test_strict_escalation_counts_match_jax(params, threshold, want):
    """Strict rows whose estimate passes the threshold are solved again with
    the euler-32 recipe: the same rows escalate in both engines (the noise
    differs between ``jax.random`` and torch, so the thresholds are the two
    ends: every estimate passes 0, none passes 1e9), and both record an
    estimate for every row of the strict group."""
    kw = dict(duration_buckets=(256, 512), batch_buckets=(1, 2, 4), strict_threshold=threshold)
    j, t = _engine_pair(params, dict(steps=2, method="ralston"), **kw)
    assert j._supports_estimate() and t._supports_estimate()
    j_out = j.synthesize_rows(_strict_rows(j, j_engine.RowSpec))
    rows = _strict_rows(t, t_engine.RowSpec)
    t_out = t.synthesize_rows(rows)
    assert t.escalations == j.escalations == want
    assert set(t.last_estimates) == set(j.last_estimates) == {0, 1, 2}
    assert all(e > 0 and np.isfinite(e) for e in t.last_estimates.values())
    for (tw, tm), (jw, jm_) in zip(t_out, j_out):
        assert tw.shape == jw.shape and tm.shape == jm_.shape and np.isfinite(tw).all()
    if want:  # the escalated rows carry the recipe's solve of the same seed, the default row does not
        _, recipe = _engine_pair(params, dict(steps=32, method="euler"), **kw)
        r_out = recipe.synthesize_rows([dataclasses.replace(r, steps=32, quality="default") for r in rows])
        for i in (0, 1):
            np.testing.assert_allclose(t_out[i][1], r_out[i][1], atol=1e-4, rtol=1e-4)
        assert np.abs(t_out[2][1] - r_out[2][1]).max() > 1e-3
        t.synthesize_rows(rows[2:])  # a call with no strict row: no estimates, the count stays
        assert t.last_estimates == {} and t.escalations == want


def test_strict_is_a_noop_without_a_two_stage_estimate(params):
    """With the euler recipe (or a reduced-guidance knob) configured there is
    no embedded estimate: strict rows solve once, in both engines."""
    for sampler_kw in (dict(steps=2, method="euler"), dict(steps=2, method="euler", cfg_cache_period=2),
                       dict(steps=2, method="heun", cfg_interval=(0.0, 0.6))):
        j, t = _engine_pair(params, sampler_kw, duration_buckets=(256,), batch_buckets=(1, 2, 4), strict_threshold=0.0)
        assert not j._supports_estimate() and not t._supports_estimate()
        t.synthesize_rows(_strict_rows(t, t_engine.RowSpec))
        assert t.escalations == 0 and t.last_estimates == {}
    j.synthesize_rows(_strict_rows(j, j_engine.RowSpec))
    assert j.escalations == 0 and j.last_estimates == {}


def test_streaming_chunks_concatenate_to_the_batch_wave(params):
    """The streamed segments (one per chunk, crossfades blended across
    yields) concatenate to ``synthesize``'s wave for the same seed; each chunk
    is solved alone instead of in one batch, so fp32 sums differ in order
    (atol 1e-5 at a wave peak of ~1)."""
    engine = _torch_engine(params, duration_buckets=(256, 512, 1024), batch_buckets=(1, 2, 4))
    ref = (0.1 * np.sin(np.arange(30000) / 7.0)).astype(np.float32)
    text = "One sentence here, with a clause. And another one follows it, for a second row. Then a third to close."
    kw = dict(seed=4, cross_fade_duration=0.05, speed=1.0)
    wave, sr, _ = engine.synthesize(text, ref, 24000, "Ref.", **kw)
    plan = engine.prepare_request(text, ref, 24000, "Ref.", **kw)
    segments = list(engine.synthesize_streaming(text, ref, 24000, "Ref.", **kw))
    assert len(plan.rows) > 1 and len(segments) == len(plan.rows)
    stream = np.concatenate(segments)
    assert stream.shape == wave.shape
    np.testing.assert_allclose(stream, wave, atol=1e-5)
    one = list(engine.synthesize_streaming("Short.", ref, 24000, "Ref.", seed=4))
    assert len(one) == 1
    np.testing.assert_allclose(one[0], engine.synthesize("Short.", ref, 24000, "Ref.", seed=4)[0], atol=1e-5)


def test_synthesize_batch_and_warmup(params):
    engine = _torch_engine(params, duration_buckets=(256, 512), batch_buckets=(1, 2, 4))
    ref = (0.1 * np.sin(np.arange(30000) / 7.0)).astype(np.float32)
    plan = engine.prepare_request("A first chunk of text.", ref, 24000, "Ref.", seed=2)
    row = plan.rows[0]
    chunks, durations = ["Ref. one two.", "Ref. three four five.", "Ref. six."], [200, 230, 300]
    waves, mels = engine.synthesize_batch([c[5:] for c in chunks], row.cond_mel, row.ref_frames, "Ref. ", durations,
                                          steps=2, cfg_strength=2.0, seed=2)
    rows = [t_engine.RowSpec(text=c, cond_mel=row.cond_mel, ref_frames=row.ref_frames, duration=d, steps=2,
                             cfg_strength=2.0, seed=2) for c, d in zip(chunks, durations)]
    for (w, m), bw, bm in zip(engine.synthesize_rows(rows), waves, mels):
        np.testing.assert_array_equal(w, bw)
        np.testing.assert_array_equal(m, bm)
    assert [len(m) for m in mels] == [d - row.ref_frames for d in durations]

    solved = []
    program = engine.bucket_program
    engine.bucket_program = lambda *a, **kw: (solved.append((a[0].shape, kw["steps"])), program(*a, **kw))[1]
    engine.warmup()  # the smallest bucket at batch 1, the configured steps
    engine.warmup([(512, 4), (256, 2)], nfe_step=2)  # ralston: 2 evals per interval -> 1 interval
    assert solved == [((1, 256, 20), 2), ((4, 512, 20), 1), ((2, 256, 20), 1)]


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
