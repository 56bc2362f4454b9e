"""Speech edit in the port (``TTSEngine.prepare_edit_row``/``speech_edit``,
``cli/speech_edit.py``) against the JAX engine on the CPU at a tiny geometry
(dim 64, depth 2), fp32, atol/rtol 1e-4: the edit row field by field, the edit
solve (``edit_mask`` + per-row ``out_start``) against the JAX edit program
through the same ``y0``, edit rows co-batched with synthesis rows, dispatch/
fetch pipelining at depth 3 bit-equal to depth 1, and the CLI."""

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
DIT = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=95, text_dim=32,
           conv_layers=1, max_pos=512)
VOC = dict(input_channels=20, dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {" ": 0, **{chr(i): i - 31 for i in range(33, 127)}}
ENGINE = dict(duration_buckets=(128, 256), batch_buckets=(1, 2, 4), text_pad=64, compute_dtype="float32")


@pytest.fixture(scope="module")
def engines():
    dp = jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(0), jd.DiTConfig(**DIT)))
    vp = jax.tree.map(np.asarray, jv.init_vocos(jax.random.PRNGKey(1), jv.VocosConfig(**VOC)))
    j = j_engine.TTSEngine(dp, jd.DiTConfig(**DIT), vp, JTokenizer(VOCAB), j_engine.EngineConfig(
        mel=JMelConfig(n_mels=20), vocoder=jv.VocosConfig(**VOC), sampler=je.SamplerConfig(steps=2), **ENGINE))
    t = t_engine.TTSEngine(dp, td.DiTConfig(**DIT), vp, TTokenizer(VOCAB), t_engine.EngineConfig(
        mel=TMelConfig(n_mels=20), vocoder=tv.VocosConfig(**VOC), sampler=te.SamplerConfig(steps=2), **ENGINE),
        device="cpu")
    rng = np.random.default_rng(2)
    audio = (0.1 * np.sin(np.arange(48000) / 7.0) + 0.03 * rng.standard_normal(48000)).astype(np.float32)  # 2 s
    return j, t, audio


@pytest.mark.parametrize("parts,fixes,sr", [([(0.5, 1.0)], None, 24000), ([(0.2, 0.4), (1.1, 1.5)], [0.3, 0.1], 24000),
                                            ([(0.5, 1.0)], [1.5], 16000)])
def test_prepare_edit_row_matches_jax(engines, parts, fixes, sr):
    j, t, audio = engines
    audio = audio[: int(len(audio) * sr / 24000)]
    jr, jrms = j.prepare_edit_row(audio, sr, "some call me optimist.", parts, fixes, steps=4, cfg_strength=1.5, seed=5)
    tr, trms = t.prepare_edit_row(audio, sr, "some call me optimist.", parts, fixes, steps=4, cfg_strength=1.5, seed=5)
    assert (tr.text, tr.ref_frames, tr.duration, tr.steps, tr.cfg_strength, tr.seed, tr.quality) == \
           (jr.text, jr.ref_frames, jr.duration, jr.steps, jr.cfg_strength, jr.seed, jr.quality)
    assert tr.edit_mask.dtype == bool and np.array_equal(tr.edit_mask, jr.edit_mask) and not tr.edit_mask.all()
    np.testing.assert_allclose(tr.cond_mel, jr.cond_mel, atol=1e-4, rtol=1e-5)
    assert trms == pytest.approx(jrms)
    wave = np.linspace(-1, 1, 2000, dtype=np.float32)
    for (jw, jsr, _), (tw, tsr, _) in [(j.finalize_edit(jr, r, wave, None), t.finalize_edit(tr, r, wave, None))
                                       for r in (0.01, 0.5)]:
        assert jsr == tsr and np.array_equal(np.asarray(jw), tw)


def test_edit_solve_matches_jax_program_through_y0(engines):
    """The edit program (``engine.py:371-383``: ``edit_mask``, roll by the
    per-row ``out_start``, Vocos) with explicit noise, one edit row beside a
    synthesis row, against the port's ``bucket_program``."""
    j, t, audio = engines
    er, _ = t.prepare_edit_row(audio, 24000, "some call me optimist.", [(0.5, 1.0)], seed=5)
    sr_ = t_engine.RowSpec(text="others call me nature.", cond_mel=er.cond_mel[:40], ref_frames=40, duration=150,
                           steps=2, seed=6)
    rows = [er, sr_]
    nb = 256
    text_ids, cond, cond_lens, dur, out_start, em, _ = t._pack_group(rows, [0, 1], nb, 2)
    assert list(out_start) == [0, 40] and not em[0].all() and em[1].all()
    y0 = np.random.default_rng(9).standard_normal((2, nb, 20)).astype(np.float32)
    sampler = j._request_sampler(2, 2.0)

    @jax.jit
    def jax_edit_program(dp, vp, cond, cond_lens, text, duration, edit_mask, out_start, y0):
        mel_out = je.sample_cfm(dp, j.dit_cfg, cond=cond, cond_lens=cond_lens, text=text, duration=duration,
                                sampler=sampler, y0=y0, edit_mask=edit_mask)
        idx = (jnp.arange(nb)[None, :] + out_start[:, None]) % nb
        gen = jnp.take_along_axis(mel_out, idx[..., None], axis=1)
        gen = jnp.where(jnp.arange(nb)[None, :, None] < (duration - out_start)[:, None, None], gen, 0.0)
        return gen, j._decode(vp, gen)

    jg, jw = jax_edit_program(j.dit_params, j.vocos_params, *(jnp.asarray(a) for a in
                                                              (cond, cond_lens, text_ids, dur, em, out_start, y0)))
    tg, tw = t.bucket_program(*(torch.as_tensor(a) for a in (cond, cond_lens, text_ids, dur)), steps=2,
                              cfg_strength=2.0, y0=torch.as_tensor(y0), edit_mask=torch.as_tensor(em),
                              out_start=torch.as_tensor(out_start))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-4, rtol=1e-4)
    # the kept frames of the edit row come back verbatim (rolled by 0)
    keep = em[0, : dur[0]]
    np.testing.assert_array_equal(tg.numpy()[0, : dur[0]][keep], cond[0, : dur[0]][keep])


def test_edit_rows_cobatch_with_synthesis_rows(engines):
    """An edit row and synthesis rows share one batched solve, and each row
    equals its solo solve; the engine's ``speech_edit`` returns the whole
    utterance, and ``fix_durations`` changes its length."""
    _, t, audio = engines
    edit_row, rms = t.prepare_edit_row(audio, 24000, "some call me optimist.", [(0.5, 1.0)], seed=5)
    ref_mel = edit_row.cond_mel[:47]
    synth = [t_engine.RowSpec(text="others call me nature.", cond_mel=ref_mel, ref_frames=47, duration=200, steps=2,
                              seed=11),
             t_engine.RowSpec(text="call me optimist.", cond_mel=ref_mel, ref_frames=47, duration=160, steps=2, seed=12)]
    calls = []
    program = t.bucket_program
    t.bucket_program = lambda *a, **kw: calls.append(kw.get("edit_mask") is not None) or program(*a, **kw)
    try:
        solo = [t.synthesize_rows([r])[0] for r in [edit_row, *synth]]
        del calls[:]
        batched = t.synthesize_rows([edit_row, *synth])
        assert calls == [True]  # one solve, through the edit path
    finally:
        del t.bucket_program
    for (ws, ms), (wb, mb) in zip(solo, batched):
        np.testing.assert_allclose(wb, ws, atol=1e-5)
        np.testing.assert_allclose(mb, ms, atol=1e-5)
    wave, sr, _ = t.finalize_edit(edit_row, rms, *batched[0])
    assert sr == 24000 and np.isfinite(wave).all() and len(batched[0][1]) == edit_row.duration
    w1, _, _ = t.speech_edit(audio, 24000, "some call me optimist.", [(0.5, 1.0)], seed=5)
    w2, _, _ = t.speech_edit(audio, 24000, "some call me optimist.", [(0.5, 1.0)], [1.5], seed=5)
    assert len(w1) > 24000 and np.isfinite(w1).all() and len(w2) > len(w1)


def test_fetch_pipelining_depth_3_bit_equal_to_depth_1(engines):
    """Rows of four solve groups (two buckets, two step counts): queuing up to
    three solves before the first fetch changes nothing, bit for bit."""
    import dataclasses

    _, t, audio = engines
    mel = t.prepare_request("x.", audio, 24000, "ref.").rows[0].cond_mel
    rows = [t_engine.RowSpec(text=f"row {i} text.", cond_mel=mel[:30], ref_frames=30, duration=d, steps=s, seed=i)
            for i, (d, s) in enumerate([(100, 2), (200, 2), (110, 1), (220, 1), (90, 2)])]
    out = {}
    for depth in (1, 3):
        t.cfg = dataclasses.replace(t.cfg, fetch_pipeline_depth=depth)
        out[depth] = t.synthesize_rows(rows)
    t.cfg = dataclasses.replace(t.cfg, fetch_pipeline_depth=3)
    for (w1, m1), (w3, m3) in zip(out[1], out[3]):
        assert np.array_equal(w1, w3) and np.array_equal(m1, m3)
    with pytest.raises(ValueError, match="fetch_pipeline_depth"):
        t_engine.EngineConfig(fetch_pipeline_depth=0)


def test_speech_edit_cli(tmp_path):
    from f5tts_tpu_torch.audio.io import read_wav, write_wav

    src = tmp_path / "in.wav"
    write_wav(str(src), (0.1 * np.sin(np.arange(36000) / 5.0)).astype(np.float32))
    out = tmp_path / "edited.wav"
    base = [sys.executable, "-m", "f5tts_tpu_torch.cli.speech_edit", "--demo-tiny", "--nfe", "2", "--audio", str(src),
            "--target-text", "a new middle.", "--parts", "0.4,0.8", "-o", str(out), "--seed", "1"]
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run(base + ["--device", "cpu"], capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    wave, sr = read_wav(str(out))
    assert sr == 24000 and len(wave) == (36000 // 256 - 1) * 256 and np.isfinite(wave).all()
    r = subprocess.run(base, capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
