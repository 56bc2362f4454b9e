"""The port's Parler engine (``f5tts_tpu_torch/engine/ar_engine.py``) on the
CPU at the demo geometry of the JAX package's server
(``f5tts_tpu/serve/server.py:241-253``), with the JAX engine's parameters
carried across as numpy arrays. fp32 throughout, JAX matmul precision
``highest``. Greedy waves against the JAX engine atol 1e-4; streaming against
the port's own batch path atol 1e-5 (as the JAX package's tests hold its
engine); everything about sampling is held against the port itself, since its
generators are not JAX's."""

import numpy as np
import pytest
import torch

import jax

from f5tts_tpu.engine import ar_engine as j_ar
from f5tts_tpu.models import parler as JP
from f5tts_tpu_torch.engine import ar_engine as t_ar
from f5tts_tpu_torch.models import parler as TP

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T5 = dict(vocab=60, d_model=24, d_kv=6, d_ff=32, heads=4, layers=2, rel_buckets=8, rel_max_dist=20)
DEC = dict(vocab=40, codebooks=4, hidden=32, layers=2, heads=4, ffn=48, cross_dim=24, prompt_vocab=60)
DAC = dict(num_codebooks=4, codebook_size=40, codebook_dim=6, latent_dim=24, decoder_dim=16, rates=(4, 2))
DEMO = dict(max_frames=32, desc_pad=64, prompt_pad=64, temperature=0.0, eos_token=-1, compute_dtype="float32",
            batch_buckets=(1, 2, 4))


def encode_fn(text):
    return [ord(c) % 60 for c in text]


@pytest.fixture(scope="module")
def jax_params():
    kt, kd, kq = jax.random.split(jax.random.PRNGKey(0), 3)
    return (JP.init_t5_encoder(kt, JP.T5Config(**T5)), JP.init_parler_decoder(kd, JP.ParlerDecoderConfig(**DEC)),
            JP.init_dac_decoder(kq, JP.DacConfig(**DAC)))


def _torch_engine(jax_params, **overrides):
    t5, dec, dac = (jax.tree.map(np.asarray, p) for p in jax_params)
    return t_ar.ParlerTTSEngine(t5, TP.T5Config(**T5), dec, TP.ParlerDecoderConfig(**DEC), dac, TP.DacConfig(**DAC),
                                t_ar.ParlerEngineConfig(**{**DEMO, **overrides}), encode_fn=encode_fn, device="cpu")


def _jax_engine(jax_params, **overrides):
    t5, dec, dac = jax_params
    return j_ar.ParlerTTSEngine(t5, JP.T5Config(**T5), dec, JP.ParlerDecoderConfig(**DEC), dac, JP.DacConfig(**DAC),
                                j_ar.ParlerEngineConfig(**{**DEMO, **overrides}), encode_fn=encode_fn)


def test_pad_ids_match_jax():
    ids = [list(range(1, 11)), [5, 6], []]
    for side in ("left", "right"):
        got = t_ar.ParlerTTSEngine._pad_ids(None, ids, 4, side=side)
        want = j_ar.ParlerTTSEngine._pad_ids(None, ids, 4, side=side)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    out, mask = t_ar.ParlerTTSEngine._pad_ids(None, ids, 4, side="left")
    assert out[0].tolist() == [7, 8, 9, 10] and mask[0].all()  # over-long prompts keep their tail
    assert out[1].tolist() == [0, 0, 5, 6] and mask[1].tolist() == [False, False, True, True]


@pytest.mark.parametrize("jax_decode_attn", [None, "pallas"])
def test_greedy_synthesize_batch_matches_the_jax_engine(jax_params, jax_decode_attn):
    descs = ["a calm speaker in a quiet room.", "a fast, bright voice.", "deep and slow."]
    prompts = ["hello there.", "the second, rather longer utterance of the batch.", "ok."]
    want = _jax_engine(jax_params, max_frames=12, decode_attn=jax_decode_attn).synthesize_batch(descs, prompts)
    engine = _torch_engine(jax_params, max_frames=12)
    assert engine.dec_cfg.decode_attn == "kernel" and engine.dec_cfg.fuse_decode_qkv  # the serving configuration
    got = engine.synthesize_batch(descs, prompts)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape == (12 * 8,)
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_greedy_eos_trims_rows_like_the_jax_engine(jax_params):
    descs, prompts = ["a calm voice.", "another voice."], ["short utterance.", "a second one."]
    free = _torch_engine(jax_params, max_frames=16)
    codes, _ = TP.parler_generate(
        free.dec_params, free.dec_cfg, free._encode(*free._to_device(*free._pad_ids([encode_fn(d) for d in descs], 64))),
        torch.as_tensor(free._pad_ids([encode_fn(d) for d in descs], 64)[1]), 16, 0,
        prompt_ids=torch.as_tensor(free._pad_ids([encode_fn(p) for p in prompts], 64, "left")[0]),
        prompt_mask=torch.as_tensor(free._pad_ids([encode_fn(p) for p in prompts], 64, "left")[1]),
        eos_token=-1, temperature=0.0)
    eos = int(codes[0, 0, 5])
    got = _torch_engine(jax_params, max_frames=16, eos_token=eos).synthesize_batch(descs, prompts)
    want = _jax_engine(jax_params, max_frames=16, eos_token=eos).synthesize_batch(descs, prompts)
    assert len(got[0]) <= 5 * 8 < 16 * 8
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_synthesize_rows_snaps_to_buckets_and_splits_at_the_top(jax_params):
    engine = _torch_engine(jax_params, max_frames=6)
    sizes = []
    batch = engine.synthesize_batch

    def recording(descriptions, prompts, **kw):
        sizes.append(len(descriptions))
        assert kw["strict_lengths"] and len(kw["row_seeds"]) == len(descriptions)
        return batch(descriptions, prompts, **kw)

    engine.synthesize_batch = recording
    rows = [t_ar.ParlerRow("a speaker.", f"utterance {i}.", seed=i) for i in range(7)]
    results = engine.synthesize_rows(rows)
    assert sizes == [4, 4]  # 7 rows: one full top bucket, then 3 snapped up to 4 by repeating the last row
    # each row's de-delayed codes ride beside its wave: (codebooks, frames), the wave's 48 samples at hop 8
    assert len(results) == 7 and all(r[1].shape == (DEC["codebooks"], 6) and r[1].dtype == np.int64
                                     and np.isfinite(r[0]).all() and len(r[0]) == 48 for r in results)
    sizes.clear()
    alone = engine.synthesize_rows(rows[6:])
    assert sizes == [1]
    np.testing.assert_allclose(alone[0][0], results[6][0], atol=1e-5)  # greedy: a row does not depend on its batch


def test_row_seed_composition_invariance(jax_params):
    engine = _torch_engine(jax_params, max_frames=8, temperature=0.8, top_k=8)
    target = t_ar.ParlerRow("a calm speaker.", "the target utterance.", seed=41)
    alone = engine.synthesize_rows([target])[0][0]
    others = [t_ar.ParlerRow("another speaker.", f"filler {i}.", seed=100 + i) for i in range(3)]
    batched = engine.synthesize_rows(others[:1] + [target] + others[1:])[1][0]
    np.testing.assert_allclose(alone, batched, atol=1e-5)
    reseeded = engine.synthesize_rows([t_ar.ParlerRow(target.description, target.prompt, seed=42)])[0][0]
    assert not np.allclose(alone, reseeded, atol=1e-3)


def _streaming_engine(jax_params, eos_token=-1):
    # the tiny DAC's receptive field (rates 4, 2; k = 7 dilated residuals) is ~20 latent frames: margin 24 covers it
    return _torch_engine(jax_params, max_frames=48, desc_pad=24, prompt_pad=24, temperature=0.7, eos_token=eos_token,
                         batch_buckets=(1, 2), stream_frames=8, stream_margin_frames=24)


def test_streaming_equals_batch(jax_params):
    engine = _streaming_engine(jax_params)
    d, p = "a warm voice.", "hello streaming world."
    full = engine.synthesize_batch([d], [p], row_seeds=[7], strict_lengths=True)[0]
    chunks = list(engine.synthesize_streaming(d, p, seed=7))
    assert len(chunks) > 1
    stream = np.concatenate(chunks)
    assert stream.shape == full.shape == (48 * 8,)
    np.testing.assert_allclose(stream, full, atol=1e-5)


def test_streaming_equals_batch_with_early_eos(jax_params):
    d, p = "a calm voice.", "short utterance."
    found = None
    for cand in range(40):  # a token the sampled decode emits mid-stream in codebook 0
        wave = _streaming_engine(jax_params, cand).synthesize_batch([d], [p], row_seeds=[3], strict_lengths=True)[0]
        if 8 < len(wave) // 8 < 48:
            found = (cand, wave)
            break
    assert found is not None, "no candidate EOS token ended the row mid-stream"
    cand, full = found
    chunks = list(_streaming_engine(jax_params, cand).synthesize_streaming(d, p, seed=3))
    stream = np.concatenate(chunks)
    assert stream.shape == full.shape
    np.testing.assert_allclose(stream, full, atol=1e-5)


def test_description_cache_is_exact_and_bounded(jax_params):
    engine = _torch_engine(jax_params, max_frames=6, temperature=0.9, top_k=8)
    calls = []
    encode = engine._encode
    engine._encode = lambda *a: (calls.append(1), encode(*a))[1]
    rows = [t_ar.ParlerRow("calm voice.", f"utterance {i}.", seed=100 + i) for i in range(3)]
    cold = [w for w, _ in engine.synthesize_rows(rows)]
    assert engine.desc_cache_misses == 4 and engine.desc_cache_hits == 0 and len(calls) == 1
    warm = [w for w, _ in engine.synthesize_rows(rows)]
    assert engine.desc_cache_hits == 4 and engine.desc_cache_misses == 4 and len(calls) == 1  # the T5 did not run
    for c, w in zip(cold, warm):
        np.testing.assert_array_equal(c, w)
    assert all(v.device.type == "cpu" and v.shape == (64, 24) for v in engine._desc_cache.values())
    engine.desc_cache_max = 4
    for i in range(8):
        engine.synthesize_rows([t_ar.ParlerRow(f"style {i}.", "hello.", seed=i)])
    assert len(engine._desc_cache) <= 4
    long_a, long_b = "d" * 70 + "x", "d" * 70 + "y"  # equal once truncated to desc_pad: one entry
    engine.synthesize_batch([long_a], ["hi."])
    hits = engine.desc_cache_hits
    engine.synthesize_batch([long_b], ["hi."])
    assert engine.desc_cache_hits == hits + 1


def test_validate_and_strict_lengths(jax_params):
    engine = _torch_engine(jax_params, max_frames=4, desc_pad=24, prompt_pad=24)
    engine.validate_lengths("short desc.", "short text.")
    with pytest.raises(ValueError, match="token budget"):
        engine.validate_lengths("short desc.", "x" * 100)
    with pytest.raises(ValueError, match="token budget"):
        engine.validate_lengths("d" * 100, "short text.")
    with pytest.raises(ValueError, match="row 1"):
        engine.synthesize_batch(["ok.", "ok."], ["fine.", "x" * 100], strict_lengths=True)
    with pytest.raises(ValueError, match="token budget"):
        list(engine.synthesize_streaming("d" * 100, "hi."))
    with pytest.raises(ValueError, match="pair up"):
        engine.synthesize_batch(["one."], ["a.", "b."])
    assert len(engine.synthesize_batch(["ok."], ["x" * 100])[0]) == 4 * 8  # not strict: clipped, still served
    engine.encode_fn = None
    engine.validate_lengths("anything", "x" * 1000)  # ids come from the caller: nothing to validate


def test_engine_config_and_device(jax_params, monkeypatch):
    engine = _torch_engine(jax_params, decode_attn="plain", fuse_decode_qkv=None)
    assert engine.dec_cfg.decode_attn == "plain" and engine.dec_cfg.fuse_decode_qkv is False
    assert engine.device == torch.device("cpu") and engine.dec_params["lm_heads"].dtype == torch.float32
    engine.warmup((1, 2))
    assert engine.desc_cache_misses == 3 and engine.desc_cache_hits == 0 or engine.desc_cache_hits == 2
    with pytest.raises(ValueError, match="compute_dtype"):
        t_ar.ParlerEngineConfig(compute_dtype="float16")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t5, dec, dac = (jax.tree.map(np.asarray, p) for p in jax_params)
    with pytest.raises(RuntimeError, match="CUDA"):  # no silent fall-back to the CPU
        t_ar.ParlerTTSEngine(t5, TP.T5Config(**T5), dec, TP.ParlerDecoderConfig(**DEC), dac, TP.DacConfig(**DAC))
