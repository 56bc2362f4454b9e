"""The port's AR mel decoder (``f5tts_tpu_torch/models/ar.py``) and
``ARTTSEngine`` against the JAX package on the CPU.

The same numpy trees (from the JAX ``init_ar`` / ``init_vocos``) and seeded
inputs go through both; fp32, JAX matmul precision ``highest``. Tolerances:
``ar_loss`` and its aux atol 1e-5, gradients atol 1e-4; generated mel atol
1e-4 with lengths equal; engine waves atol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.engine.ar_engine import AREngineConfig as JAREngineConfig
from f5tts_tpu.engine.ar_engine import ARTTSEngine as JARTTSEngine
from f5tts_tpu.models import ar as JA
from f5tts_tpu.models.vocos import VocosConfig as JVocosConfig
from f5tts_tpu.models.vocos import init_vocos
from f5tts_tpu.text.tokenizer import Tokenizer as JTokenizer
from f5tts_tpu_torch.engine.ar_engine import AREngineConfig, ARTTSEngine
from f5tts_tpu_torch.models import ar as TA
from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.models.convert import ar_params_from_numpy, init_ar_numpy
from f5tts_tpu_torch.models.vocos import VocosConfig
from f5tts_tpu_torch.ops.rope import rotary_freqs
from f5tts_tpu_torch.text.tokenizer import Tokenizer

GEO = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=12, text_num_embeds=30)
CFG, J_CFG = TA.ARConfig(**GEO), JA.ARConfig(**GEO)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The generation loops run thousands of tiny ops: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def params():
    """seed -> the JAX ``init_ar`` tree as numpy."""
    return {seed: _np(JA.init_ar(jax.random.PRNGKey(seed), J_CFG)) for seed in (0, 1, 2)}


def _data(b=2, nt=8, nm=16, seed=0):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 30, (b, nt)).astype(np.int32)
    text[1, 5:] = -1
    mel = (rng.standard_normal((b, nm, CFG.mel_dim)) * 0.3).astype(np.float32)
    return text, mel, np.asarray([nm, nm - 4], np.int32)


def test_init_ar_numpy_builds_the_jax_tree(params):
    """Keys, shapes and dtypes of ``init_ar``; its init distributions (unit
    gains, ``bos`` ~ N(0, 0.02^2), torch's Linear bounds, N(0, 1) text table)."""
    cfg = TA.ARConfig()
    port = _flat(init_ar_numpy(cfg, seed=0))
    ref = _flat(jax.eval_shape(lambda: JA.init_ar(jax.random.PRNGKey(0), JA.ARConfig())))
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        assert port[k].shape == v.shape and port[k].dtype == np.float32, k
    for k in ("/blocks/attn_norm/g", "/blocks/ff_norm/g", "/norm_out/g"):
        assert np.all(port[k] == 1.0)
    assert 0.015 < port["/bos"].std() < 0.025
    assert 0.97 < port["/text_embed/w"].std() < 1.03
    for k, fan_in in (("/blocks/attn/to_q/w", cfg.dim), ("/blocks/ff/out/b", cfg.dim * cfg.ff_mult),
                      ("/mel_in/w", cfg.mel_dim), ("/mel_out/b", cfg.dim)):
        bound = fan_in**-0.5
        assert np.abs(port[k]).max() <= bound and np.abs(port[k]).max() > 0.9 * bound, k


def test_ar_loss_aux_and_gradients_match_jax(params):
    text, mel, lens = _data()
    (j_loss, j_aux), j_grads = jax.value_and_grad(JA.ar_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params[0]), J_CFG, jnp.asarray(text), jnp.asarray(mel), jnp.asarray(lens))
    tp = ar_params_from_numpy(params[0], "cpu")
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, aux = TA.ar_loss(tp, CFG, torch.as_tensor(text), torch.as_tensor(mel), torch.as_tensor(lens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    for k in ("l1", "l2", "stop_bce"):
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]), atol=1e-5, err_msg=k)
    ref = _flat(_np(j_grads))
    assert sorted(ref) == sorted(leaves)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), ref[k], atol=1e-4, err_msg=k)


def _teacher_forced(tp, text, mel):
    """Predictions of the teacher-forced pass over [text ; BOS ; mel]: the
    frame after BOS and after each frame of ``mel``."""
    with torch.no_grad():
        h = TA._embed_sequence(tp, CFG, text, mel)
        freqs = torch.as_tensor(rotary_freqs(h.shape[1], CFG.dim_head))
        valid = torch.cat([text != -1, torch.ones((text.shape[0], 1 + mel.shape[1]), dtype=torch.bool)], dim=1)
        for l in range(CFG.depth):
            h = TA._block_apply(TA._layer(tp["blocks"], l), h, CFG.heads, freqs, valid)
        h = m.rms_norm(tp["norm_out"], h)
        nt = text.shape[1]
        return m.linear(tp["mel_out"], h[:, nt:]).numpy()


def test_ar_causality(params):
    """Perturbing future mel frames does not change earlier predictions
    (``tests/test_ar.py``'s property)."""
    tp = ar_params_from_numpy(params[0], "cpu")
    text, mel, _ = _data()
    p1 = _teacher_forced(tp, torch.as_tensor(text), torch.as_tensor(mel))
    mel2 = mel.copy()
    mel2[:, 10:] += 1.0
    p2 = _teacher_forced(tp, torch.as_tensor(text), torch.as_tensor(mel2))
    np.testing.assert_allclose(p1[:, :10], p2[:, :10], atol=1e-5)
    assert np.abs(p1[:, 11:] - p2[:, 11:]).max() > 1e-3


def _stopping(tree):
    """A stop head scaled so rows stop early, at different frames."""
    tree = dict(tree)
    tree["stop_out"] = {**tree["stop_out"], "w": tree["stop_out"]["w"] * np.float32(8.0)}
    return tree


@pytest.mark.parametrize("case", ["never_stops", "early_stops"])
def test_ar_generate_matches_jax(params, case):
    """Generated mel at atol 1e-4 and lengths equal; done rows emit zeros."""
    rng = np.random.default_rng(0)
    text = rng.integers(0, 30, (3, 8)).astype(np.int32)
    text[1, 5:] = -1
    text[2, 3:] = -1
    tree, threshold = (params[1], 2.0) if case == "never_stops" else (_stopping(params[2]), 0.5)
    frames = 16
    j_mel, j_len = JA.ar_generate(jax.tree.map(jnp.asarray, tree), J_CFG, jnp.asarray(text), max_frames=frames,
                                  stop_threshold=threshold)
    mel, lengths = TA.ar_generate(ar_params_from_numpy(tree, "cpu"), CFG, torch.as_tensor(text), frames,
                                  stop_threshold=threshold)
    want = [frames] * 3 if case == "never_stops" else [4, 3, 6]
    assert lengths.tolist() == np.asarray(j_len).tolist() == want
    np.testing.assert_allclose(mel.numpy(), np.asarray(j_mel), atol=1e-4)
    for i, n in enumerate(want):
        assert np.all(mel[i, n:].numpy() == 0)


def test_ar_generate_matches_teacher_forcing(params):
    """The KV-cache decode equals the full causal pass over the same frames
    (the property phase 19 holds on the card)."""
    tp = ar_params_from_numpy(params[1], "cpu")
    text = torch.as_tensor(_data()[0])
    gen, lengths = TA.ar_generate(tp, CFG, text, 6, stop_threshold=2.0)
    assert lengths.tolist() == [6, 6]
    np.testing.assert_allclose(_teacher_forced(tp, text, gen[:, :5]), gen.numpy(), atol=2e-5)


VOC = dict(input_channels=20, dim=32, intermediate_dim=64, num_layers=2)
ENGINE_GEO = dict(GEO, mel_dim=20, text_num_embeds=40)


def test_ar_engine_matches_jax():
    """``ARTTSEngine.synthesize_batch`` against the JAX engine on the same
    trees and ``Tokenizer.from_texts`` vocabulary: waves at atol 1e-4, each
    trimmed to ``(length - 1) * hop`` samples."""
    texts = ["hello autoregressive branch", "a second row", "three"]
    j_cfg = JA.ARConfig(**ENGINE_GEO)
    ar_tree = _np(JA.init_ar(jax.random.PRNGKey(2), j_cfg))
    ar_tree["stop_out"] = {**ar_tree["stop_out"], "w": ar_tree["stop_out"]["w"] * np.float32(8.0)}
    voc_tree = _np(init_vocos(jax.random.PRNGKey(1), JVocosConfig(**VOC)))
    kw = dict(text_pad=32, max_frames=24, compute_dtype="float32")
    j_engine = JARTTSEngine(jax.tree.map(jnp.asarray, ar_tree), j_cfg, jax.tree.map(jnp.asarray, voc_tree),
                            JTokenizer.from_texts(texts), JAREngineConfig(vocoder=JVocosConfig(**VOC), **kw))
    t_engine = ARTTSEngine(ar_tree, TA.ARConfig(**ENGINE_GEO), voc_tree, Tokenizer.from_texts(texts),
                           AREngineConfig(vocoder=VocosConfig(**VOC), **kw), device="cpu")
    want, got = j_engine.synthesize_batch(texts), t_engine.synthesize_batch(texts)
    assert [len(w) for w in got] == [len(w) for w in want]
    assert len({len(w) for w in got}) > 1 and all(0 < len(w) < 23 * 256 for w in got)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-4)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_ar_engine_needs_a_gpu_unless_asked_for_the_cpu(device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the engine would take it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ARTTSEngine(init_ar_numpy(CFG), CFG, {}, Tokenizer.from_texts(["a"]), device=device)
