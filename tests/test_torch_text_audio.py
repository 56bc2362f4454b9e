"""The port's host-side copies (``f5tts_tpu_torch/text``, ``audio``) against the
JAX package's modules, exact on Indic/Latin inputs; plus the port's rules:
no module of ``f5tts_tpu_torch`` (nor ``chip_smoke.py``) imports ``jax`` or
``f5tts_tpu``, and ``resolve_device`` never falls back to the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

from f5tts_tpu.audio import preprocess as j_pre
from f5tts_tpu.audio import stitch as j_stitch
from f5tts_tpu.text import chunker as j_chunk
from f5tts_tpu.text.tokenizer import Tokenizer as JTokenizer
from f5tts_tpu_torch.audio import io as t_io
from f5tts_tpu_torch.audio import preprocess as t_pre
from f5tts_tpu_torch.audio import stitch as t_stitch
from f5tts_tpu_torch.text import chunker as t_chunk
from f5tts_tpu_torch.text.tokenizer import Tokenizer as TTokenizer
from f5tts_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = [
    "नमस्ते, आप कैसे हैं? मैं ठीक हूँ। यह एक परीक्षण है, जो कई वाक्यों में फैला है।",
    "ನಮಸ್ಕಾರ! ಇದು ಕನ್ನಡ ಪಠ್ಯ; ಮತ್ತು ಇನ್ನೊಂದು ವಾಕ್ಯ.",
    "Hello world. This is a longer English passage, with commas, and several clauses: one, two, three!",
    "வணக்கம். Mixed script text, हिंदी और English together.",
]


def test_tokenizer_matches_jax():
    vocab = os.path.join(REPO, "examples", "vocab.txt")
    t, j = TTokenizer.from_file(vocab), JTokenizer.from_file(vocab)
    assert t.vocab_size == j.vocab_size
    np.testing.assert_array_equal(t.encode(TEXTS), j.encode(TEXTS))
    np.testing.assert_array_equal(t.encode(TEXTS, pad_to=64), j.encode(TEXTS, pad_to=64))
    tt, jt = TTokenizer.from_texts(TEXTS), JTokenizer.from_texts(TEXTS)
    assert tt.vocab_char_map == jt.vocab_char_map


@pytest.mark.parametrize("max_chars", [20, 60, 135])
def test_chunkers_and_durations_match_jax(max_chars):
    for text in TEXTS + [" ".join(TEXTS)]:
        assert t_chunk.chunk_text(text, max_chars) == j_chunk.chunk_text(text, max_chars)
        assert t_chunk.chunk_text_packed(text, max_chars) == j_chunk.chunk_text_packed(text, max_chars)
        assert t_chunk.duration_frames(281, "संदर्भ पाठ।", text, 1.1) == j_chunk.duration_frames(281, "संदर्भ पाठ।", text, 1.1)
    assert t_chunk.max_chars_for_ref(TEXTS[0], 3.7) == j_chunk.max_chars_for_ref(TEXTS[0], 3.7)
    assert t_chunk.duration_frames(100, "a", "b", fix_duration_secs=4.2) == j_chunk.duration_frames(100, "a", "b", fix_duration_secs=4.2)


def test_preprocess_matches_jax():
    rng = np.random.default_rng(0)
    sr = 16000
    t = np.arange(sr * 3) / sr
    audio = (0.05 * np.sin(2 * np.pi * 200 * t) * (t > 0.4) * (t < 2.2) + 1e-4 * rng.standard_normal(t.shape)).astype(np.float32)
    np.testing.assert_array_equal(t_pre.clip_ref_audio(audio, sr), j_pre.clip_ref_audio(audio, sr))
    np.testing.assert_array_equal(t_pre.remove_silence_edges(audio, sr), j_pre.remove_silence_edges(audio, sr))
    np.testing.assert_array_equal(t_pre.resample(audio, sr, 24000), j_pre.resample(audio, sr, 24000))
    a, r = t_pre.normalize_rms(audio)
    b, s = j_pre.normalize_rms(audio)
    np.testing.assert_array_equal(a, b)
    assert r == s
    for text in ("Hi", "Hi.", "Hi. ", "नमस्ते।"):
        assert t_pre.ensure_sentence_punctuation(text) == j_pre.ensure_sentence_punctuation(text)


def test_crossfade_and_wav_io(tmp_path):
    rng = np.random.default_rng(1)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (5000, 3000, 100, 8000)]
    np.testing.assert_array_equal(t_stitch.crossfade_concat(waves, 0.15), j_stitch.crossfade_concat(waves, 0.15))
    np.testing.assert_array_equal(t_stitch.crossfade_concat(waves, 0.0), j_stitch.crossfade_concat(waves, 0.0))
    path = tmp_path / "x.wav"
    t_io.write_wav(str(path), 0.5 * waves[0] / np.abs(waves[0]).max(), 24000)
    back, sr = t_io.read_wav(str(path))
    assert sr == 24000 and len(back) == 5000
    np.testing.assert_allclose(back, 0.5 * waves[0] / np.abs(waves[0]).max(), atol=1 / 32767)


def test_resolve_device_never_falls_back(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(dev)
    with pytest.raises(ValueError):
        resolve_device("mps")


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "f5tts_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "f5tts_tpu", "flax", "optax", "orbax"), f"{path} imports {mod}"


@pytest.mark.parametrize("argv", [["--demo-tiny"], ["--random-init"], ["--random-init", "-m", "F5TTS_Small"],
                                  ["--random-init", "-v", "examples/vocab.txt"]])
def test_cli_text_vocabulary_matches_the_jax_cli(monkeypatch, argv):
    """The DiT's ``text_num_embeds`` the port's CLI picks equals the JAX CLI's
    (the JAX ``init_dit`` is stubbed: no Base-size weights are built)."""
    import f5tts_tpu.cli.infer as j_cli
    import f5tts_tpu.models.dit as j_dit
    from f5tts_tpu_torch.cli import infer as t_cli

    class Built(Exception):
        pass

    def stub_init(key, cfg):
        raise Built(cfg.text_num_embeds)

    monkeypatch.setattr(j_dit, "init_dit", stub_init)
    monkeypatch.chdir(REPO)
    argv = [*argv, "--attn", "xla", "-t", "hi."]
    with pytest.raises(Built) as built:
        j_cli.build_engine(j_cli.build_argparser().parse_args(argv))
    tok, n_embeds = t_cli.text_vocab(t_cli.build_argparser().parse_args([a for a in argv if a not in ("--attn", "xla")]))
    assert n_embeds == built.value.args[0]
    assert n_embeds == (256 if "--demo-tiny" in argv else tok.vocab_size)
