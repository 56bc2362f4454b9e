"""The port's module leftovers against the JAX package on the CPU: the fused
q/k/v projection (``models/modules.py:fuse_attention_qkv`` and the
attention's ``qkv`` branch), the native audio library
(``audio/native.py`` over ``csrc/audioops.cpp``, bit-equal to the JAX
package's), ``ops/stft.py:stft_complex``/``istft``,
``ops/rope.py:get_pos_embed_indices``, ``models/dit.py:param_count`` and
``audio/preprocess.py:save_spectrogram``.

Tolerances: the fused DiT forward against JAX's fused forward atol 1e-4
(fp32, the suite's DiT tolerance), against the port's unfused forward and
its gradients 1e-5 (one product of width 3 * inner in place of three);
the STFT pair 1e-4 (fp32 DFTs of unit-scale signals); everything else
equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.audio import native as j_native
from f5tts_tpu.audio import preprocess as j_pre
from f5tts_tpu.models import dit as jd
from f5tts_tpu.models import modules as jm
from f5tts_tpu.ops import rope as j_rope
from f5tts_tpu.ops import stft as j_stft
from f5tts_tpu_torch.audio import io as t_io
from f5tts_tpu_torch.audio import native as t_native
from f5tts_tpu_torch.audio import preprocess as t_pre
from f5tts_tpu_torch.audio import stitch as t_stitch
from f5tts_tpu_torch.models import convert as t_convert
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.ops import rope as t_rope
from f5tts_tpu_torch.ops import stft as t_stft
from f5tts_tpu_torch.train.tree import tree_leaves

torch.backends.cuda.matmul.allow_tf32 = False

TINY = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20, text_num_embeds=40, text_dim=32,
            conv_layers=2, max_pos=512)
FUSED_TOL, SAME_TOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fused_tree(params, fuse):
    return {**params, "blocks": {**params["blocks"], "attn": fuse(params["blocks"]["attn"])}}


@pytest.fixture(scope="module")
def dit():
    jcfg = jd.DiTConfig(**TINY)
    params = _np(jd.init_dit(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    for name in ("to_q", "to_k", "to_v"):  # distinct biases, so a misplaced third shows
        b = params["blocks"]["attn"][name]["b"]
        params["blocks"]["attn"][name]["b"] = rng.standard_normal(b.shape).astype(np.float32)
    return jcfg, params


def _inputs(n=128, seed=0):
    rng = np.random.default_rng(seed)
    x, cond = (rng.standard_normal((2, n, 20)).astype(np.float32) for _ in range(2))
    text = rng.integers(0, 40, (2, 30)).astype(np.int32)
    text[1, 20:] = -1
    mask = np.arange(n)[None] < np.array([n, 83])[:, None]
    return x, cond, text, np.array([0.3, 0.8], np.float32), np.array([False, True]), np.array([False, True]), mask


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("stacked", [True, False])
def test_fuse_attention_qkv_leaves_match_jax(dit, stacked, bias):
    """numpy and tensor trees give JAX's leaves, stacked on depth or not."""
    attn = dit[1]["blocks"]["attn"]
    if not stacked:
        attn = {k: {kk: v[0] for kk, v in p.items()} for k, p in attn.items()}
    if not bias:
        attn = {k: {"w": p["w"]} if k != "to_out" else p for k, p in attn.items()}
    ref = _np(jm.fuse_attention_qkv(attn))
    as_np = tm.fuse_attention_qkv(attn)
    as_torch = tm.fuse_attention_qkv({k: {kk: torch.tensor(v) for kk, v in p.items()} for k, p in attn.items()})
    assert set(as_np) == set(ref) == {"qkv", "to_out"} and set(as_np["qkv"]) == set(ref["qkv"])
    for got in (as_np, as_torch):
        for k in ref["qkv"]:
            np.testing.assert_array_equal(np.asarray(got["qkv"][k]), ref["qkv"][k])
        assert got["to_out"] is not None
    assert isinstance(as_np["qkv"]["w"], np.ndarray) and isinstance(as_torch["qkv"]["w"], torch.Tensor)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_fused_dit_forward_matches_jax_and_the_unfused_port(dit, impl):
    jcfg, jp = dit
    j_fused = _np(_fused_tree(jp, jm.fuse_attention_qkv))
    tcfg = dataclasses.replace(td.DiTConfig(**TINY), attn_impl=impl)
    args = _inputs()
    ref = jax.jit(jd.dit_forward, static_argnums=(1,))(j_fused, jcfg, *(jnp.asarray(a) for a in args))
    t_args = [torch.as_tensor(a) for a in args]
    fused = td.dit_forward(t_convert.dit_params_from_numpy(_fused_tree(jp, tm.fuse_attention_qkv), "cpu"), tcfg, *t_args)
    unfused = td.dit_forward(t_convert.dit_params_from_numpy(jp, "cpu"), tcfg, *t_args)
    valid = args[-1][..., None].repeat(20, -1)
    np.testing.assert_allclose(fused.numpy()[valid], np.asarray(ref)[valid], atol=FUSED_TOL, rtol=FUSED_TOL)
    np.testing.assert_allclose(fused.numpy()[valid], unfused.numpy()[valid], atol=SAME_TOL, rtol=SAME_TOL)


def test_fused_qkv_views_reach_attention_without_a_copy(monkeypatch):
    """The thirds of the fused product are strided views with a row stride of
    3 * inner; the flash path hands them to the kernel wrapper as they are."""
    seen = []
    real = tm.flash_attention

    def spy(q, k, v, *a, **kw):
        seen.append((q.stride(), k.stride(), v.stride(), k.data_ptr() - q.data_ptr()))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(tm, "flash_attention", spy)
    rng = np.random.default_rng(1)
    heads, d, dim = 4, 16, 64
    p = {n: {"w": torch.as_tensor(rng.standard_normal((dim, heads * d)), dtype=torch.float32)}
         for n in ("to_q", "to_k", "to_v")}
    p["to_out"] = {"w": torch.as_tensor(rng.standard_normal((heads * d, dim)), dtype=torch.float32)}
    x = torch.as_tensor(rng.standard_normal((2, 32, dim)), dtype=torch.float32)
    out = tm.attention(tm.fuse_attention_qkv(p), x, heads, impl="flash")
    (qs, ks, vs, offset), = seen
    inner = heads * d
    assert qs == ks == vs == (32 * 3 * inner, d, 3 * inner, 1) and offset == inner * 4  # bytes of fp32
    torch.testing.assert_close(out, tm.attention(p, x, heads, impl="flash"), atol=SAME_TOL, rtol=SAME_TOL)


def test_fused_training_forward_and_gradients_match_the_unfused_tree(dit):
    """``training=True`` (the differentiable kernels' plain versions here):
    the loss and every gradient of the fused tree equal the unfused tree's,
    the qkv gradient the concatenation of the three."""
    _, jp = dit
    cfg = td.DiTConfig(**TINY)
    t_args = [torch.as_tensor(a) for a in _inputs(n=96, seed=2)]
    g = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 96, 20)), dtype=torch.float32)
    grads = []
    for tree in (jp, _fused_tree(jp, tm.fuse_attention_qkv)):
        params = t_convert.dit_params_from_numpy(tree, "cpu")
        leaves = dict(tree_leaves(params))
        for t in leaves.values():
            t.requires_grad_(True)
        loss = (td.dit_forward(params, cfg, *t_args, training=True) * g).sum()
        loss.backward()
        grads.append((loss.item(), {k: t.grad for k, t in leaves.items()}))
    (loss_u, gu), (loss_f, gf) = grads
    np.testing.assert_allclose(loss_f, loss_u, rtol=SAME_TOL)
    qkv = {"w": "blocks/attn/qkv/w", "b": "blocks/attn/qkv/b"}
    for leaf, path in qkv.items():
        want = torch.cat([gu[f"blocks/attn/{n}/{leaf}"] for n in ("to_q", "to_k", "to_v")], -1)
        torch.testing.assert_close(gf[path], want, atol=SAME_TOL, rtol=SAME_TOL)
    rest = [k for k in gu if "/to_q/" not in k and "/to_k/" not in k and "/to_v/" not in k]
    assert len(rest) == len(gf) - 2
    for k in rest:
        torch.testing.assert_close(gf[k], gu[k], atol=SAME_TOL, rtol=SAME_TOL, msg=k)


def test_fused_tree_refuses_int8_and_tensor_parallel_specs(dit):
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.parallel.sharding import dit_param_specs
    from f5tts_tpu_torch.text.tokenizer import Tokenizer

    fused = _fused_tree(dit[1], tm.fuse_attention_qkv)
    with pytest.raises(ValueError, match="fused qkv"):
        td.quantize_dit_params(t_convert.dit_params_from_numpy(fused, "cpu"))
    with pytest.raises(ValueError, match="fused qkv"):
        TTSEngine(fused, td.DiTConfig(**TINY), t_convert.init_vocos_numpy(), Tokenizer.from_texts(["abc"]),
                  EngineConfig(quantization="int8"), device="cpu")
    with pytest.raises(ValueError, match="fused qkv"):
        dit_param_specs(fused)
    dit_param_specs(dit[1])  # the three projections keep their specs


# ---------------------------------------------------------------------------
# the native audio library
# ---------------------------------------------------------------------------


def _pcm_inputs():
    rng = np.random.default_rng(4)
    k = np.arange(-32767, 32767, 97)
    ties = ((k + 0.5) / 32767).astype(np.float32)
    ties = ties[(ties * np.float32(32767.0)) % 1 == 0.5]  # products exactly half-way in fp32
    assert len(ties) > 100
    return np.concatenate([rng.uniform(-1.5, 1.5, 5000).astype(np.float32), ties,
                           np.float32([1.0, -1.0, 1.0000001, -1.0000001, 7.0, -7.0, 0.0, -0.0])])


def test_encode_pcm16_is_bit_equal_to_jax_native_and_numpy():
    assert j_native.available()
    x = _pcm_inputs()
    got = t_native.encode_pcm16(x)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, j_native.encode_pcm16(x))
    np.testing.assert_array_equal(got, t_native.encode_pcm16_plain(x))  # rint and lrintf: ties to even
    np.testing.assert_array_equal(t_io.encode_pcm16(x.reshape(2, -1)), got.reshape(2, -1))


@pytest.mark.parametrize("n_fade", [0, 1, 2, 37, 5000])
def test_crossfade_pair_is_bit_equal_to_jax_native(n_fade):
    rng = np.random.default_rng(n_fade)
    a, b = rng.standard_normal(900).astype(np.float32), rng.standard_normal(400).astype(np.float32)
    before = t_native.crossfade_pair.launches
    got = t_native.crossfade_pair(a, b, n_fade)
    assert t_native.crossfade_pair.launches == before + 1
    np.testing.assert_array_equal(got, j_native.crossfade_pair(a, b, n_fade))
    f = min(n_fade, 400)
    assert len(got) == 1300 - f
    np.testing.assert_allclose(got, t_native.crossfade_pair_plain(a, b, n_fade), atol=3e-7, rtol=0)


def test_native_library_builds_into_the_package_and_raises_on_a_compile_error(monkeypatch, tmp_path):
    assert t_native.load() is t_native.load()
    assert t_native.LIBRARY.startswith(t_native.BUILD_DIR) and t_native.LIBRARY.endswith(".so")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_native, "SOURCE", str(bad))
    monkeypatch.setattr(t_native, "LIBRARY", str(tmp_path / "libbad.so"))
    monkeypatch.setattr(t_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_native, "_lib", None)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        t_native.load()


def test_stitch_goes_through_the_native_crossfade():
    rng = np.random.default_rng(5)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (5000, 3000, 100, 8000)]
    before = t_native.crossfade_pair.launches
    out = t_stitch.crossfade_concat(waves, 0.05)
    assert t_native.crossfade_pair.launches == before + 3 and t_stitch.crossfade_pair is t_native.crossfade_pair
    assert len(out) == 16100 - 2 * 1200 - 100


# ---------------------------------------------------------------------------
# the small API leftovers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("center", [True, False])
def test_stft_complex_and_istft_match_jax(center):
    rng = np.random.default_rng(6)
    wav = rng.standard_normal((2, 3000)).astype(np.float32)
    kw = dict(n_fft=256, hop_length=64, win_length=256, center=center)
    spec = t_stft.stft_complex(torch.as_tensor(wav), **kw)
    ref = np.asarray(j_stft.stft_complex(jnp.asarray(wav), **kw))
    assert spec.dtype == torch.complex64 and spec.shape == ref.shape
    np.testing.assert_allclose(spec.numpy(), ref, atol=1e-4, rtol=1e-4)
    # without centering the outermost hop keeps samples whose squared-window
    # envelope is ~1e-6: the division by it magnifies fp32 rounding there
    inner = slice(None) if center else slice(64, -64)
    for matmul in (True, False):
        got = t_stft.istft(spec, **kw, use_matmul_idft=matmul).numpy()
        want = np.asarray(j_stft.istft(jnp.asarray(ref), **kw, use_matmul_idft=matmul))
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, inner], want[:, inner], atol=1e-4, rtol=1e-4)
    if center:  # the pair inverts each other on the interior
        np.testing.assert_allclose(t_stft.istft(spec, **kw).numpy(), wav[:, : (spec.shape[1] - 1) * 64], atol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 0.37, 2.5])
def test_get_pos_embed_indices_matches_jax(scale):
    start = np.array([0, 5, 290, 511], np.int32)
    got = t_rope.get_pos_embed_indices(torch.as_tensor(start), 64, 300, scale)
    want = np.asarray(j_rope.get_pos_embed_indices(jnp.asarray(start), 64, 300, scale))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_param_count_matches_jax_on_numpy_and_tensor_trees(dit):
    jcfg, jp = dit
    want = jd.param_count(jd.init_dit(jax.random.PRNGKey(0), jcfg))
    assert td.param_count(jp) == want == td.param_count(t_convert.dit_params_from_numpy(jp, "cpu"))
    assert td.param_count(t_convert.init_dit_numpy(td.DiTConfig(**TINY), seed=None)) == want  # nothing drawn


def test_save_spectrogram_writes_the_jax_png(tmp_path):
    mel = np.random.default_rng(7).standard_normal((120, 20)).astype(np.float32)
    t_pre.save_spectrogram(mel, str(tmp_path / "t.png"))
    j_pre.save_spectrogram(mel, str(tmp_path / "j.png"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    assert (tmp_path / "t.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
