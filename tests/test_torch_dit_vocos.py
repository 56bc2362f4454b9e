"""Parity of the port's DiT and Vocos (``f5tts_tpu_torch/models``) with the JAX
package on the CPU at a tiny geometry (dim 64, depth 2, 4 heads), the JAX
``init_dit``/``init_vocos`` params carried across through
``*_params_from_numpy``; plus the params tree plumbing. fp32, atol 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import convert as j_convert
from f5tts_tpu.models import dit as jd
from f5tts_tpu.models import vocos as jv
from f5tts_tpu_torch.models import convert as t_convert
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.models import vocos as tv

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4
TINY = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20, text_num_embeds=40, text_dim=32,
            conv_layers=2, max_pos=512)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(b=2, n=96, nt=30, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 20)).astype(np.float32)
    cond = rng.standard_normal((b, n, 20)).astype(np.float32)
    text = rng.integers(0, 40, (b, nt)).astype(np.int32)
    text[1, 20:] = -1
    lens = np.array([n, 61])
    mask = np.arange(n)[None] < lens[:, None]
    time = np.array([0.3, 0.8], np.float32)
    return x, cond, text, mask, time


@pytest.fixture(scope="module")
def dit_pair():
    jcfg = jd.DiTConfig(**TINY)
    params = _np_tree(jd.init_dit(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(9)
    for k in ("grn_gamma", "grn_beta"):  # nonzero so the masked GRN is exercised
        params["text_embed"]["blocks"][k] = rng.standard_normal(params["text_embed"]["blocks"][k].shape).astype(np.float32)
    return jcfg, params, td.DiTConfig(**TINY), t_convert.dit_params_from_numpy(params, "cpu")


def test_text_embed(dit_pair):
    jcfg, jp, tcfg, tp = dit_pair
    _, _, text, mask, _ = _inputs()
    drop = np.array([False, True])
    ref = jd.text_embed(jp, jcfg, jnp.asarray(text), 96, jnp.asarray(drop), jnp.asarray(mask))
    out = td.text_embed(tp, tcfg, torch.as_tensor(text), 96, torch.as_tensor(drop), torch.as_tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("impls", [("xla", "xla", "plain", "plain"), ("flash", "fused", "flash", "fused")])
def test_dit_forward(dit_pair, impls):
    jcfg, jp, tcfg, tp = dit_pair
    j_attn, j_conv, t_attn, t_conv = impls
    jcfg = dataclasses.replace(jcfg, attn_impl=j_attn, conv_pos_impl=j_conv)
    tcfg = dataclasses.replace(tcfg, attn_impl=t_attn, conv_pos_impl=t_conv)
    x, cond, text, mask, time = _inputs(n=128)  # 128: the JAX flash/fused kernels' tiling
    drop_a, drop_t = np.array([False, True]), np.array([False, True])
    fwd = jax.jit(jd.dit_forward, static_argnums=(1,))
    ref = fwd(jp, jcfg, *(jnp.asarray(a) for a in (x, cond, text, time, drop_a, drop_t, mask)))
    out = td.dit_forward(tp, tcfg, *(torch.as_tensor(a) for a in (x, cond, text, time, drop_a, drop_t, mask)))
    assert tuple(out.shape) == (2, 128, 20)
    valid = mask[..., None].repeat(20, -1)  # padded frames are don't-care
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], atol=ATOL, rtol=1e-4)


def test_vocos_decode():
    jcfg = jv.VocosConfig(input_channels=20, dim=48, intermediate_dim=96, num_layers=2)
    tcfg = tv.VocosConfig(input_channels=20, dim=48, intermediate_dim=96, num_layers=2)
    params = _np_tree(jv.init_vocos(jax.random.PRNGKey(1), jcfg))
    mel = np.random.default_rng(2).standard_normal((2, 30, 20)).astype(np.float32)
    ref = jax.jit(jv.vocos_decode, static_argnums=(2,))(params, jnp.asarray(mel), jcfg)
    out = tv.vocos_decode(t_convert.vocos_params_from_numpy(params, "cpu"), torch.as_tensor(mel), tcfg)
    assert tuple(out.shape) == ref.shape == (2, 29 * 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)


def test_numpy_init_has_the_jax_tree():
    """``init_*_numpy`` builds the JAX ``init_*`` tree: same keys, shapes, dtypes."""
    cfg = dict(TINY, long_skip_connection=True)
    jtree = _np_tree(jd.init_dit(jax.random.PRNGKey(0), jd.DiTConfig(**cfg)))
    ttree = t_convert.init_dit_numpy(td.DiTConfig(**cfg), seed=0)
    jv_tree = _np_tree(jv.init_vocos(jax.random.PRNGKey(0), jv.VocosConfig(dim=48, intermediate_dim=96, num_layers=3)))
    tv_tree = t_convert.init_vocos_numpy(tv.VocosConfig(dim=48, intermediate_dim=96, num_layers=3))
    for a, b in ((jtree, ttree), (jv_tree, tv_tree)):
        ja, _ = jax.tree_util.tree_flatten_with_path(a)
        tb, _ = jax.tree_util.tree_flatten_with_path(b)
        assert [p for p, _ in ja] == [p for p, _ in tb]
        for (p, x), (_, y) in zip(ja, tb):
            assert x.shape == y.shape and x.dtype == y.dtype, p


def test_npz_roundtrip_with_the_jax_format(tmp_path):
    params = _np_tree(jd.init_dit(jax.random.PRNGKey(3), jd.DiTConfig(**TINY)))
    j_convert.save_params_npz(str(tmp_path / "j.npz"), params)
    loaded = t_convert.load_params_npz(str(tmp_path / "j.npz"))
    tp = t_convert.dit_params_from_numpy(loaded, "cpu", torch.bfloat16)
    assert tp["blocks"]["attn"]["to_q"]["w"].dtype == torch.bfloat16
    t_convert.save_params_npz(str(tmp_path / "t.npz"), t_convert.dit_params_from_numpy(loaded, "cpu"))
    back = j_convert.load_params_npz(str(tmp_path / "t.npz"))
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    with pytest.raises(KeyError):
        t_convert.dit_params_from_numpy({"blocks": {}}, "cpu")
