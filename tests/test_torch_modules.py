"""Parity of the PyTorch port's layers (``f5tts_tpu_torch/models/modules.py``)
with ``f5tts_tpu/models/modules.py`` on the CPU at a tiny geometry, JAX params
carried across as numpy. fp32; tolerance atol 1e-4 (layers chain several
matmuls and fp32 reductions whose order differs between the frameworks)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import modules as jm
from f5tts_tpu.ops.rope import rotary_freqs
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models.convert import params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


def _mask(b, n, lens):
    return np.arange(n)[None, :] < np.asarray(lens)[:, None]


def test_linear_conv1d_layer_norm_mish():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, 24)).astype(np.float32)
    lin = _np_tree(jm.init_linear(jax.random.PRNGKey(0), 24, 40))
    _close(tm.linear(params_from_numpy(lin, "cpu"), _t(x)), jm.linear(lin, jnp.asarray(x)))
    for groups, width, out_dim in ((1, 7, 32), (24, 7, 24), (4, 31, 24)):  # dense, depthwise, grouped
        p = _np_tree(jm.init_conv1d(jax.random.PRNGKey(groups), 24, out_dim, width, groups))
        ref = jm.conv1d(p, jnp.asarray(x), groups=groups, padding=width // 2)
        _close(tm.conv1d(params_from_numpy(p, "cpu"), _t(x), groups=groups, padding=width // 2), ref)
    w, b = rng.standard_normal(24).astype(np.float32), rng.standard_normal(24).astype(np.float32)
    _close(tm.layer_norm(_t(x), 1e-6, _t(w), _t(b)), jm.layer_norm(jnp.asarray(x), 1e-6, jnp.asarray(w), jnp.asarray(b)))
    _close(tm.mish(_t(3 * x)), jm.mish(jnp.asarray(3 * x)), atol=1e-5)


def test_timestep_embedding():
    p = _np_tree(jm.init_timestep_embedding(jax.random.PRNGKey(1), 48))
    t = np.array([0.0, 0.37, 1.0], np.float32)
    _close(tm.timestep_embedding(params_from_numpy(p, "cpu"), _t(t)), jm.timestep_embedding(p, jnp.asarray(t)))


@pytest.mark.parametrize("masked", [False, True])
def test_conv_pos_embedding(masked):
    dim, n = 128, 96
    p = _np_tree(jm.init_conv_pos_embedding(jax.random.PRNGKey(2), dim))
    x = np.random.default_rng(3).standard_normal((2, n, dim)).astype(np.float32)
    mask = _mask(2, n, [n, 50]) if masked else None
    ref = jm.conv_pos_embedding(p, jnp.asarray(x), jnp.asarray(mask) if masked else None, impl="xla")
    tp = params_from_numpy(p, "cpu")
    for impl in ("fused", "plain"):  # the kernel wrapper (plain on CPU) and the plain path
        _close(tm.conv_pos_embedding(tp, _t(x), _t(mask) if masked else None, impl=impl), ref)


def test_grn_and_convnext_v2_block_with_mask():
    dim, n = 32, 40
    p = _np_tree(jm.init_convnext_v2_block(jax.random.PRNGKey(4), dim, 2 * dim))
    rng = np.random.default_rng(5)
    # nonzero GRN params so the masked norm matters
    p["grn_gamma"] = rng.standard_normal(2 * dim).astype(np.float32)
    p["grn_beta"] = rng.standard_normal(2 * dim).astype(np.float32)
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    mask = _mask(2, n, [n, 23])
    h = rng.standard_normal((2, n, 2 * dim)).astype(np.float32)
    _close(tm.grn(_t(p["grn_gamma"]), _t(p["grn_beta"]), _t(h), _t(mask)),
           jm.grn(jnp.asarray(p["grn_gamma"]), jnp.asarray(p["grn_beta"]), jnp.asarray(h), jnp.asarray(mask)))
    _close(tm.convnext_v2_block(params_from_numpy(p, "cpu"), _t(x), mask=_t(mask)),
           jm.convnext_v2_block(p, jnp.asarray(x), mask=jnp.asarray(mask)))


def test_adaln_and_feed_forward():
    dim = 32
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, dim)).astype(np.float32)
    emb = rng.standard_normal((2, dim)).astype(np.float32)
    p = _np_tree(jm.init_adaln_zero(jax.random.PRNGKey(7), dim))
    for o, r in zip(tm.adaln_zero(params_from_numpy(p, "cpu"), _t(x), _t(emb)), jm.adaln_zero(p, jnp.asarray(x), jnp.asarray(emb))):
        _close(o, r)
    pf = _np_tree(jm.init_adaln_zero_final(jax.random.PRNGKey(8), dim))
    _close(tm.adaln_zero_final(params_from_numpy(pf, "cpu"), _t(x), _t(emb)), jm.adaln_zero_final(pf, jnp.asarray(x), jnp.asarray(emb)))
    pff = _np_tree(jm.init_feed_forward(jax.random.PRNGKey(9), dim, 2))
    _close(tm.feed_forward(params_from_numpy(pff, "cpu"), _t(x)), jm.feed_forward(pff, jnp.asarray(x)))


@pytest.mark.parametrize("rope_all_heads", [False, True])
def test_attention_and_dit_block(rope_all_heads):
    dim, heads, n = 64, 4, 48
    rng = np.random.default_rng(10)
    p = _np_tree(jm.init_dit_block(jax.random.PRNGKey(11), dim, heads, dim // heads, 2))
    tp = params_from_numpy(p, "cpu")
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    t_emb = rng.standard_normal((2, dim)).astype(np.float32)
    mask = _mask(2, n, [n, 31])
    freqs = rotary_freqs(n, dim // heads)
    ref = jm.attention(p["attn"], jnp.asarray(x), heads, jnp.asarray(freqs), jnp.asarray(mask),
                       rope_all_heads=rope_all_heads)
    for impl in ("flash", "plain"):
        out = tm.attention(tp["attn"], _t(x), heads, _t(freqs), _t(mask), impl=impl, rope_all_heads=rope_all_heads)
        _close(out, ref)
    ref = jm.dit_block(p, jnp.asarray(x), jnp.asarray(t_emb), heads, jnp.asarray(freqs), jnp.asarray(mask),
                       rope_all_heads=rope_all_heads)
    out = tm.dit_block(tp, _t(x), _t(t_emb), heads, _t(freqs), _t(mask), rope_all_heads=rope_all_heads)
    _close(out, ref)
