"""The serving attention on strided head-split views (the layout the DiT
hands the kernel since the head-split copies went) against the JAX package on
the CPU: the wrapper (its plain version on CPU tensors) against the Pallas
kernel in interpret mode, the serving ``attention`` layer against the JAX
layer, and the wrapper's stride rule. fp32; atol 2e-5 / 1e-4 as in
``test_torch_ops.py`` / ``test_torch_modules.py`` (summation order only)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import modules as jm
from f5tts_tpu.ops import rope as j_rope
from f5tts_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models.convert import params_from_numpy
from f5tts_tpu_torch.ops.kernels import flash_attention as t_flash

torch.backends.cuda.matmul.allow_tf32 = False


def _views(rng, b, n, h, d):
    """q, k, v as (b, h, n, d) views of (b, n, h*d) projections, and the same
    values as contiguous numpy arrays."""
    flat = [torch.as_tensor(rng.standard_normal((b, n, h * d)).astype(np.float32)) for _ in range(3)]
    views = [t.view(b, n, h, d).transpose(1, 2) for t in flat]
    return views, [v.contiguous().numpy() for v in views]


@pytest.mark.parametrize("n,d,rope,dead_row", [
    (256, 64, "head0", False), (256, 64, "all", False), (128, 128, "head0", False), (256, 64, None, True),
])
def test_wrapper_on_strided_views_matches_pallas(n, d, rope, dead_row):
    rng = np.random.default_rng(20)
    b, h = 2, 2
    (q, k, v), arrays = _views(rng, b, n, h, d)
    assert not q.is_contiguous() and t_flash.strides(q) == t_flash.strides(k) == (n * h * d, d, h * d, 1)
    mask = np.arange(n)[None] < np.array([[n], [n - 77]])
    if dead_row:
        mask[1] = False  # every key of batch row 1 masked: each key weighs the same
    freqs = j_rope.rotary_freqs(n, d) if rope else None
    ref = np.asarray(j_flash(*(jnp.asarray(a) for a in arrays), jnp.asarray(mask), interpret=True,
                             rope_freqs=jnp.asarray(freqs) if rope else None, rope_all_heads=rope == "all"))
    out = t_flash.flash_attention(q, k, v, torch.as_tensor(mask), rope_freqs=torch.as_tensor(freqs) if rope else None,
                                  rope_all_heads=rope == "all")
    rows = mask | ~mask.any(-1, keepdims=True)  # valid query rows; all rows of a dead batch row
    for bi in range(b):
        np.testing.assert_allclose(out.numpy()[bi][:, rows[bi]], ref[bi][:, rows[bi]], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("rope_all_heads", [False, True])
def test_serving_attention_layer_matches_jax(rope_all_heads):
    dim, heads, n = 128, 2, 96  # 2 heads of 64, as the kernel's main path splits them
    rng = np.random.default_rng(21)
    p = jax.tree.map(np.asarray, jm.init_dit_block(jax.random.PRNGKey(22), dim, heads, dim // heads, 2))
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    mask = np.arange(n)[None] < np.array([[n], [40]])
    freqs = j_rope.rotary_freqs(n, dim // heads)
    ref = jm.attention(p["attn"], jnp.asarray(x), heads, jnp.asarray(freqs), jnp.asarray(mask),
                       rope_all_heads=rope_all_heads)
    out = tm.attention(params_from_numpy(p, "cpu")["attn"], torch.as_tensor(x), heads, torch.as_tensor(freqs),
                       torch.as_tensor(mask), impl="flash", rope_all_heads=rope_all_heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _bad_layouts():
    base = torch.zeros((2, 64, 2 * 64), dtype=torch.bfloat16).view(2, 64, 2, 64).transpose(1, 2)
    other = torch.zeros((2, 2, 64, 64), dtype=torch.bfloat16)
    odd_rows = torch.zeros((2, 2, 64, 68), dtype=torch.bfloat16)  # rows of 136 bytes: not 16-byte steps
    d_strided = torch.zeros((2, 2, 64, 128), dtype=torch.bfloat16)[..., ::2]  # last axis not contiguous
    return {"q, k, v of different strides": (base, other, other),
            "a row step that is no multiple of 16 bytes": (odd_rows[..., :64],) * 3,
            "a strided last axis": (d_strided,) * 3}


@pytest.mark.parametrize("what", sorted(_bad_layouts()))
def test_wrapper_check_refuses_strides_it_does_not_take(what):
    q, k, v = _bad_layouts()[what]
    with pytest.raises(ValueError, match="strides"):
        t_flash._check(q, k, v, None, None)


def test_wrapper_check_takes_head_split_views_and_contiguous_tensors():
    views = torch.zeros((2, 64, 4 * 64), dtype=torch.bfloat16).view(2, 64, 4, 64).transpose(1, 2)
    t_flash._check(views, views, views, None, None)
    dense = torch.zeros((1, 4, 64, 64), dtype=torch.bfloat16)
    t_flash._check(dense, dense, dense, None, None)
    assert t_flash.strides(dense[:, :1]) == (4 * 64 * 64, 4 * 64 * 64, 64, 1)  # size-1 axes: the whole extent


@pytest.mark.parametrize("n,d", [(96, 64), (200, 32)])
def test_dit_rope_table_comes_with_the_kernels_cos_sin(n, d):
    """The DiT makes the RoPE angle table and the serving kernel's fp32
    cos/sin together, once per bucket; both match the JAX package's table."""
    from f5tts_tpu_torch.models.dit import _rope_table

    freqs, (cos, sin) = _rope_table(n, d, "cpu")
    again = _rope_table(n, d, "cpu")
    assert again[0] is freqs and again[1][0] is cos and again[1][1] is sin
    ref = j_rope.rotary_freqs(n, d)
    np.testing.assert_array_equal(freqs.numpy(), ref)
    for got, want in ((cos, np.cos(ref)), (sin, np.sin(ref))):
        assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == (n, d)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
