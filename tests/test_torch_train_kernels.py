"""The port's training kernels' plain versions (``f5tts_tpu_torch/ops/kernels/
flash_attention_train.py``, ``conv_pos.conv_pos_train``) against the JAX
package on the CPU: ``flash_attention_train(..., interpret=True)`` and its
``jax.vjp`` (the Pallas kernels in interpret mode; at ``n = 200`` the JAX
wrapper falls back to XLA SDPA), and the JAX conv-pos custom VJP's plain
formulation. Inputs from numpy seeds, fp32, JAX matmul precision ``highest``
(``tests/conftest.py``), TF32 off. Tolerances: outputs 2e-5 abs, lse 1e-5,
gradients 5e-4 abs + 1e-3 rel (the existing JAX flash-vs-SDPA test's bound:
summation orders differ)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import modules as jm
from f5tts_tpu.ops.pallas import flash_attention as jfa
from f5tts_tpu_torch.ops.kernels import conv_pos as t_conv
from f5tts_tpu_torch.ops.kernels import flash_attention_train as t_train

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _inputs(n, masked, seed=30, b=2, h=3, d=64):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, n), bool)
    if masked:
        mask[0, n - 56:] = False
    return q, k, v, do, (mask if masked else None)


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _close(out, ref, atol, rtol=1e-5):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("n,masked", [(256, False), (256, True), (200, True)])
def test_plain_forward_and_backward_match_jax(n, masked):
    q, k, v, do, mask = _inputs(n, masked)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return jfa.flash_attention_train(q_, k_, v_, jmask, interpret=True)

    o_ref, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_ref, dk_ref, dv_ref = vjp(jnp.asarray(do))

    o, lse = t_train.flash_attention_train_fwd_plain(_t(q), _t(k), _t(v), _t(mask))
    _close(o, o_ref, 2e-5)
    if jfa._train_supported(n, 64):  # the Pallas path: its lse is comparable too
        bias = (jnp.zeros((2, 1, n), jnp.float32) if mask is None
                else jnp.where(jmask, 0.0, jfa.NEG_INF).astype(jnp.float32)[:, None, :])
        _, lse_ref = jfa._flash_train_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias, True)
        _close(lse, np.asarray(lse_ref)[..., 0], 1e-5)
    grads = t_train.flash_attention_train_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do), _t(mask))
    for got, ref in zip(grads, (dq_ref, dk_ref, dv_ref)):
        _close(got, ref, 5e-4, 1e-3)


def test_autograd_function_takes_the_plain_versions_on_cpu():
    q, k, v, do, mask = _inputs(128, True, seed=31, d=32)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    before = (t_train.flash_attention_train_fwd.launches, t_train.flash_attention_train_bwd.launches)
    o = t_train.flash_attention_train(*leaves, _t(mask))
    grads = torch.autograd.grad(o, leaves, _t(do))
    assert (t_train.flash_attention_train_fwd.launches, t_train.flash_attention_train_bwd.launches) == before
    o_ref, lse = t_train.flash_attention_train_fwd_plain(_t(q), _t(k), _t(v), _t(mask))
    refs = t_train.flash_attention_train_bwd_plain(_t(q), _t(k), _t(v), o_ref, lse, _t(do), _t(mask))
    assert torch.equal(o.detach(), o_ref)
    for got, ref in zip(grads, refs):
        assert torch.equal(got, ref)


def test_conv_pos_train_matches_the_jax_custom_vjp_formulation():
    rng = np.random.default_rng(32)
    dim, n = 128, 80
    p = jax.tree.map(np.asarray, jm.init_conv_pos_embedding(jax.random.PRNGKey(3), dim))
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    g = rng.standard_normal((2, n, dim)).astype(np.float32)
    args = (x, p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"])
    y_ref, vjp = jax.vjp(lambda *a: jm._conv_pos_ref(*a, 16, 31), *(jnp.asarray(a) for a in args))
    grads_ref = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_(True) for a in args]
    y = t_conv.conv_pos_train(*leaves)
    _close(y, y_ref, 1e-4, 1e-4)
    for got, ref in zip(torch.autograd.grad(y, leaves, _t(g)), grads_ref):
        _close(got, ref, 5e-4, 1e-3)
