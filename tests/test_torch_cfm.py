"""The port's flow-matching loss (``f5tts_tpu_torch/models/cfm.py``), its
infill mask and the DiT's training mode against the JAX package on the CPU at
a tiny geometry. The JAX draws (taken from the same key split as the JAX
``cfm_loss``) are fed to the port, since ``jax.random`` cannot be reproduced in
torch. fp32, JAX matmul precision ``highest``, TF32 off. Tolerances: loss
rtol 1e-5; each gradient leaf within 2e-4 of its own peak magnitude plus 1e-3
relative (a 2-block DiT chains ~20 fp32 matmuls whose summation orders
differ between the frameworks)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp

from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jd
from f5tts_tpu.ops import masks as jmasks
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.ops import masks as tmasks
from f5tts_tpu_torch.train.trainer import TrainConfig, init_train_state
from f5tts_tpu_torch.train.tree import tree_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20, text_num_embeds=40, text_dim=32,
            conv_layers=1, max_pos=512)


def jax_draws(key, b: int, n: int, mel_dim: int, cfg) -> tcfm.CFMDraws:
    """The draws of the JAX ``cfm_loss`` for ``key`` (its 7-way split, fp32)."""
    k_frac, k_span, k_x0, k_t, k_drop1, k_drop2, _ = jax.random.split(key, 7)
    lo, hi = cfg.frac_lengths_mask
    as_t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return tcfm.CFMDraws(
        frac_lengths=as_t(jax.random.uniform(k_frac, (b,), minval=lo, maxval=hi)),
        span_rand=as_t(jax.random.uniform(k_span, (b,))),
        x0=as_t(jax.random.normal(k_x0, (b, n, mel_dim), jnp.float32)),
        t=as_t(jax.random.uniform(k_t, (b,), dtype=jnp.float32)),
        drop_audio=bool(jax.random.uniform(k_drop1, ()) < cfg.audio_drop_prob),
        drop_both=bool(jax.random.uniform(k_drop2, ()) < cfg.cond_drop_prob),
        dropout_seed=0,
    )


def tiny_configs(dropout: float = 0.0):
    jcfg = jcfm.CFMConfig(model=jd.DiTConfig(**TINY, dropout=dropout, attn_impl="xla"))
    tcfg = tcfm.CFMConfig(model=td.DiTConfig(**TINY, dropout=dropout, attn_impl="flash", conv_pos_impl="fused"))
    return jcfg, tcfg


def batch(seed=4, b=2, n=96):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, n, TINY["mel_dim"])).astype(np.float32)
    text = rng.integers(0, TINY["text_num_embeds"], (b, 30)).astype(np.int32)
    text[1, 22:] = -1
    lens = np.array([n, 70][:b], np.int32)
    return mel, text, lens


def jax_params(seed=0):
    jcfg, _ = tiny_configs()
    params = jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(seed), jcfg.model))
    rng = np.random.default_rng(9)
    for k in ("grn_gamma", "grn_beta"):  # nonzero so their gradients and the GRN path are exercised
        params["text_embed"]["blocks"][k] = rng.standard_normal(params["text_embed"]["blocks"][k].shape).astype(np.float32)
    return params


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {} if tree is None else {prefix: np.asarray(tree)}


def test_mask_from_frac_lengths_matches_jax():
    key = jax.random.PRNGKey(11)
    lens = np.array([100, 37, 1, 64, 250], np.int32)
    frac = np.array(jax.random.uniform(jax.random.PRNGKey(12), (5,), minval=0.7, maxval=1.0))
    ref = jmasks.mask_from_frac_lengths(key, jnp.asarray(lens), jnp.asarray(frac), 256)
    rand = torch.as_tensor(np.array(jax.random.uniform(key, (5,))))
    out = tmasks.mask_from_frac_lengths(torch.as_tensor(lens), torch.as_tensor(frac), 256, rand=rand)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    g = torch.Generator().manual_seed(0)  # the generator form draws its own uniform
    drawn = tmasks.mask_from_frac_lengths(torch.as_tensor(lens), torch.as_tensor(frac), 256, generator=g)
    assert drawn.shape == (5, 256) and torch.equal(drawn.sum(-1), (torch.as_tensor(frac) * torch.as_tensor(lens)).int())


@pytest.fixture(scope="module")
def jax_loss_and_grad():
    jcfg, _ = tiny_configs()
    return jax.jit(jax.value_and_grad(
        lambda p, key, mel, text, lens: jcfm.cfm_loss(p, jcfg, key, mel, text, lens), has_aux=True))


@pytest.mark.parametrize("key_seed", [5, 21])
def test_cfm_loss_and_gradients_match_jax(jax_loss_and_grad, key_seed):
    jcfg, tcfg = tiny_configs()
    params = jax_params()
    mel, text, lens = batch()
    key = jax.random.PRNGKey(key_seed)
    (jloss, jaux), jgrads = jax_loss_and_grad(params, key, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens))
    draws = jax_draws(key, 2, 96, TINY["mel_dim"], jcfg)

    state = init_train_state(tcfg, TrainConfig(), "cpu", params_np=params)
    loss, aux = tcfm.cfm_loss(state["params"], tcfg, draws, torch.as_tensor(mel), torch.as_tensor(text),
                              torch.as_tensor(lens))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert int(aux["masked_frames"]) == int(jaux["masked_frames"])
    ref = _flat(jgrads)
    got = dict(tree_leaves(state["params"]))
    assert set(got) == set(ref)
    for name, g_ref in ref.items():
        scale = float(np.abs(g_ref).max())
        np.testing.assert_allclose(got[name].grad.numpy(), g_ref, atol=2e-4 * scale + 1e-9, rtol=1e-3, err_msg=name)


def test_training_mode_touches_every_leaf_jax_touches():
    """With dropout on (the default 0.1), the training-mode model's gradient is
    non-zero on exactly the leaves where the JAX package's is."""
    jcfg = jcfm.CFMConfig(model=jd.DiTConfig(**TINY, attn_impl="xla"))
    tcfg = tcfm.CFMConfig(model=td.DiTConfig(**TINY))
    params = jax_params()
    mel, text, lens = batch()
    key = jax.random.PRNGKey(7)
    _, jgrads = jax.value_and_grad(lambda p: jcfm.cfm_loss(p, jcfg, key, jnp.asarray(mel), jnp.asarray(text),
                                                           jnp.asarray(lens))[0])(params)
    draws = dataclasses.replace(jax_draws(key, 2, 96, TINY["mel_dim"], jcfg), dropout_seed=123)
    state = init_train_state(tcfg, TrainConfig(), "cpu", params_np=params)
    loss, _ = tcfm.cfm_loss(state["params"], tcfg, draws, torch.as_tensor(mel), torch.as_tensor(text),
                            torch.as_tensor(lens))
    loss.backward()
    touched_ref = {k for k, g in _flat(jgrads).items() if np.abs(g).max() > 0}
    touched = {k for k, t in tree_leaves(state["params"]) if t.grad is not None and float(t.grad.abs().max()) > 0}
    assert touched == touched_ref and len(touched) == len(tree_leaves(state["params"]))


def test_dropout_keep_rate_scaling_and_seeding():
    x = torch.ones((64, 1024))
    y = tm.dropout(x, seed=3, rate=0.1)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.01
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 1 / 0.9))
    assert torch.equal(tm.dropout(x, seed=3, rate=0.1), y)
    assert not torch.equal(tm.dropout(x, seed=4, rate=0.1), y)
    xb = x.to(torch.bfloat16)
    assert tm.dropout(xb, seed=3, rate=0.1).dtype == torch.bfloat16


def test_dropout_masks_reproduced_under_checkpoint_recompute():
    """A checkpointed block re-runs its forward in the backward; its dropout
    masks come from its seeds, so the gradients equal the un-checkpointed ones."""
    _, tcfg = tiny_configs(dropout=0.3)
    cfg = tcfg.model
    params = init_train_state(tcfg, TrainConfig(), "cpu", params_np=jax_params())["params"]
    blk = td.unstack(params["blocks"], cfg.depth)[0]
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((2, 48, cfg.dim)).astype(np.float32))
    t_emb = torch.as_tensor(rng.standard_normal((2, cfg.dim)).astype(np.float32))
    freqs = torch.as_tensor(td.rotary_freqs(48, cfg.dim_head))
    leaves = [p for p in (blk["attn"]["to_q"]["w"], blk["ff"]["in"]["w"], blk["ff"]["out"]["w"])]

    def run(h):
        return tm.dit_block(blk, h, t_emb, cfg.heads, freqs, None, impl="flash", training=True,
                            dropout_seeds=(17, 18), dropout_rate=cfg.dropout)

    x1 = x.clone().requires_grad_(True)
    g_direct = torch.autograd.grad(run(x1).square().sum(), [x1, *leaves])
    x2 = x.clone().requires_grad_(True)
    g_ckpt = torch.autograd.grad(checkpoint(run, x2, use_reentrant=False, preserve_rng_state=False).square().sum(),
                                 [x2, *leaves])
    for a, b in zip(g_direct, g_ckpt):
        assert torch.equal(a, b)
    with torch.no_grad():
        other = tm.dit_block(blk, x, t_emb, cfg.heads, freqs, None, impl="flash", training=True,
                             dropout_seeds=(19, 18), dropout_rate=cfg.dropout)
        assert not torch.equal(other, run(x))  # another attention seed, another mask


def test_cfm_draws_shapes_and_ranges():
    _, tcfg = tiny_configs()
    g = torch.Generator().manual_seed(0)
    d = tcfm.cfm_draws(g, torch.tensor([96, 70]), 96, TINY["mel_dim"], tcfg)
    assert d.x0.shape == (2, 96, TINY["mel_dim"]) and d.t.shape == (2,)
    assert bool(((d.frac_lengths >= 0.7) & (d.frac_lengths < 1.0)).all())
    assert isinstance(d.drop_audio, bool) and isinstance(d.dropout_seed, int)
    d2 = tcfm.cfm_draws(torch.Generator().manual_seed(0), torch.tensor([96, 70]), 96, TINY["mel_dim"], tcfg)
    assert torch.equal(d.x0, d2.x0) and d.dropout_seed == d2.dropout_seed
