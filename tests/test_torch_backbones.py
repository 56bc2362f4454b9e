"""Parity of the port's E2-TTS (UNetT) and MMDiT backbones
(``f5tts_tpu_torch/models/{unett,mmdit}.py``) with the JAX package on the CPU
at the tiny geometries of ``tests/test_backbones.py``, the JAX ``init_*``
params carried across through ``*_params_from_numpy``: fp32, atol 1e-4 and
rtol 1e-4 over valid rows. Also ``rms_norm``, one ``sample_cfm`` solve with
the UNetT hooks from the same ``y0`` (fp32, atol 1e-4), and the engine's hooks
reaching the step batcher."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import mmdit as jm
from f5tts_tpu.models import modules as jmod
from f5tts_tpu.models import unett as ju
from f5tts_tpu.sampling import euler as je
from f5tts_tpu_torch.models import convert as t_convert
from f5tts_tpu_torch.models import mmdit as tm
from f5tts_tpu_torch.models import modules as tmod
from f5tts_tpu_torch.models import unett as tu
from f5tts_tpu_torch.sampling import euler as te

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = RTOL = 1e-4
UNETT = dict(dim=64, depth=4, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=30, text_dim=32,
             conv_layers=1, max_pos=256)
MMDIT = dict(dim=64, depth=3, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=30)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(b=2, n=36, nt=14, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 20)).astype(np.float32)
    cond = rng.standard_normal((b, n, 20)).astype(np.float32)
    text = rng.integers(0, 30, (b, nt)).astype(np.int32)
    text[1, 9:] = -1
    time = np.asarray([0.2, 0.8], np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 28:] = False
    return x, cond, text, time, mask


@functools.lru_cache(maxsize=None)
def _unett_pair(skip: str):
    jcfg = ju.UNetTConfig(**UNETT, skip_connect_type=skip)
    params = _np_tree(ju.init_unett(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    for half in ("first_half", "second_half"):  # gains other than 1, so the RMSNorm weights matter
        for nm in ("attn_norm", "ff_norm"):
            params[half][nm]["g"] = (1 + 0.3 * rng.standard_normal(params[half][nm]["g"].shape)).astype(np.float32)
    tcfg = tu.UNetTConfig(**UNETT, skip_connect_type=skip)
    return jcfg, params, tcfg, t_convert.unett_params_from_numpy(params, "cpu")


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    x[0, 0] = 0.0  # a zero row meets the eps floor
    g = rng.standard_normal(16).astype(np.float32)
    ref = np.asarray(jmod.rms_norm({"g": jnp.asarray(g)}, jnp.asarray(x)))
    out = tmod.rms_norm({"g": torch.as_tensor(g)}, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("skip", ["concat", "add"])
@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("masked", [True, False])
def test_unett_forward(skip, impl, masked):
    """Concat and add skips; the plain attention and the kernel wrappers'
    CPU path; a masked batch (row 1 ends at 28 of 36) and no mask; the
    audio and text drops."""
    jcfg, jp, tcfg, tp = _unett_pair(skip)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl, conv_pos_impl="plain" if impl == "plain" else "fused")
    x, cond, text, time, mask = _inputs()
    drop_a, drop_t = np.array([False, True]), np.array([True, False])
    m = mask if masked else None
    ref = ju.unett_forward(jp, jcfg, *(jnp.asarray(a) for a in (x, cond, text, time, drop_a, drop_t)),
                           None if m is None else jnp.asarray(m))
    out = tu.unett_forward(tp, tcfg, *(torch.as_tensor(a) for a in (x, cond, text, time, drop_a, drop_t)),
                           None if m is None else torch.as_tensor(m))
    assert tuple(out.shape) == (2, 36, 20)
    valid = (mask if masked else np.ones_like(mask))[..., None].repeat(20, -1)
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], atol=ATOL, rtol=RTOL)


def test_unett_embed():
    jcfg, jp, tcfg, tp = _unett_pair("concat")
    _, _, text, _, mask = _inputs()
    drop = np.array([False, True])
    ref = ju.unett_embed(jp, jcfg, jnp.asarray(text), 36, jnp.asarray(drop), jnp.asarray(mask))
    out = tu.unett_embed(tp, tcfg, torch.as_tensor(text), 36, torch.as_tensor(drop), torch.as_tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_unett_config_refuses_odd_depth_and_unknown_skip():
    with pytest.raises(ValueError):
        tu.UNetTConfig(depth=3)
    with pytest.raises(ValueError):
        tu.UNetTConfig(skip_connect_type="mul")


@pytest.fixture(scope="module")
def mmdit_pair():
    jcfg = jm.MMDiTConfig(**MMDIT)
    params = _np_tree(jm.init_mmdit(jax.random.PRNGKey(1), jcfg))
    return jcfg, params, tm.MMDiTConfig(**MMDIT), t_convert.mmdit_params_from_numpy(params, "cpu")


@pytest.mark.parametrize("conv_impl", ["plain", "fused"])
@pytest.mark.parametrize("drops", [(False, False), (True, True)])
def test_mmdit_forward(mmdit_pair, conv_impl, drops):
    jcfg, jp, tcfg, tp = mmdit_pair
    tcfg = dataclasses.replace(tcfg, conv_pos_impl=conv_impl)
    x, cond, text, time, mask = _inputs(nt=12)
    drop_a, drop_t = np.full((2,), drops[0]), np.full((2,), drops[1])
    ref = jm.mmdit_forward(jp, jcfg, *(jnp.asarray(a) for a in (x, cond, text, time, drop_a, drop_t, mask)))
    out = tm.mmdit_forward(tp, tcfg, *(torch.as_tensor(a) for a in (x, cond, text, time, drop_a, drop_t, mask)))
    valid = mask[..., None].repeat(20, -1)
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], atol=ATOL, rtol=RTOL)


def test_mmdit_text_embed(mmdit_pair):
    jcfg, jp, tcfg, tp = mmdit_pair
    _, _, text, _, _ = _inputs(nt=12)
    drop = np.array([True, False])
    ref = jm.mmdit_text_embed(jp, jcfg, jnp.asarray(text), jnp.asarray(drop))
    out = tm.mmdit_text_embed(tp, tcfg, torch.as_tensor(text), torch.as_tensor(drop))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_sample_cfm_with_unett_hooks():
    """One Ralston solve with fused CFG through ``forward_fn``/``embed_fn``,
    ragged rows, from the same ``y0``: fp32 atol 1e-4."""
    jcfg, jp, tcfg, tp = _unett_pair("concat")
    rng = np.random.default_rng(2)
    b, n = 2, 48
    data = dict(cond=rng.standard_normal((b, n, 20)).astype(np.float32), cond_lens=np.array([16, 10], np.int32),
                text=np.where(np.arange(20)[None] < np.array([[20], [12]]), rng.integers(0, 30, (b, 20)), -1)
                .astype(np.int32), duration=np.array([48, 40], np.int32))
    y0 = rng.standard_normal((b, n, 20)).astype(np.float32)
    ref = je.sample_cfm(jp, jcfg, **{k: jnp.asarray(v) for k, v in data.items()},
                        sampler=je.SamplerConfig(steps=2, method="ralston", cfg_strength=2.0), y0=jnp.asarray(y0),
                        forward_fn=ju.unett_forward, embed_fn=ju.unett_embed)
    out = te.sample_cfm(tp, tcfg, **{k: torch.as_tensor(v) for k, v in data.items()},
                        sampler=te.SamplerConfig(steps=2, method="ralston", cfg_strength=2.0), y0=torch.as_tensor(y0),
                        forward_fn=tu.unett_forward, embed_fn=tu.unett_embed)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_engine_hooks_reach_every_solve_and_the_step_batcher():
    """A UNetT engine and its step batcher call the UNetT's functions (the
    DiT's would fail on the UNetT's params): a window request and a row
    through ``StepBatcher`` (fp32) give the same wave."""
    from f5tts_tpu_torch.engine import step_batcher as sb
    from f5tts_tpu_torch.engine.engine import EngineConfig, RowSpec, TTSEngine
    from f5tts_tpu_torch.models.vocos import VocosConfig
    from f5tts_tpu_torch.ops.mel import MelConfig
    from f5tts_tpu_torch.sampling.euler import SamplerConfig
    from f5tts_tpu_torch.text.tokenizer import Tokenizer

    tcfg = tu.UNetTConfig(**UNETT)
    voc_cfg = VocosConfig(input_channels=20, dim=16, intermediate_dim=32, num_layers=1)
    calls = {"unett": 0}

    def fwd(*a, **kw):
        calls["unett"] += 1
        return tu.unett_forward(*a, **kw)

    engine = TTSEngine(t_convert.init_unett_numpy(tcfg, seed=0), tcfg, t_convert.init_vocos_numpy(voc_cfg, seed=1),
                       Tokenizer.from_texts(["abc def. unett hooks"]),
                       EngineConfig(mel=MelConfig(n_mels=20), vocoder=voc_cfg, compute_dtype="float32",
                                    sampler=SamplerConfig(steps=2, method="ralston"), duration_buckets=(64,),
                                    text_pad=32),
                       device="cpu", forward_fn=fwd, embed_fn=tu.unett_embed)
    cond = np.random.default_rng(0).standard_normal((12, 20)).astype(np.float32)
    row = RowSpec(text="abc def.", cond_mel=cond, ref_frames=12, duration=40, steps=2, seed=3)
    window = engine.synthesize_rows([row])[0][0]
    n_window = calls["unett"]
    batcher = sb.StepBatcher(engine, segment_intervals=1).start()
    try:
        stepped = batcher.submit(row).result(timeout=120)[0]
    finally:
        batcher.stop()
    assert n_window == 4 and calls["unett"] > n_window  # 2 Ralston steps x 2 evals, then the segments
    np.testing.assert_allclose(stepped, window, atol=1e-5)
