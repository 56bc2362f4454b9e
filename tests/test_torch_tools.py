"""The port's probe and profiling tools for the flow branch
(``f5tts_tpu_torch/scripts/{e2e_real_ckpt,strict_live_probe,profile_sampler,
component_bench}.py``) against the JAX package on the CPU.

Tiny widths (2-layer DiTs of dim 64), fp32, JAX matmul precision ``highest``
(``tests/conftest.py``), TF32 off; one torch thread (thousands of tiny ops).

- e2e: the tool's trainer-layout ``.pt`` read by the JAX ``load_f5_checkpoint``
  is the port's CLI ``.npz`` tree bit for bit; the JAX ``sample_cfm`` on it
  equals the tool's parity solve from the same ``y0`` (relative L2 1e-5);
  the online tree's solve differs.
- profile_sampler: each knock-out solve from a given ``y0`` equals the JAX
  ``sample_cfm`` with the same attribute of ``f5tts_tpu.models.modules``
  patched as the JAX script patches it (relative L2 1e-5).
- component_bench: the DiT step (both attention paths) and the Vocos decode
  equal JAX ``dit_forward`` / ``vocos_decode`` (relative L2 1e-5).
- strict_live_probe at the service's demo model: the ``http`` and
  ``service`` transports give the same rows, with the JAX script's keys.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import dit as j_dit
from f5tts_tpu.models import modules as j_m
from f5tts_tpu.models import vocos as j_vocos
from f5tts_tpu.models.convert import load_f5_checkpoint as j_load_f5_checkpoint
from f5tts_tpu.sampling import euler as j_euler
from f5tts_tpu_torch.models import modules as t_m
from f5tts_tpu_torch.models.convert import (dit_params_from_numpy, init_dit_numpy, init_vocos_numpy,
                                            load_params_npz, vocos_params_from_numpy)
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.models.vocos import VocosConfig
from f5tts_tpu_torch.scripts import component_bench as cb
from f5tts_tpu_torch.scripts import e2e_real_ckpt as e2e
from f5tts_tpu_torch.scripts import profile_sampler as ps
from f5tts_tpu_torch.scripts import strict_live_probe as slp
from f5tts_tpu_torch.train.tree import tree_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = DiTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=64, text_dim=32,
                 conv_layers=1)
TINY_VOCOS = VocosConfig(dim=48, intermediate_dim=96, num_layers=2)
DIT_FIELDS = ("dim", "depth", "heads", "dim_head", "ff_mult", "mel_dim", "text_num_embeds", "text_dim", "conv_layers")
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfg(cfg: DiTConfig, **kw):
    return j_dit.DiTConfig(**{f: getattr(cfg, f) for f in DIT_FIELDS}, **kw)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# e2e_real_ckpt
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def e2e_run(tmp_path_factory):
    """The tool at a tiny width, its convert CLI run in-process with the
    registry name mapped to the tiny config; the files kept."""
    cfg = dataclasses.replace(TINY, text_num_embeds=e2e.INDICF5_VOCAB)
    from f5tts_tpu_torch.cli import convert as cli

    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "backbone_config", lambda model, vocab: dataclasses.replace(cfg, text_num_embeds=vocab))
    try:
        result, arrays = e2e.run(cfg, TINY_VOCOS, str(tmp_path_factory.mktemp("e2e") / "f5_e2e.pt"), nfe=2,
                                 bucket=256, device="cpu", in_process=True, keep_ckpt=True)
    finally:
        mp.undo()
    return cfg, result, arrays


def test_e2e_checkpoint_has_the_trainer_layout(e2e_run):
    cfg, result, arrays = e2e_run
    ckpt = torch.load(arrays["pt"], map_location="cpu", weights_only=True)
    assert set(ckpt) == {"model_state_dict", "ema_model_state_dict", "scheduler_state_dict", "step"}
    ema = ckpt["ema_model_state_dict"]
    assert {"initted", "step", "ema_model.mel_spec.mel_stft.mel_scale.fb",
            "ema_model.mel_spec.mel_stft.spectrogram.window"} <= set(ema)
    assert ema["ema_model.mel_spec.mel_stft.mel_scale.fb"].shape == (513, cfg.mel_dim)
    assert ema["ema_model.mel_spec.mel_stft.spectrogram.window"].shape == (1024,)
    assert all(k.startswith("ema_model.") for k in ema if k not in ("initted", "step"))
    msd = ckpt["model_state_dict"]
    assert set(msd) == {k[len("ema_model."):] for k in ema if k.startswith("ema_model.")}
    w = "transformer.transformer_blocks.0.attn.to_q.weight"
    assert 0 < float((ema["ema_model." + w] - msd[w]).abs().max()) < 1e-2
    assert result["params_m"] * 1e6 == sum(v.numel() for k, v in msd.items() if not k.startswith("mel_spec."))
    assert set(result) >= {"params_m", "ckpt_gb", "nfe", "bucket", "device", "mel_rmse", "mel_rel", "parity_ok",
                           "wave_samples"}


def test_e2e_jax_loader_reads_the_pt_as_the_port_cli_npz(e2e_run):
    cfg, _, arrays = e2e_run
    want = dict(tree_leaves(load_params_npz(arrays["npz"])))
    got = dict(tree_leaves(jax.tree.map(np.asarray, j_load_f5_checkpoint(arrays["pt"], _jax_cfg(cfg)))))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_e2e_parity_solve_matches_the_jax_sampler_and_the_ema_dict(e2e_run):
    cfg, result, arrays = e2e_run
    assert result["parity_ok"] and result["mel_rel"] == 0.0 and result["online_mel_rel"] > e2e.ONLINE_MIN_REL
    inp = arrays["inputs"]
    jtree = j_load_f5_checkpoint(arrays["pt"], _jax_cfg(cfg))
    want = np.asarray(j_euler.sample_cfm(
        jtree, _jax_cfg(cfg), cond=jnp.asarray(inp["cond"]), cond_lens=jnp.asarray(inp["cond_lens"]),
        text=jnp.asarray(inp["text"]), duration=jnp.asarray(inp["duration"]),
        sampler=j_euler.SamplerConfig(method="euler", steps=2), y0=jnp.asarray(inp["y0"]),
        compute_dtype=jnp.float32))
    dur = int(inp["duration"][0])
    assert _rel(arrays["mels"]["loaded"][:, :dur], want[:, :dur]) <= REL
    assert _rel(arrays["mels"]["online"][:, :dur], want[:, :dur]) > e2e.ONLINE_MIN_REL
    assert result["wave_samples"] > 0


@pytest.mark.parametrize("tool", ["e2e_real_ckpt", "strict_live_probe", "profile_sampler", "component_bench",
                                  "parler_roofline", "parler_step_probe"])
def test_tool_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch, tmp_path, tool):
    """No GPU here: every tool's defaults raise before anything is written
    (no default output names a file, least of all one the repo holds)."""
    import importlib

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PS_OUT", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"f5tts_tpu_torch.scripts.{tool}").main([])
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# profile_sampler
# ---------------------------------------------------------------------------

JAX_KNOCKOUTS = {  # scripts/profile_sampler.py:78-103
    "no-attention": ("attention", lambda p, x, *a, **k: x),
    "no-ff": ("feed_forward", lambda p, x, *a, **k: x),
    "no-convpos": ("conv_pos_embedding", lambda p, x, *a, **k: jnp.zeros_like(x)),
    "no-adaln": ("adaln_zero", lambda p, x, emb, *a, **k: (x, jnp.ones_like(emb), jnp.zeros_like(emb),
                                                           jnp.zeros_like(emb), jnp.ones_like(emb))),
}


@pytest.fixture(scope="module")
def sampler_case():
    tree = init_dit_numpy(TINY, seed=3)
    inputs = ps.make_inputs(TINY, b=2, n=48, ref_frames=12, text_pad=24)
    y0 = np.random.default_rng(4).standard_normal((2, 48, TINY.mel_dim)).astype(np.float32)
    return tree, dit_params_from_numpy(tree, "cpu", torch.float32), inputs, y0


@pytest.mark.parametrize("variant", ps.VARIANTS)
def test_knockout_solve_matches_jax_with_the_same_patch(sampler_case, monkeypatch, variant):
    tree, params, inputs, y0 = sampler_case
    got = ps.solve(params, TINY, inputs, variant, method="ralston", nfe=4, compute_dtype=torch.float32,
                   y0=torch.as_tensor(y0)).numpy()
    assert t_m.attention is not None and all(getattr(t_m, n) is not fn for n, fn in ps.KNOCKOUTS.values())
    if variant in JAX_KNOCKOUTS:
        monkeypatch.setattr(j_m, *JAX_KNOCKOUTS[variant])
    jcfg = _jax_cfg(TINY)  # attn "xla": the port's flash wrapper (plain on the CPU) and its SDPA path alike
    j = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    want = np.asarray(j_euler.sample_cfm(
        _jax_tree(tree), jcfg, cond=j["cond"], cond_lens=j["cond_lens"], text=j["text"], duration=j["duration"],
        sampler=j_euler.SamplerConfig(steps=2, cfg_strength=2.0, method="ralston"), y0=jnp.asarray(y0),
        compute_dtype=jnp.float32))
    assert _rel(got, want) <= REL
    if variant != "full":  # the knock-out changes the solve
        full = ps.solve(params, TINY, inputs, "full", method="ralston", nfe=4, compute_dtype=torch.float32,
                        y0=torch.as_tensor(y0)).numpy()
        assert variant == "other-attn" or _rel(got, full) > 1e-3


def test_knockout_is_undone_when_the_solve_raises():
    orig = t_m.feed_forward
    with pytest.raises(ZeroDivisionError):
        with ps.knocked_out("no-ff"):
            assert t_m.feed_forward is not orig
            1 / 0
    assert t_m.feed_forward is orig


def test_profile_reports_every_variant_on_the_cpu(sampler_case):
    _, params, inputs, _ = sampler_case
    out = ps.profile(params, TINY, inputs, iters=1, nfe=2, device="cpu", log=lambda *_: None)
    assert list(out["times_s"]) == ["full", "no-attention", "no-ff", "no-convpos", "no-adaln", "plain-attn"]
    assert all(v > 0 for v in out["times_s"].values()) and out["families"] is None
    assert all(c == {"flash_attention": 0, "rope_rows": 0, "conv_pos": 0} for c in out["launches"].values())
    assert out["forwards"] == 2 and out["device_launches"] is None  # Ralston NFE 2: one step of two evaluations


def test_profile_runs_the_unett_through_its_hooks_on_the_cpu():
    from f5tts_tpu_torch.models.convert import init_unett_numpy, unett_params_from_numpy
    from f5tts_tpu_torch.models.unett import UNetTConfig, unett_forward
    from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm

    cfg = UNetTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=64, text_dim=32,
                      conv_layers=1)
    base, init, to_device, fns = ps.BACKBONES["unett"]
    assert base() == UNetTConfig.base() and fns["forward_fn"] is unett_forward
    params = to_device(init(cfg, seed=3), "cpu", torch.float32)
    inputs = ps.make_inputs(cfg, b=2, n=48, ref_frames=12, text_pad=24)
    calls = []

    def forward(*a, **k):
        calls.append(a[0] is params)
        return unett_forward(*a, **k)

    out = ps.profile(params, cfg, inputs, ("full",), iters=1, nfe=2, device="cpu", log=lambda *_: None,
                     fns={**fns, "forward_fn": forward})
    assert list(out["times_s"]) == ["full"] and out["forwards"] == 2
    assert calls == [True] * 4  # a warm solve and a timed one, two fused-CFG forwards each
    y0 = torch.as_tensor(np.random.default_rng(4).standard_normal((2, 48, cfg.mel_dim)).astype(np.float32))
    got = ps.solve(params, cfg, inputs, "full", nfe=4, compute_dtype=torch.float32, y0=y0, fns=fns)
    want = sample_cfm(unett_params_from_numpy(init_unett_numpy(cfg, seed=3), "cpu", torch.float32), cfg, **inputs,
                      sampler=SamplerConfig(steps=2, cfg_strength=2.0, method="ralston"), y0=y0,
                      compute_dtype=torch.float32, forward_fn=unett_forward, embed_fn=fns["embed_fn"])
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


# ---------------------------------------------------------------------------
# component_bench
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn", cb.ATTN_PATHS)
def test_component_step_matches_jax_dit_forward(attn):
    tree = init_dit_numpy(TINY, seed=5)
    cfg = dataclasses.replace(TINY, attn_impl=attn)
    inp = cb.step_inputs(cfg, 4, 40, np.random.default_rng(6), dtype=torch.float32)
    got = cb.dit_step(dit_params_from_numpy(tree, "cpu", torch.float32), cfg, inp, torch.float32).numpy()
    j = {k: jnp.asarray(v.numpy()) for k, v in inp.items()}
    want = j_dit.dit_forward(_jax_tree(tree), _jax_cfg(TINY), j["x"], j["x"], j["text"], j["time"], j["drop"],
                             j["drop"], j["mask"], compute_dtype=jnp.float32)
    assert _rel(got, want) <= REL


def test_component_vocos_decode_matches_jax():
    vcfg = VocosConfig(input_channels=TINY.mel_dim, dim=48, intermediate_dim=96, num_layers=2)
    tree = init_vocos_numpy(vcfg, seed=7)
    mel = np.random.default_rng(8).standard_normal((2, 40, vcfg.input_channels)).astype(np.float32)
    got = cb.vocos_step(vocos_params_from_numpy(tree, "cpu", torch.float32), vcfg, torch.as_tensor(mel),
                        torch.float32).numpy()
    jcfg = j_vocos.VocosConfig(input_channels=vcfg.input_channels, dim=48, intermediate_dim=96, num_layers=2)
    want = j_vocos.vocos_decode(_jax_tree(tree), jnp.asarray(mel), jcfg, compute_dtype=jnp.float32)
    assert _rel(got, want) <= REL


# ---------------------------------------------------------------------------
# strict_live_probe
# ---------------------------------------------------------------------------


def test_strict_probe_transports_give_the_same_rows(tmp_path):
    settings = {**slp.write_assets(str(tmp_path)), "warmup": False, "speech_rate_limit": "1000/minute",
                "device": "cpu", "demo_tiny": True}
    outs = {t: slp.run(t, settings, str(tmp_path), easy_chars=12, hard_chars=60, timeout=120, log=lambda *_: None)
            for t in ("service", "http")}
    for out in outs.values():
        assert {"teacher", "threshold", "rows"} <= set(out)  # the JAX script's keys
        assert out["threshold"] == 0.12 and out["teacher"] == "demo_tiny"
        assert list(out["rows"]) == ["easy_strict", "hard_strict", "hard_default"]
        for row in out["rows"].values():
            assert set(row) == {"latency_s", "wav_bytes", "escalations_delta", "metrics_after"}
            assert row["wav_bytes"] > 44 and row["escalations_delta"] >= 0
        assert out["rows"]["hard_default"]["escalations_delta"] == 0  # default quality never escalates
    for name in outs["service"]["rows"]:
        a, b = outs["service"]["rows"][name], outs["http"]["rows"][name]
        assert (a["wav_bytes"], a["escalations_delta"]) == (b["wav_bytes"], b["escalations_delta"]), name
    assert json.dumps(outs["http"])  # the output is JSON
