"""The port's torch-checkpoint converters (``f5tts_tpu_torch/models/convert.py``)
against the JAX package's (``f5tts_tpu/models/convert.py``, ``convert_bigvgan``)
on the same files: identical key sets and arrays equal bit for bit. State
dicts are written in the reference's torch layout from seeded params: the JAX
``export_f5_state_dict`` for F5, the key layouts of ``tests/test_convert.py``
(E2) and ``tests/test_bigvgan.py`` (BigVGAN, a transposed-conv kernel that
is not flip-symmetric), and their inverses for Vocos and MMDiT. Also the
round trip ``export_f5_state_dict`` -> ``convert_f5_dit``, the port's
``cli/convert`` ``.npz`` against the JAX CLI's, and ``bigvgan_decode`` on a
converted state dict (fp32, atol 1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import bigvgan as jb
from f5tts_tpu.models import convert as jc
from f5tts_tpu.models import dit as jd
from f5tts_tpu.models import mmdit as jm
from f5tts_tpu.models import unett as ju
from f5tts_tpu.models import vocos as jv
from f5tts_tpu_torch.models import bigvgan as tb
from f5tts_tpu_torch.models import convert as tc
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.models import mmdit as tm
from f5tts_tpu_torch.models import unett as tu
from f5tts_tpu_torch.models import vocos as tv

TINY = dict(dim=32, depth=3, heads=2, dim_head=16, ff_mult=2, mel_dim=10, text_num_embeds=12, text_dim=16,
            conv_layers=2, max_pos=64)
VOC = dict(input_channels=10, dim=16, intermediate_dim=24, num_layers=2)


def _flat(tree, prefix=""):
    """'/'-joined leaves of a params tree (lists by index), as numpy."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix: np.asarray(tree)}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def assert_trees_bit_equal(got, want):
    g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _f5_params(cfg=jd.DiTConfig(**TINY), seed=0):
    return jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(seed), cfg))


def _torch_sd(sd):
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("layout", ["pt_trainer_ema", "pt_model_state", "pt_bare_ema_keys", "safetensors"])
def test_f5_checkpoint_matches_jax(tmp_path, layout):
    """A trainer's ``.pt`` (EMA state dict with ``ema_model.*`` keys,
    ``initted``/``step`` and a stale mel buffer), a ``model_state_dict``
    ``.pt``, a bare ``.pt`` of ``ema_model.*`` keys and a ``.safetensors``:
    the port's ``load_f5_checkpoint`` gives the JAX tree bit for bit."""
    cfg = jd.DiTConfig(**TINY)
    sd = jc.export_f5_state_dict(_f5_params(cfg), cfg)
    ema = {f"ema_model.{k}": v for k, v in sd.items()}
    ema.update({"initted": np.ones((1,), np.float32), "step": np.full((1,), 7.0, np.float32),
                "ema_model.mel_spec.mel_stft.fb": np.ones((3, 4), np.float32)})
    if layout == "safetensors":
        path = str(tmp_path / "model.safetensors")
        jc.save_f5_safetensors(path, _f5_params(cfg), cfg)
    else:
        path = str(tmp_path / "model.pt")
        obj = {"pt_trainer_ema": {"ema_model_state_dict": _torch_sd(ema), "model_state_dict": {}, "step": 3},
               "pt_model_state": {"model_state_dict": _torch_sd(sd)},
               "pt_bare_ema_keys": _torch_sd(ema)}[layout]
        torch.save(obj, path)
    assert_trees_bit_equal(tc.load_f5_checkpoint(path, td.DiTConfig(**TINY)), jc.load_f5_checkpoint(path, cfg))
    got_sd, want_sd = tc.load_torch_state_dict(path), jc.load_torch_state_dict(path)
    assert sorted(got_sd) == sorted(want_sd)
    for k in want_sd:
        np.testing.assert_array_equal(got_sd[k], want_sd[k])


def test_export_f5_state_dict_matches_jax_and_round_trips(tmp_path):
    cfg = jd.DiTConfig(**TINY, long_skip_connection=True)
    params = jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(1), cfg))
    tcfg = td.DiTConfig(**TINY, long_skip_connection=True)
    got, want = tc.export_f5_state_dict(params, tcfg), jc.export_f5_state_dict(params, cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert_trees_bit_equal(tc.convert_f5_dit(got, tcfg), params)  # the inverse of the converter
    from f5tts_tpu_torch.train.tree import tree_map  # tensors export alike
    assert_trees_bit_equal(tc.convert_f5_dit(tc.export_f5_state_dict(tree_map(torch.as_tensor, params), tcfg), tcfg),
                           params)
    tc.save_f5_safetensors(str(tmp_path / "t.safetensors"), params, tcfg)
    jc.save_f5_safetensors(str(tmp_path / "j.safetensors"), params, cfg)
    from safetensors.numpy import load_file

    a, b = load_file(str(tmp_path / "t.safetensors")), load_file(str(tmp_path / "j.safetensors"))
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_vocos_checkpoint_matches_jax_and_round_trips(tmp_path):
    cfg = jv.VocosConfig(**VOC)
    params = jax.tree.map(np.asarray, jv.init_vocos(jax.random.PRNGKey(2), cfg))
    sd = tc.export_vocos_state_dict(params, tv.VocosConfig(**VOC))
    path = str(tmp_path / "pytorch_model.bin")
    torch.save(_torch_sd(sd), path)
    got = tc.load_vocos_checkpoint(path, tv.VocosConfig(**VOC))
    assert_trees_bit_equal(got, jc.load_vocos_checkpoint(path, cfg))
    assert_trees_bit_equal(got, params)


def _e2_state_dict(rng, skip: str, depth=4, dim=16):
    """The E2 / UNetT torch layout of ``tests/test_convert.py``: layers.{i}.[0 =
    skip_proj (second half, concat), 1 = attn RMSNorm, 2 = attn, 3 = ff
    RMSNorm, 4 = ff]."""
    sd = {}

    def lin(prefix, din, dout, bias=True):
        sd[prefix + ".weight"] = rng.standard_normal((dout, din)).astype(np.float32)
        if bias:
            sd[prefix + ".bias"] = rng.standard_normal(dout).astype(np.float32)

    t = "transformer"
    lin(f"{t}.time_embed.time_mlp.0", 256, dim)
    lin(f"{t}.time_embed.time_mlp.2", dim, dim)
    sd[f"{t}.text_embed.text_embed.weight"] = rng.standard_normal((12, 8)).astype(np.float32)
    cb = f"{t}.text_embed.text_blocks.0"
    sd[f"{cb}.dwconv.weight"] = rng.standard_normal((8, 1, 7)).astype(np.float32)
    sd[f"{cb}.dwconv.bias"] = rng.standard_normal(8).astype(np.float32)
    sd[f"{cb}.norm.weight"] = rng.standard_normal(8).astype(np.float32)
    sd[f"{cb}.norm.bias"] = rng.standard_normal(8).astype(np.float32)
    lin(f"{cb}.pwconv1", 8, 16)
    sd[f"{cb}.grn.gamma"] = rng.standard_normal((1, 1, 16)).astype(np.float32)
    sd[f"{cb}.grn.beta"] = rng.standard_normal((1, 1, 16)).astype(np.float32)
    lin(f"{cb}.pwconv2", 16, 8)
    lin(f"{t}.input_embed.proj", 6 * 2 + 8, dim)
    for c in (0, 2):
        sd[f"{t}.input_embed.conv_pos_embed.conv1d.{c}.weight"] = rng.standard_normal((dim, 1, 31)).astype(np.float32)
        sd[f"{t}.input_embed.conv_pos_embed.conv1d.{c}.bias"] = rng.standard_normal(dim).astype(np.float32)
    for i in range(depth):
        if i >= depth // 2 and skip == "concat":
            lin(f"{t}.layers.{i}.0", 2 * dim, dim, bias=False)
        sd[f"{t}.layers.{i}.1.g"] = rng.standard_normal(dim).astype(np.float32)
        for nm in ("to_q", "to_k", "to_v"):
            lin(f"{t}.layers.{i}.2.{nm}", dim, dim)
        lin(f"{t}.layers.{i}.2.to_out.0", dim, dim)
        sd[f"{t}.layers.{i}.3.g"] = rng.standard_normal(dim).astype(np.float32)
        lin(f"{t}.layers.{i}.4.ff.0.0", dim, 2 * dim)
        lin(f"{t}.layers.{i}.4.ff.2", 2 * dim, dim)
    sd[f"{t}.norm_out.g"] = rng.standard_normal(dim).astype(np.float32)
    lin(f"{t}.proj_out", dim, 6)
    return sd


E2 = dict(dim=16, depth=4, heads=2, dim_head=8, ff_mult=2, mel_dim=6, text_num_embeds=11, text_dim=8, conv_layers=1,
          max_pos=64)


@pytest.mark.parametrize("skip", ["concat", "add"])
def test_e2_unett_checkpoint_matches_jax(tmp_path, skip):
    sd = _e2_state_dict(np.random.default_rng(3), skip)
    path = str(tmp_path / "e2.pt")
    torch.save({"ema_model_state_dict": _torch_sd({f"ema_model.{k}": v for k, v in sd.items()})}, path)
    tcfg, jcfg = tu.UNetTConfig(**E2, skip_connect_type=skip), ju.UNetTConfig(**E2, skip_connect_type=skip)
    got = tc.load_e2_checkpoint(path, tcfg)
    assert_trees_bit_equal(got, jc.convert_e2_unett(jc.load_torch_state_dict(path), jcfg))
    # the converted tree runs: the port's forward on it equals the JAX forward
    rng = np.random.default_rng(4)
    x, cond = rng.standard_normal((2, 20, 6)).astype(np.float32), rng.standard_normal((2, 20, 6)).astype(np.float32)
    text = rng.integers(0, 11, (2, 9)).astype(np.int32)
    t, drop = np.array([0.4, 0.9], np.float32), np.array([False, False])
    ref = ju.unett_forward(jax.tree.map(jnp.asarray, got), jcfg, *(jnp.asarray(a) for a in (x, cond, text, t, drop, drop)))
    out = tu.unett_forward(tc.unett_params_from_numpy(got, "cpu"), tcfg,
                           *(torch.as_tensor(a) for a in (x, cond, text, t, drop, drop)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-4)


def _mmdit_state_dict(params, depth):
    """Inverse of ``convert_mmdit``: the MMDiT torch layout of a params tree."""
    sd = {}

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
        if "b" in p:
            sd[f"{prefix}.bias"] = np.asarray(p["b"])

    t = "transformer"
    lin(f"{t}.time_embed.time_mlp.0", params["time_embed"]["mlp1"])
    lin(f"{t}.time_embed.time_mlp.2", params["time_embed"]["mlp2"])
    sd[f"{t}.text_embed.text_embed.weight"] = np.asarray(params["text_embed"]["w"])
    lin(f"{t}.audio_embed.linear", params["audio_embed"]["proj"])
    for c, nm in ((0, "conv1"), (2, "conv2")):
        p = params["audio_embed"]["conv_pos"][nm]
        sd[f"{t}.audio_embed.conv_pos_embed.conv1d.{c}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).transpose(2, 1, 0))
        sd[f"{t}.audio_embed.conv_pos_embed.conv1d.{c}.bias"] = np.asarray(p["b"])
    blocks = [jax.tree.map(lambda a, i=i: np.asarray(a)[i], params["blocks"]) for i in range(depth - 1)]
    for i, blk in enumerate(blocks + [params["final_block"]]):
        b = f"{t}.transformer_blocks.{i}"
        lin(f"{b}.attn_norm_c.linear", blk["attn_norm_c"]["linear"])
        lin(f"{b}.attn_norm_x.linear", blk["attn_norm_x"]["linear"])
        for nm in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c"):
            lin(f"{b}.attn.{nm}", blk["attn"][nm])
        lin(f"{b}.attn.to_out.0", blk["attn"]["to_out"])
        lin(f"{b}.ff_x.ff.0.0", blk["ff_x"]["in"])
        lin(f"{b}.ff_x.ff.2", blk["ff_x"]["out"])
        if "to_out_c" in blk["attn"]:
            lin(f"{b}.attn.to_out_c", blk["attn"]["to_out_c"])
            lin(f"{b}.ff_c.ff.0.0", blk["ff_c"]["in"])
            lin(f"{b}.ff_c.ff.2", blk["ff_c"]["out"])
    lin(f"{t}.norm_out.linear", params["norm_out"]["linear"])
    lin(f"{t}.proj_out", params["proj_out"])
    return sd


def test_mmdit_checkpoint_matches_jax(tmp_path):
    mm = dict(dim=32, depth=3, heads=2, dim_head=16, ff_mult=2, mel_dim=10, text_num_embeds=12)
    params = jax.tree.map(np.asarray, jm.init_mmdit(jax.random.PRNGKey(4), jm.MMDiTConfig(**mm)))
    path = str(tmp_path / "mmdit.safetensors")
    from safetensors.numpy import save_file

    save_file(_mmdit_state_dict(params, 3), path)
    got = tc.convert_mmdit(tc.load_torch_state_dict(path), tm.MMDiTConfig(**mm))
    assert_trees_bit_equal(got, jc.convert_mmdit(jc.load_torch_state_dict(path), jm.MMDiTConfig(**mm)))
    assert_trees_bit_equal(got, params)


BIGVGAN = dict(mel_dim=8, upsample_initial_channel=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
               resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),))


def _bigvgan_state_dict(seed=0):
    """The generator layout of ``tests/test_bigvgan.py``, seeded; its
    transposed-conv kernels are random, so no kernel is flip-symmetric."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=0.2):
        return torch.randn(*shape, generator=g) * scale

    sd = {"conv_pre.weight": r(16, 8, 7), "conv_pre.bias": r(16), "conv_post.weight": r(1, 4, 7, scale=0.01),
          "conv_post.bias": r(1), "activation_post.act.alpha": r(1, 4, 1), "activation_post.act.beta": r(1, 4, 1)}
    chans = [16, 8, 4]
    for i in range(2):
        cin, cout = chans[i], chans[i + 1]
        sd[f"ups.{i}.0.weight"], sd[f"ups.{i}.0.bias"] = r(cin, cout, 4), r(cout)
        for d in range(2):
            for nm in ("convs1", "convs2"):
                sd[f"resblocks.{i}.{nm}.{d}.weight"], sd[f"resblocks.{i}.{nm}.{d}.bias"] = r(cout, cout, 3), r(cout)
            for a in range(2):
                sd[f"resblocks.{i}.activations.{2 * d + a}.act.alpha"] = r(1, cout, 1)
                sd[f"resblocks.{i}.activations.{2 * d + a}.act.beta"] = r(1, cout, 1)
    return sd


def test_bigvgan_checkpoint_matches_jax_and_the_flip_is_undone(tmp_path):
    sd = _bigvgan_state_dict()
    w0 = sd["ups.0.0.weight"]
    assert not torch.equal(w0, w0.flip(-1))  # a missing flip would show
    path = str(tmp_path / "bigvgan_generator.pt")
    torch.save({k: v.clone() for k, v in sd.items()}, path)
    jcfg, tcfg = jb.BigVGANConfig(**BIGVGAN), tb.BigVGANConfig(**BIGVGAN)
    got = tc.load_bigvgan_checkpoint(path, tcfg)
    want = jb.convert_bigvgan({k: v.numpy() for k, v in sd.items()}, jcfg)
    assert_trees_bit_equal(got, want)
    laid_out = tc.bigvgan_params_from_numpy(got, "cpu")
    for i in range(2):  # the port's kernels are torch's own, bit for bit
        assert torch.equal(laid_out["ups"][i]["w"], sd[f"ups.{i}.0.weight"])
    mel = np.random.default_rng(1).standard_normal((2, 12, 8)).astype(np.float32)
    ref = np.asarray(jb.bigvgan_decode(want, jnp.asarray(mel), jcfg))
    out = tb.bigvgan_decode(laid_out, torch.as_tensor(mel), tcfg).numpy()
    assert out.shape == (2, 12 * 4) and np.abs(ref).max() < 0.99  # unsaturated: the comparison means something
    np.testing.assert_allclose(out, ref, atol=1e-4)


def _vocab(tmp_path, n):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join([" "] + [chr(97 + i) for i in range(n - 1)]) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("model", ["F5TTS_Base", "E2TTS_Base"])
def test_cli_convert_writes_the_jax_clis_npz(tmp_path, model, capsys):
    """The same torch file through both CLIs: the same ``.npz`` keys and
    arrays. The state dicts have the Base depth (22 DiT blocks, 4 text
    blocks; 24 UNetT layers) at a narrow width: the converters take the
    widths from the file."""
    from f5tts_tpu.cli import convert as j_cli
    from f5tts_tpu_torch.cli import convert as t_cli

    vocab = _vocab(tmp_path, 11)
    if model == "F5TTS_Base":
        cfg = jd.DiTConfig(**{**TINY, "depth": 22, "conv_layers": 4, "text_num_embeds": 11})
        sd = jc.export_f5_state_dict(_f5_params(cfg), cfg)
    else:
        sd = _e2_state_dict(np.random.default_rng(5), "concat", depth=24)
        for i in range(1, 4):  # the Base's four text blocks
            for k in [k for k in sd if k.startswith("transformer.text_embed.text_blocks.0.")]:
                sd[k.replace("text_blocks.0.", f"text_blocks.{i}.")] = sd[k] + i
    ckpt = str(tmp_path / "model.pt")
    torch.save(_torch_sd(sd), ckpt)
    voc_params = jax.tree.map(np.asarray, jv.init_vocos(jax.random.PRNGKey(2), jv.VocosConfig(num_layers=8, dim=16,
                                                                                              intermediate_dim=24)))
    voc = str(tmp_path / "vocos.bin")
    torch.save(_torch_sd(tc.export_vocos_state_dict(voc_params)), voc)
    outs = {}
    for name, cli in (("t", t_cli), ("j", j_cli)):
        cli.main(["--ckpt", ckpt, "--model", model, "--vocab", vocab, "--out", str(tmp_path / f"{name}.npz"),
                  "--vocoder-ckpt", voc, "--vocoder-out", str(tmp_path / f"{name}_voc.npz")])
        outs[name] = [dict(np.load(tmp_path / f"{name}{suf}.npz")) for suf in ("", "_voc")]
    assert "wrote" in capsys.readouterr().out
    for got, want in zip(outs["t"], outs["j"]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_convert_exports_a_trainer_directory(tmp_path):
    """A checkpoint directory of the port's ``Trainer``: the EMA by default,
    the raw params with ``--raw-weights``."""
    from f5tts_tpu_torch.cli import convert as t_cli
    from f5tts_tpu_torch.train.checkpoint import save_state

    params = {"w": torch.ones(2, 3)}
    save_state(str(tmp_path / "run"), 4, {"params": params, "ema": {"w": torch.full((2, 3), 2.0)}, "step": 4})
    vocab = _vocab(tmp_path, 5)
    for flags, value in (([], 2.0), (["--raw-weights"], 1.0)):
        out = str(tmp_path / f"o{value}.npz")
        t_cli.main(["--ckpt", str(tmp_path / "run"), "--vocab", vocab, "--out", out, *flags])
        np.testing.assert_array_equal(np.load(out)["w"], np.full((2, 3), value, np.float32))


@pytest.mark.parametrize("which", ["unett_concat", "unett_add", "mmdit", "bigvgan"])
def test_seeded_init_has_the_jax_tree_and_shapes(which):
    if which.startswith("unett"):
        kw = {**E2, "skip_connect_type": which.split("_")[1]}
        got, want = tc.init_unett_numpy(tu.UNetTConfig(**kw)), ju.init_unett(jax.random.PRNGKey(0), ju.UNetTConfig(**kw))
    elif which == "mmdit":
        kw = dict(dim=32, depth=3, heads=2, dim_head=16, ff_mult=2, mel_dim=10, text_num_embeds=12)
        got, want = tc.init_mmdit_numpy(tm.MMDiTConfig(**kw)), jm.init_mmdit(jax.random.PRNGKey(0), jm.MMDiTConfig(**kw))
    else:
        got, want = tc.init_bigvgan_numpy(tb.BigVGANConfig(**BIGVGAN)), jb.init_bigvgan(jax.random.PRNGKey(0),
                                                                                         jb.BigVGANConfig(**BIGVGAN))
    g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    assert all(g[k].shape == w[k].shape and g[k].dtype == np.float32 for k in w)
