"""The port's CLIs (``f5tts_tpu_torch/cli/{infer,infer_batch}.py``) on the CPU
at ``--demo-tiny``: the sampler every flag set builds against the JAX CLI's,
the TOML config against the JAX ``load_config``, and runs of E2-TTS,
``--vocoder bigvgan``, a TOML with two voices, ``-f``, ``--fix-duration``,
``--remove-silence`` and a two-row CSV (finite waves of the planned length).
Also ``remove_long_silences`` against the JAX function (bit-equal) and the
service reading torch checkpoints (``load_checkpoint_tree``; bit-equal trees)
and serving with ``vocoder_type="bigvgan"``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from f5tts_tpu_torch.audio.io import read_wav, write_wav
from f5tts_tpu_torch.cli import infer as t_cli
from f5tts_tpu_torch.cli import infer_batch as t_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("flags", [[], ["--method", "euler"], ["--nfe", "16"], ["--cfg-interval", "0.2,0.8"],
                                   ["--cfg-cache", "2"], ["--time-grid", "0,0.3,0.7,1"],
                                   ["--method", "heun", "--sway", "0", "--cfg-strength", "1.5"]])
def test_sampler_flags_match_the_jax_cli(flags):
    from f5tts_tpu.cli import infer as j_cli

    j = j_cli.build_engine(j_cli.build_argparser().parse_args(["--demo-tiny", *flags]))
    t = t_cli.build_engine(t_cli.build_argparser().parse_args(["--demo-tiny", "--device", "cpu", *flags]))
    assert dataclasses.asdict(t.cfg.sampler) == dataclasses.asdict(j.cfg.sampler)


def _tone(path, seconds, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 24000)) / 24000
    write_wav(str(path), (0.1 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.standard_normal(t.shape)).astype(np.float32))


def test_toml_config_matches_the_jax_load_config(tmp_path):
    from f5tts_tpu.cli import infer as j_cli

    _tone(tmp_path / "town.wav", 1.5, 300, 1)
    (tmp_path / "story.toml").write_text(
        'demo-tiny = true\nmodel = "E2TTS_Base"\nnfe = 4\nvocoder = "bigvgan"\ngen-text = "A [town] B."\n'
        'output = "o.wav"\n[voices.town]\nref_audio = "town.wav"\nref_text = "town."\n', encoding="utf-8")
    argv = ["-c", str(tmp_path / "story.toml"), "--cfg-strength", "1.0"]
    j = vars(j_cli.load_config(j_cli.build_argparser().parse_args(argv)))
    t = vars(t_cli.load_config(t_cli.build_argparser().parse_args(argv)))
    assert t.pop("device") == "cuda" and j.pop("attn") == "auto"
    assert t == j and t["voices"]["town"]["ref_audio"] == str(tmp_path / "town.wav") and t["cfg_strength"] == 1.0


def _run(tmp_path, name, *argv):
    out = str(tmp_path / f"{name}.wav")
    t_cli.main(["--demo-tiny", "--device", "cpu", "--dtype", "float32", "--nfe", "2", "--seed", "1", "-o", out, *argv])
    wave, sr = read_wav(out)
    assert sr == 24000 and len(wave) > 0 and np.isfinite(wave).all()
    return wave


@pytest.mark.parametrize("argv", [["-m", "E2TTS_Base"], ["--vocoder", "bigvgan"],
                                  ["-m", "E2TTS_Small", "--vocoder", "bigvgan", "--method", "euler"]])
def test_cli_runs_the_backbones_and_vocoders(tmp_path, capsys, argv):
    """``--fix-duration 2`` against the 1-s demo reference: 1 s generated,
    (frames - 1) * 256 samples from Vocos and frames * 256 from BigVGAN."""
    wave = _run(tmp_path, "o", "-t", "Hello there.", "--fix-duration", "2.0", *argv)
    frames = int(2.0 * 24000 / 256) - 24000 // 256
    assert len(wave) == (frames if "bigvgan" in argv else frames - 1) * 256
    assert "wrote" in capsys.readouterr().out


def test_cli_two_voice_toml_gen_file_and_remove_silence(tmp_path, capsys):
    _tone(tmp_path / "main.wav", 2.0, 150, 2)
    _tone(tmp_path / "town.wav", 1.5, 300, 3)
    (tmp_path / "gen.txt").write_text("The narrator speaks. [town] The town answers. [main] And back.",
                                      encoding="utf-8")
    (tmp_path / "cfg.toml").write_text(
        'ref-audio = "main.wav"\nref-text = "main voice."\ngen-file = "gen.txt"\n'
        '[voices.town]\nref_audio = "town.wav"\nref_text = "the town."\n', encoding="utf-8")
    wave = _run(tmp_path, "story", "-c", str(tmp_path / "cfg.toml"))
    quiet = _run(tmp_path, "quiet", "-c", str(tmp_path / "cfg.toml"), "--remove-silence")
    assert len(quiet) <= len(wave)
    (tmp_path / "other.txt").write_text("The narrator speaks. [nobody] here.", encoding="utf-8")
    solo = _run(tmp_path, "solo", "-c", str(tmp_path / "cfg.toml"), "-f", str(tmp_path / "other.txt"))
    assert len(solo) > 0 and "[nobody] is not a known voice" in capsys.readouterr().err


def test_remove_long_silences_matches_jax():
    from f5tts_tpu.audio.preprocess import remove_long_silences as j_rls
    from f5tts_tpu_torch.audio.preprocess import remove_long_silences as t_rls

    rng = np.random.default_rng(0)
    loud = (0.2 * rng.standard_normal(24000)).astype(np.float32)
    wave = np.concatenate([loud, np.zeros(48000, np.float32), loud, np.zeros(6000, np.float32), loud])
    got, want = t_rls(wave, 24000), j_rls(wave, 24000)
    assert len(got) < len(wave)
    np.testing.assert_array_equal(got, want)


def test_infer_batch_csv(tmp_path, capsys):
    _tone(tmp_path / "v.wav", 1.5, 200, 4)
    (tmp_path / "rows.csv").write_text(
        "text,prompt_path,prompt_text,language,id\n"
        f"First row text.,{tmp_path / 'v.wav'},a voice.,hin_Deva,first\n"
        "Second row text.,,,,\n", encoding="utf-8")
    t_batch.main(["--csv", str(tmp_path / "rows.csv"), "--out-dir", str(tmp_path / "out"), "--demo-tiny",
                  "--device", "cpu", "--dtype", "float32", "--nfe", "2", "--seed", "0", "--vocoder", "bigvgan"])
    for path in (tmp_path / "out" / "hin_Deva" / "first.wav", tmp_path / "out" / "row00001.wav"):
        wave, sr = read_wav(str(path))
        assert sr == 24000 and len(wave) > 0 and len(wave) % 256 == 0 and np.isfinite(wave).all()
    assert capsys.readouterr().out.count("wrote") == 2


def _bigvgan_state_dict(tree: dict, cfg) -> dict:
    """Inverse of ``convert_bigvgan``: a BigVGAN params tree (JAX layout) as a
    generator state dict."""
    sd = {}

    def conv(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = np.asarray(p["w"]).transpose(2, 1, 0), p["b"]

    conv("conv_pre", tree["conv_pre"])
    conv("conv_post", tree["conv_post"])
    sd["activation_post.act.alpha"] = tree["alpha_post"].reshape(1, -1, 1)
    sd["activation_post.act.beta"] = tree["beta_post"].reshape(1, -1, 1)
    nk = len(cfg.resblock_kernel_sizes)
    for i, up in enumerate(tree["ups"]):
        sd[f"ups.{i}.0.weight"], sd[f"ups.{i}.0.bias"] = np.asarray(up["w"])[::-1].transpose(1, 2, 0), up["b"]
        for j, rb in enumerate(tree["resblocks"][i]):
            r = f"resblocks.{i * nk + j}"
            for d in range(len(rb["convs1"])):
                conv(f"{r}.convs1.{d}", rb["convs1"][d])
                conv(f"{r}.convs2.{d}", rb["convs2"][d])
                for a, (al, be) in enumerate((("alpha1", "beta1"), ("alpha2", "beta2"))):
                    sd[f"{r}.activations.{2 * d + a}.act.alpha"] = rb[al][d].reshape(1, -1, 1)
                    sd[f"{r}.activations.{2 * d + a}.act.beta"] = rb[be][d].reshape(1, -1, 1)
    return sd


@pytest.mark.parametrize("kind", ["f5", "vocos", "bigvgan"])
def test_load_checkpoint_tree_reads_torch_files(tmp_path, kind):
    """A ``.pt`` of each kind: the tree the JAX converter gives, bit for bit,
    and the tree it was written from."""
    from f5tts_tpu.models import bigvgan as jb
    from f5tts_tpu.models import convert as jc
    from f5tts_tpu.models import dit as jd
    from f5tts_tpu_torch.models import convert as tc
    from f5tts_tpu_torch.models.bigvgan import BigVGANConfig
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.serve.service import load_checkpoint_tree

    if kind == "f5":
        geometry = dict(dim=32, depth=2, heads=2, dim_head=16, text_dim=16, conv_layers=1, mel_dim=10)
        cfg = DiTConfig(**geometry)
        tree = tc.init_dit_numpy(cfg, seed=0)
        sd = tc.export_f5_state_dict(tree, cfg)
        want = jc.convert_f5_dit(sd, jd.DiTConfig(**geometry))
    elif kind == "vocos":
        cfg = None
        tree = tc.init_vocos_numpy(seed=1)
        sd = tc.export_vocos_state_dict(tree)
        want = jc.convert_vocos(sd)
    else:
        cfg = BigVGANConfig.demo_tiny()
        rng = np.random.default_rng(2)
        tree = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                            tc.init_bigvgan_numpy(cfg, seed=1))
        sd = _bigvgan_state_dict(tree, cfg)
        want = jb.convert_bigvgan(sd, jb.BigVGANConfig(**dataclasses.asdict(cfg)))
    path = str(tmp_path / "ckpt.pt")
    torch.save({"model_state_dict": {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()}}, path)
    got = load_checkpoint_tree(path, kind, cfg)
    for other in (want, tree):
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        flat_w = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, other))
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for (_, a), (_, b) in zip(flat_g, flat_w))


def test_service_serves_with_bigvgan():
    from f5tts_tpu_torch.serve.schemas import SpeechRequest
    from f5tts_tpu_torch.serve.service import ModelService
    from f5tts_tpu_torch.utils.config import Settings

    svc = ModelService(Settings(demo_tiny=True, warmup=False, device="cpu", vocoder_type="bigvgan"))
    svc.load()
    try:
        assert svc.engine.cfg.vocoder_type == "bigvgan" and svc.engine.cfg.mel.flavor == "bigvgan"
        body = svc.synthesize_sync(SpeechRequest(text="served through bigvgan.", nfe_step=2, seed=1))
        wave, sr = read_wav(body)
        assert body[:4] == b"RIFF" and sr == 24000 and len(wave) % 256 == 0 and np.isfinite(wave).all()
    finally:
        svc.unload()
