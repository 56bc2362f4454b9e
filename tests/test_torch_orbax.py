"""The port reads the JAX ``Trainer``'s orbax checkpoint directories
(``f5tts_tpu_torch/models/convert.py:load_trained_checkpoint``, tensorstore
alone) leaf for leaf as the JAX package's ``load_trained_checkpoint``
restores them: the EMA and the raw params, the newest step and an explicit
one, at a tiny DiT and a tiny UNetT geometry, bf16 leaves widened to fp32;
``cli/convert.py`` on such a directory writes the JAX converter's ``.npz``.
Equality is exact (the same stored arrays)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from f5tts_tpu.models import convert as j_convert
from f5tts_tpu.models.cfm import CFMConfig
from f5tts_tpu.models.dit import DiTConfig
from f5tts_tpu.models.unett import UNetTConfig
from f5tts_tpu.train.checkpoint import save_state
from f5tts_tpu.train.trainer import TrainConfig, init_train_state
from f5tts_tpu_torch.models import convert as t_convert

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "vocab.txt")
N_VOCAB = sum(1 for _ in open(VOCAB, encoding="utf-8"))
GEOMETRIES = {
    "dit": DiTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=8, text_num_embeds=N_VOCAB,
                     text_dim=16, conv_layers=1),
    "unett": UNetTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=8, text_num_embeds=N_VOCAB,
                         text_dim=16, conv_layers=1),
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: None if tree is None else np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == w.dtype == np.float32, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def trained(request, tmp_path_factory):
    """A JAX ``Trainer`` directory with steps 3 and 7, written by the JAX
    saver: each step's params and EMA differ, and step 7's EMA holds a bf16
    leaf (a bf16-trained EMA)."""
    cfg = GEOMETRIES[request.param]
    state = init_train_state(jax.random.PRNGKey(0), CFMConfig(model=cfg), TrainConfig())
    directory = str(tmp_path_factory.mktemp(f"orbax_{request.param}"))
    for step, scale in ((3, 0.5), (7, 0.25)):
        ema = jax.tree.map(lambda x, s=scale: x * s + s, state["params"])
        ema["time_embed"]["mlp1"]["w"] = ema["time_embed"]["mlp1"]["w"].astype(jnp.bfloat16)
        params = jax.tree.map(lambda x, s=scale: x - s, state["params"])
        save_state(directory, step, {**state, "params": params, "ema": ema, "step": jnp.int32(step)})
    return request.param, cfg, directory


@pytest.mark.parametrize("use_ema", [True, False])
@pytest.mark.parametrize("step", [None, 3])
def test_orbax_directory_reads_back_as_jax_restores_it(trained, use_ema, step):
    _, cfg, directory = trained
    want = j_convert.load_trained_checkpoint(directory, cfg, use_ema=use_ema, step=step)
    got = t_convert.load_trained_checkpoint(directory, use_ema=use_ema, step=step)
    _assert_trees_equal(got, want)


def test_the_read_imports_no_jax(trained):
    """In a fresh interpreter: the read needs tensorstore, never JAX or orbax."""
    _, _, directory = trained
    code = ("import sys; from f5tts_tpu_torch.models.convert import load_trained_checkpoint; "
            f"tree = load_trained_checkpoint({directory!r}); "
            "assert tree['proj_out']['w'].dtype.name == 'float32'; "
            "assert not {'jax', 'orbax'} & {m.split('.')[0] for m in sys.modules}, 'imported JAX'")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, timeout=120,
                   env={**os.environ, "PYTHONPATH": repo})


def test_checkpoint_loaders_take_the_directory(trained):
    kind, cfg, directory = trained
    load = t_convert.load_f5_checkpoint if kind == "dit" else t_convert.load_e2_checkpoint
    _assert_trees_equal(load(directory, None), j_convert.load_trained_checkpoint(directory, cfg))


@pytest.mark.parametrize("raw", [False, True])
def test_convert_cli_writes_the_jax_converters_npz(trained, tmp_path, monkeypatch, raw):
    """Both CLIs on the directory; the JAX one builds its restore template
    from the registry name's config, here patched to the tiny geometry."""
    from f5tts_tpu.cli import convert as j_cli
    from f5tts_tpu_torch.cli import convert as t_cli

    kind, cfg, directory = trained
    model = "F5TTS_Base" if kind == "dit" else "E2TTS_Base"
    monkeypatch.setattr(type(cfg), "base", staticmethod(lambda: cfg))
    flags = ["--raw-weights"] if raw else []
    j_cli.main(["--ckpt", directory, "--model", model, "--vocab", VOCAB, "--out", str(tmp_path / "j.npz"), *flags])
    t_cli.main(["--ckpt", directory, "--model", model, "--vocab", VOCAB, "--out", str(tmp_path / "t.npz"), *flags])
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_missing_directory_or_step_raises_file_not_found(trained, tmp_path):
    _, cfg, directory = trained
    for args in ((str(tmp_path / "nowhere"),), (str(tmp_path),), (directory, True, 5)):
        with pytest.raises(FileNotFoundError):
            t_convert.load_trained_checkpoint(*args)
    for args in ((str(tmp_path / "nowhere"), cfg), (str(tmp_path), cfg)):
        with pytest.raises(FileNotFoundError):
            j_convert.load_trained_checkpoint(*args)
