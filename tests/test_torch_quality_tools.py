"""The port's quality and time-grid tools (``f5tts_tpu_torch/scripts/``:
``quality_harness``, ``calibrate_escalation``, ``optimize_time_grid``,
``count_params_flops``, ``count_max_epoch``, ``make_toy_dataset``) against
the JAX scripts under ``scripts/`` on the CPU.

- The harness's and the calibration's reports from one pre-filled solve
  cache equal the JAX scripts' (the arithmetic is numpy on the same arrays).
- One tiny-geometry solve through the harness's solver, whole and in
  segments, on the JAX params and noise: fp32 atol/rtol 1e-4 (the sampler
  tests' tolerance) against the JAX ``sample_cfm``.
- The time-grid search: ``test_torch_time_grid.py``.
- The counts, the epoch table and the toy dataset's files are equal.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models.dit import init_dit
from f5tts_tpu.sampling import euler as j_euler
from f5tts_tpu_torch.models.convert import params_from_numpy
from f5tts_tpu_torch.scripts import calibrate_escalation as tc
from f5tts_tpu_torch.scripts import count_max_epoch as tcm
from f5tts_tpu_torch.scripts import count_params_flops as tcp
from f5tts_tpu_torch.scripts import make_toy_dataset as tmt
from f5tts_tpu_torch.scripts import quality_harness as th

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)
import calibrate_escalation as jc  # noqa: E402
import count_params_flops as jcp  # noqa: E402
import make_toy_dataset as jmt  # noqa: E402
import quality_harness as jh  # noqa: E402

SAMPLER_FIELDS = ("steps", "cfg_strength", "sway_sampling_coef", "method", "cfg_null_reuse", "time_grid",
                  "cfg_interval", "cfg_cache_period", "cfg_cache_mode")
DIT_FIELDS = ("dim", "depth", "heads", "dim_head", "ff_mult", "mel_dim", "text_num_embeds", "text_dim", "conv_layers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solves run thousands of tiny torch ops: one intra-op thread keeps
    them fast under a parallel test run (see ``test_torch_quality.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()


def test_configs_forwards_and_prompts_match_the_jax_harness():
    assert list(th.CONFIGS) == list(jh.CONFIGS)
    for name, s in jh.CONFIGS.items():
        for field in SAMPLER_FIELDS:
            assert getattr(th.CONFIGS[name], field) == getattr(s, field), (name, field)
        assert th.n_forwards(th.CONFIGS[name]) == jh.n_forwards(s), name
    for field in DIT_FIELDS:
        assert getattr(th.TINY, field) == getattr(jh.TINY, field), field
    for k, bucket, cond in ((1, 64, 8), (6, 128, 24), (4, 1024, 128)):
        for got, ref in zip(th.build_prompts(th.TINY, k, bucket, cond), jh.build_prompts(jh.TINY, k, bucket, cond)):
            np.testing.assert_array_equal(got, ref)


def _prompts(k=3):
    return th.build_prompts(th.TINY, k, 128, 24)


@pytest.mark.parametrize("with_truth", [True, False])
def test_harness_report_equals_the_jax_scripts_on_one_solve_cache(tmp_path, monkeypatch, with_truth):
    names = ["base", "anchor64", "mid8", "ralston8"] + (["truth"] if with_truth else [])
    cache = tmp_path / "cache"
    cache.mkdir()
    rng = np.random.default_rng(0)
    truth = rng.standard_normal((3, 128, 20)).astype(np.float32)
    for i, name in enumerate(names):  # each config a little further from the truth
        np.save(cache / f"{name}.npy", truth + (0.02 * (i + 1)) * rng.standard_normal(truth.shape).astype(np.float32))
    common = ["--geometry", "tiny", "--prompts", "3", "--configs", ",".join(names[1:]), "--solve-cache", str(cache)]
    _jax_main(jh, [*common, "--out", str(tmp_path / "j.json")], monkeypatch)
    got = th.main([*common, "--out", str(tmp_path / "t.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == want == json.loads(json.dumps(got))
    assert [r["name"] for r in want["rows"]] == names
    assert ("certified" in want["rows"][2]) == with_truth


def test_calibration_report_equals_the_jax_script_on_one_solve_cache(tmp_path, monkeypatch):
    """The JAX script toy-trains every field before it looks in the cache;
    with every solve cached the field is never used, so its toy-train is
    patched out (the port trains a field only for a missing solve)."""
    cache = tmp_path / "cache"
    cache.mkdir()
    rng = np.random.default_rng(1)
    for depth in (2, 3):
        truth = rng.standard_normal((3, 128, 20)).astype(np.float32)
        for i, tag in enumerate(("truth", "recipe", "default")):
            est = np.abs(rng.standard_normal(3)).astype(np.float32) if tag == "default" else np.zeros(1)
            mel = truth + np.float32(0.03 * i * depth) * rng.standard_normal(truth.shape).astype(np.float32)
            np.savez(cache / f"f{depth}_{tag}.npz", mel=mel, est=est)
    monkeypatch.setattr(jc, "toy_train", lambda params, cfg, steps: params)
    common = ["--fields", "2,3", "--prompts", "3", "--solve-cache", str(cache)]
    _jax_main(jc, [*common, "--out", str(tmp_path / "j.json")], monkeypatch)
    got = tc.main([*common, "--out", str(tmp_path / "t.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == want == json.loads(json.dumps(got))
    assert [r["field"] for r in want["rows"]] == [2, 3]


@pytest.fixture(scope="module")
def jax_field():
    """The JAX harness's random init at its tiny geometry and its noise."""
    params = jax.tree.map(np.asarray, init_dit(jax.random.PRNGKey(0), jh.TINY))
    prompts = _prompts()
    y0 = np.asarray(j_euler.sample_noise_from_seeds(jnp.asarray(prompts[4]), 128, 20, jnp.asarray(prompts[3])))
    return params, prompts, y0


@pytest.mark.parametrize("segment_steps", ["64", "3"])
def test_harness_solve_matches_jax_sample_cfm(jax_field, monkeypatch, segment_steps):
    """``QH_SEGMENT_STEPS=3`` runs the 8-step solve as knots 0..3, 3..6, 6..8
    (``knot_range`` / ``paste_back``)."""
    params, prompts, y0 = jax_field
    monkeypatch.setenv("QH_SEGMENT_STEPS", segment_steps)
    cond, lens, text, durations, _ = prompts
    ref = j_euler.sample_cfm(params, jh.TINY, cond=jnp.asarray(cond), cond_lens=jnp.asarray(lens),
                             text=jnp.asarray(text), duration=jnp.asarray(durations), sampler=jh.CONFIGS["ralston8"],
                             y0=jnp.asarray(y0))
    solve = th.make_solver(params_from_numpy(params, "cpu"), th.TINY, prompts, torch.as_tensor(y0), torch.float32,
                           log=None)
    np.testing.assert_allclose(solve(th.CONFIGS["ralston8"]), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_make_toy_dataset_writes_the_jax_scripts_files(tmp_path, monkeypatch):
    from f5tts_tpu_torch.train.data import FramePackedDataset

    for seed in ("0", "3"):
        j_dir, t_dir = tmp_path / f"j{seed}", tmp_path / f"t{seed}"
        _jax_main(jmt, ["--out", str(j_dir), "--items", "5", "--n-mels", "12", "--seed", seed], monkeypatch)
        tmt.main(["--out", str(t_dir), "--items", "5", "--n-mels", "12", "--seed", seed])
        assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
        for name in os.listdir(j_dir):
            assert (t_dir / name).read_bytes() == (j_dir / name).read_bytes(), name
    ds = FramePackedDataset.from_dir(str(t_dir))
    assert len(ds.items) == 5


@pytest.mark.parametrize("argv", [[], ["--dataset-hours", "1000", "--frames-per-update", "38400",
                                       "--total-updates", "5000"]])
def test_count_max_epoch_prints_the_jax_scripts_table(capsys, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["count_max_epoch.py", *argv])
    runpy.run_path(os.path.join(SCRIPTS, "count_max_epoch.py"), run_name="__main__")
    want = capsys.readouterr().out
    tcm.main(argv)
    assert capsys.readouterr().out == want and want.count("\n") == 3


def test_count_params_flops_prints_the_jax_scripts_counts(capsys, monkeypatch):
    """The JAX script counts ``jax.eval_shape`` trees; the port counts its
    shape-only trees (nothing drawn)."""
    argv = ["--seconds", "12"]
    _jax_main(jcp, argv, monkeypatch)
    want = capsys.readouterr().out
    tcp.main(argv)
    assert capsys.readouterr().out == want and want.count("params") == 4
    assert all(isinstance(n, int) and n > 0 for _, _, n in tcp.counts())
