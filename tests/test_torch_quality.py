"""The port's certification metrics (``f5tts_tpu_torch/eval/quality.py``) and
its certification script (``f5tts_tpu_torch/scripts/distill_certify.py``)
against the JAX package and ``scripts/quality_harness.py`` on the CPU. The
metrics are host numpy copies: rtol 1e-6. The harness helpers' data is
bit-equal. ``distill_certify.run`` runs at a micro size."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from f5tts_tpu.eval import quality as jq
from f5tts_tpu_torch.eval import quality as tq
from f5tts_tpu_torch.scripts import distill_certify as dc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import quality_harness as jh  # noqa: E402

METRICS = ("mel_l2", "log_mel_mae", "mcd", "spectral_convergence")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run thousands of tiny torch ops; under a parallel test run
    the CPU is oversubscribed, and an intra-op thread pool that waits at every
    op for descheduled threads makes them ~100x slower. One thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, shape=(3, 40, 20)):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) - 2.0
    return a, a + 0.1 * rng.standard_normal(shape).astype(np.float32)


def _mask(shape=(3, 40)):
    m = np.zeros(shape, bool)
    m[0, 5:40], m[1, 12:30], m[2, 8:9] = True, True, True
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_metric_matches_jax(metric, masked):
    a, b = _pair()
    mask = _mask() if masked else None
    got, ref = getattr(tq, metric)(a, b, mask), getattr(jq, metric)(a, b, mask)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got > 0.0 and getattr(tq, metric)(a, a, mask) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_quality_report_matches_jax(masked):
    a, b = _pair(1)
    mask = _mask() if masked else None
    got, ref = tq.quality_report(a, b, mask), jq.quality_report(a, b, mask)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


def test_dct_basis_and_shape_check():
    for n_in, n_out in ((20, 14), (100, 14), (8, 8)):
        np.testing.assert_array_equal(tq._dct_matrix(n_in, n_out), jq._dct_matrix(n_in, n_out))
    with pytest.raises(ValueError, match="shape mismatch"):
        tq.mel_l2(np.zeros((2, 3, 4)), np.zeros((2, 3, 5)))


def test_harness_helpers_match_the_jax_harness():
    """The copied helpers build the same data and count the same forwards."""
    cfg = dc.TINY
    for name in ("base", "truth"):
        assert dc.CONFIGS[name].steps == jh.CONFIGS[name].steps
        assert dc.CONFIGS[name].cfg_strength == jh.CONFIGS[name].cfg_strength
    for field in ("dim", "depth", "heads", "dim_head", "ff_mult", "mel_dim", "text_num_embeds", "text_dim",
                  "conv_layers"):
        assert getattr(cfg, field) == getattr(jh.TINY, field), field
    for got, ref in zip(dc.build_prompts(cfg, 5, 128, 24), jh.build_prompts(jh.TINY, 5, 128, 24)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(dc.structured_toy_batch(np.random.default_rng(2), cfg, 3, 64),
                        jh.structured_toy_batch(np.random.default_rng(2), jh.TINY, 3, 64)):
        np.testing.assert_array_equal(got, ref)
    from f5tts_tpu_torch.sampling.euler import SamplerConfig

    for name, s in jh.CONFIGS.items():
        kw = {k: getattr(s, k) for k in ("steps", "cfg_strength", "sway_sampling_coef", "method", "cfg_null_reuse",
                                         "cfg_interval", "cfg_cache_period", "cfg_cache_mode")}
        assert dc.n_forwards(SamplerConfig(**kw)) == jh.n_forwards(s), name


def test_distill_certify_runs_at_a_micro_size(tmp_path):
    """The whole pipeline on the CPU: toy-train, the segmented 512-step truth,
    the recipe, a short distillation, three rows with finite errors, the JSON
    written, and the solve cache read back on a second run."""
    kw = dict(toy_train_steps=4, student_steps=2, substeps=1, distill_steps=2, distill_batch=2, prompts=2,
              bucket=32, cond_frames=8, device="cpu", solve_cache=str(tmp_path / "cache"), log=None)
    out = tmp_path / "d.json"
    res = dc.run(out=str(out), **kw)
    assert [r["name"] for r in res["rows"]] == ["recipe euler-32", "student K=2", "teacher euler@K (ablation)"]
    assert [r["forwards"] for r in res["rows"]] == [64, 2, 4]
    assert all(np.isfinite(r["mel_l2"]) and np.isfinite(r["mcd_db"]) for r in res["rows"])
    assert res["rows"][0]["x_recipe_err"] == 1.0 and res["rows"][0]["certified"]
    assert json.loads(out.read_text())["rows"] == res["rows"]
    assert {p.name for p in (tmp_path / "cache").iterdir()} == {"teacher.npz", "truth.npy", "recipe.npy"}
    again = dc.run(**kw)  # the teacher and both reference solves come from the cache
    assert again["recipe_err"] == res["recipe_err"]
