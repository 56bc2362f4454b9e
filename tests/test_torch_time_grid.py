"""The port's knot-grid search (``f5tts_tpu_torch/scripts/optimize_time_grid.py``)
against ``scripts/optimize_time_grid.py`` on the CPU at ``--fields 10
--intervals 3 --sweeps 1 --prompts 2``: the JAX script's own toy-trained
field and noise go through the port's search, which must find the JAX
script's knots within 1e-4 (the search's acceptance margin: a flipped
decision is a finding, not a tolerance) and its ratios within 2e-4
(fp32 solves of the same field). ``optimize_time_grid_base``'s search runs
at the tiny geometry on the same field against the port's own grid search
with the base script's margin."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.sampling import euler as j_euler
from f5tts_tpu_torch.models.convert import params_from_numpy
from f5tts_tpu_torch.scripts import optimize_time_grid as to
from f5tts_tpu_torch.scripts import quality_harness as th

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import optimize_time_grid as jo  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Hundreds of tiny-geometry solves: one intra-op thread keeps them fast
    under a parallel test run (see ``test_torch_quality.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX script's run, its toy-trained field (recorded as it trains it)
    and its noise."""
    out = tmp_path_factory.mktemp("grid") / "j.json"
    fields = {}
    real = jo.toy_train
    argv = ["--fields", "10", "--intervals", "3", "--sweeps", "1", "--prompts", "2", "--out", str(out)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jo, "toy_train", lambda p, cfg, steps: fields.setdefault(steps, real(p, cfg, steps)))
        mp.setattr(sys, "argv", [jo.__file__, *argv])
        jo.main()
    prompts = th.build_prompts(th.TINY, 2, 128, 24)
    y0 = np.asarray(j_euler.sample_noise_from_seeds(jnp.asarray(prompts[4]), 128, 20, jnp.asarray(prompts[3])))
    field = params_from_numpy(jax.tree.map(np.asarray, fields[10]), "cpu")
    return json.loads(out.read_text())["results"]["3"], field, prompts, torch.as_tensor(y0)


def test_time_grid_search_finds_the_jax_scripts_knots(jax_run):
    want, field, prompts, y0 = jax_run
    got = to.search({10: field}, th.TINY, y0, prompts, [3], sweeps=1, log=None)[3]
    np.testing.assert_allclose(got["knots"], want["knots"], atol=1e-4)
    for key in ("worst_ratio", "sway_baseline_worst"):
        np.testing.assert_allclose(got[key], want[key], atol=2e-4, err_msg=key)
    assert got["nfe_per_branch"] == want["nfe_per_branch"] == 6


def test_base_search_runs_on_cached_solves(jax_run):
    """``search_base`` on the same field with given truth and recipe mels
    (here a 64-step and an 8-step Euler solve): a grid from 0 to 1, the
    evaluations counted (30 of the family, 4 moves, 1 for the report)."""
    from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm
    from f5tts_tpu_torch.scripts.optimize_time_grid_base import search_base

    _, field, prompts, y0 = jax_run
    kw = th.prompt_tensors(prompts, "cpu")
    truth, base = (sample_cfm(field, th.TINY, sampler=SamplerConfig(steps=n), y0=y0, **kw).numpy() for n in (64, 8))
    got = search_base({10: field}, {10: truth}, {10: base}, th.TINY, y0, prompts, [3], sweeps=1, log=None)[3]
    assert got["knots"][0] == 0.0 and got["knots"][-1] == 1.0 and np.all(np.diff(got["knots"]) > 0)
    assert got["evals"] == 30 + 4 + 1 and got["worst_ratio"] == max(got["per_field_ratio"].values())
