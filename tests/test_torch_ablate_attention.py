"""The port's attention-layout ablation against the JAX script on the CPU:
``ablate_attention_plain`` for each of the five layouts against
``scripts/ablate_attention.py``'s ``build(layout, interpret=True)`` call, same
inputs from numpy seeds, in fp32 and bf16, with a zero bias and with the last
quarter of the keys masked (-1e9); the layouts against ``unpacked``; and the
port's ``run`` entry point.

Tolerances: fp32 1e-5 (the conftest's ``highest`` matmul precision: only the
order of fp32 sums differs); bf16 1.6e-2, one bf16 ulp at |o| < 2 (an fp32 sum
in another order can round p or the output to the neighbouring bf16 value);
layouts against ``unpacked`` the JAX script's 0.05."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from f5tts_tpu_torch.ops.kernels import ablate_attention as ta
from f5tts_tpu_torch.scripts import ablate_attention as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BH, N, BQ = 4, 256, 128
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_ablate_attention", os.path.join(REPO, "scripts",
                                                                                        "ablate_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(dtype: str, tail_masked: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BH, N, 64)).astype(np.float32) for _ in range(3))
    bias = np.zeros((1, 1, N), np.float32)
    if tail_masked:
        bias[..., 3 * N // 4:] = -1e9
    tdt = getattr(torch, dtype)
    return (bias, q, k, v), [torch.from_numpy(bias)] + [torch.from_numpy(a).to(tdt) for a in (q, k, v)]


@pytest.mark.parametrize("tail_masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ta.LAYOUTS)
def test_plain_matches_the_jax_kernel(jax_script, monkeypatch, layout, dtype, tail_masked):
    for name, value in (("BH", BH), ("N", N), ("BQ", BQ)):  # build() reads them at call time
        monkeypatch.setattr(jax_script, name, value)
    (bias, q, k, v), tin = _inputs(dtype, tail_masked)
    jdt = getattr(jnp, dtype)
    ref = jax_script.build(layout, interpret=True)(jnp.asarray(bias), *(jnp.asarray(a, jdt) for a in (q, k, v)))
    out = ta.ablate_attention(layout, *tin)  # CPU tensors: the plain version
    assert out.dtype == tin[1].dtype and out.shape == (BH, N, 64)
    err = float(np.max(np.abs(out.float().numpy() - np.asarray(ref, np.float32))))
    assert err <= TOL[dtype], f"{layout} {dtype}: {err}"


@pytest.mark.parametrize("tail_masked", [False, True])
@pytest.mark.parametrize("layout", ta.PAIR_LAYOUTS)
def test_layouts_agree_with_unpacked(layout, tail_masked):
    _, tin = _inputs("bfloat16", tail_masked, seed=1)
    unpacked = ta.ablate_attention_plain("unpacked", *tin).float()
    assert float((ta.ablate_attention_plain(layout, *tin).float() - unpacked).abs().max()) < 0.05
    if tail_masked:  # the masked keys take no weight: the same as attending to the first 3/4 only
        cut = [tin[0][..., : 3 * N // 4]] + [t[:, : 3 * N // 4] for t in tin[2:]]
        short = ta.ablate_attention_plain(layout, cut[0], tin[1], *cut[1:]).float()
        assert float((ta.ablate_attention_plain(layout, *tin).float() - short).abs().max()) < 1.6e-2


def test_mma_per_call_counts_the_true_work_and_the_layouts_extra():
    true = 4 * 256 * 1024 * 1024 * 64 // (16 * 8 * 16 * 2)  # 4 BH N^2 D flops over an m16n8k16's
    got = {layout: ta.mma_per_call(layout, 256, 1024) for layout in ta.LAYOUTS}
    assert got == {"unpacked": true, "packed_blockdiag": 2 * true, "packed_sep_o": 3 * true // 2,
                   "sumdiff_blockdiag": 2 * true, "sumdiff_dense_cross": 2 * true}


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    _, tin = _inputs("bfloat16", False)
    before = ta.ablate_attention.launches
    assert torch.equal(ta.ablate_attention("sumdiff_dense_cross", *tin),
                       ta.ablate_attention_plain("sumdiff_dense_cross", *tin))
    assert ta.ablate_attention.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="layout"):
        ta.ablate_attention("packed", *tin)
    with pytest.raises(ValueError, match="cuda"):
        ta.ablate_attention("unpacked", *(t.to("meta") for t in tin))


def test_run_on_the_cpu_returns_five_finite_layout_rows():
    rows = ts.run(4, 128, 64, 2, 1, device="cpu")
    assert [r["name"] for r in rows] == [*ta.LAYOUTS, ts.LOW_OCCUPANCY, ts.SHIPPING, ts.SDPA]
    for r in rows[:5]:
        assert np.isfinite(r["ms"]) and r["ms"] > 0 and r["max_abs_diff"] < 0.05
        assert r["mma"] == ta.mma_per_call(r["name"], 4, 128) and r["warps_per_sm"] is None  # no card
    assert rows[0]["max_abs_diff"] == 0.0 and rows[5]["mma"] == rows[0]["mma"]
    assert all(r["mma"] is None and r["max_abs_diff"] < 0.05 for r in rows[6:])


def test_run_without_a_device_raises_when_no_gpu_is_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.run(4, 128, 64, 2, 1)
