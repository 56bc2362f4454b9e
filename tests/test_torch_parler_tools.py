"""The port's Parler probes (``f5tts_tpu_torch/scripts/{parler_roofline,
parler_step_probe}.py``) against the JAX package on the CPU.

- parler_roofline at the tiny Parler configs of ``test_torch_parler.py``,
  fp32: the T5 encode equals JAX ``t5_encode`` (atol 1e-4), the greedy codes
  equal JAX ``parler_generate`` greedy on the same trees and states; the JAX
  script's ``main`` run at the same configs with the card's bandwidth gives
  rows whose every key ``roofline_row`` reproduces from the same seconds.
- parler_step_probe, fp32 at a tiny width: the weights are the JAX script's
  draws (order and shapes); every variant's hidden state after S steps
  equals ``unrolled``'s (``noattn`` excepted; ``shortcache`` as S < 256),
  atol 1e-6; ``kernelattn``'s attention on the CPU is the plain version and
  equals the JAX Pallas ``decode_attention`` in interpret mode on the same
  cache (atol 1e-5); the bound's byte counts are the JAX script's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import parler as JP
from f5tts_tpu.ops.pallas import decode_attention as j_dec
from f5tts_tpu_torch.models.convert import (init_dac_numpy, init_parler_decoder_numpy, init_t5_numpy,
                                            parler_params_from_numpy)
from f5tts_tpu_torch.ops.kernels import decode_attention as t_dec
from f5tts_tpu_torch.scripts import parler_roofline as pr
from f5tts_tpu_torch.scripts import parler_step_probe as psp
from f5tts_tpu_torch.utils.timing import PEAK_BYTES

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfgs():
    t5, dec, dac = pr.TINY
    fields = lambda c: {k: getattr(c, k) for k in c.__dataclass_fields__}  # noqa: E731
    return (JP.T5Config(**fields(t5)), JP.ParlerDecoderConfig(**{k: v for k, v in fields(dec).items()
                                                                   if k not in ("fuse_decode_qkv", "decode_attn")}),
            JP.DacConfig(**fields(dac)))


# ---------------------------------------------------------------------------
# parler_roofline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def roofline_trees():
    t5_cfg, dec_cfg, dac_cfg = pr.TINY
    numpy = init_t5_numpy(t5_cfg, seed=0), init_parler_decoder_numpy(dec_cfg, seed=1), init_dac_numpy(dac_cfg, seed=2)
    return numpy, parler_params_from_numpy(*numpy, "cpu", torch.float32)


def test_roofline_encode_and_greedy_codes_match_jax(roofline_trees):
    numpy, trees = roofline_trees
    (t5_cfg, dec_cfg, dac_cfg), (jt5, jdec, _) = pr.TINY, _jax_cfgs()
    inputs = pr.make_inputs(3, t5_cfg, dec_cfg, np.random.default_rng(0))
    enc = pr.encode(trees[0], t5_cfg, inputs, torch.float32)
    jx = {k: jnp.asarray(v.numpy()) for k, v in inputs.items() if k != "seeds"}
    want_enc = JP.t5_encode(jax.tree.map(jnp.asarray, numpy[0]), jt5, jx["ids"], jx["mask"])
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), atol=1e-4)
    frames = 9
    codes = pr.decode(trees[1], dec_cfg, dac_cfg, enc, inputs, frames, 0.0, torch.float32)
    want, _ = JP.parler_generate(jax.tree.map(jnp.asarray, numpy[1]), jdec, jnp.asarray(enc.numpy()), jx["mask"],
                                 frames, jax.random.PRNGKey(0), prompt_ids=jx["prompt"], prompt_mask=jx["pmask"],
                                 eos_token=-1, temperature=0.0, top_k=0, max_code=dac_cfg.codebook_size)
    assert codes.shape == (3, dec_cfg.codebooks, frames)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    sampled = pr.decode(trees[1], dec_cfg, dac_cfg, enc, inputs, frames, 1.0, torch.float32)
    assert sampled.shape == codes.shape and not torch.equal(sampled, codes)


def test_roofline_rows_follow_the_jax_formula_at_the_card_bandwidth(roofline_trees, monkeypatch, tmp_path):
    """The JAX script's ``main`` at the tiny configs with ``HBM_BW`` set to the
    card's: each of its rows' derived keys equals ``roofline_row`` on the same
    seconds, and its weight bytes equal the port's count."""
    numpy, trees = roofline_trees
    jt5, jdec, jdac = _jax_cfgs()
    monkeypatch.syspath_prepend(SCRIPTS)
    import f5tts_tpu.utils.cache as j_cache
    import parler_roofline as j_roof

    monkeypatch.setattr(j_cache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(j_roof, "HBM_BW", PEAK_BYTES)
    for name, cfg in (("T5Config", jt5), ("ParlerDecoderConfig", jdec), ("DacConfig", jdac)):
        monkeypatch.setattr(JP, name, lambda cfg=cfg: cfg)
    out = tmp_path / "roof.json"
    j_roof.main(["--frames", "6", "--batches", "2", "--iters", "1", "--depth-knockout", "--out", str(out)])
    ref = json.loads(out.read_text())
    dec_cfg, dac_cfg = pr.TINY[1], pr.TINY[2]
    assert ref["dec_param_bytes"] == pr.param_bytes(numpy[1]) == pr.param_bytes(trees[1])
    assert ref["steps"] == 6 + dec_cfg.codebooks - 1
    for row in ref["rows"]:
        times = {"t5": row["t5_ms"] / 1e3, "decode": row["decode_ms"] / 1e3, "dac": row["dac_ms"] / 1e3,
                 "decode_greedy": row["decode_greedy_ms"] / 1e3, "decode_half": row["decode_half_frames_ms"] / 1e3,
                 "decode_half_depth": row["decode_half_depth_ms"] / 1e3}
        got = pr.roofline_row(row["batch"], 6, ref["steps"], dec_cfg, ref["dec_param_bytes"],
                              dac_cfg.sampling_rate / dac_cfg.hop, times)
        assert list(got) == list(row)
        for k in row:
            assert got[k] == pytest.approx(row[k], rel=1e-12), k
    sys.modules.pop("parler_roofline", None)


def test_roofline_run_on_the_cpu_gives_every_row_key(roofline_trees):
    _, trees = roofline_trees
    out = pr.run(trees, pr.TINY, [2], frames=4, iters=1, depth_knockout=True, device="cpu", dtype=torch.float32,
                 log=lambda *_: None)
    (row,) = out["rows"]
    assert set(row) == {"batch", "t5_ms", "decode_ms", "dac_ms", "decode_greedy_ms", "decode_half_frames_ms",
                        "decode_half_depth_ms", "step_us", "step_bound_us", "bw_efficiency",
                        "audio_s_per_s_decode_only", "audio_s_per_s_pipeline", "pct_t5", "pct_decode", "pct_dac"}
    assert all(np.isfinite(v) and v > 0 for v in row.values())
    assert row["pct_t5"] + row["pct_decode"] + row["pct_dac"] == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# parler_step_probe
# ---------------------------------------------------------------------------

GEOM = dict(batch=2, layers=2, hidden=128, ffn=256, heads=4, total=40, enc_len=8, steps=6)


@pytest.fixture(scope="module")
def probe():
    return psp.StepProbe(**GEOM, dtype=torch.float32, device="cpu")


def test_step_probe_weights_are_the_jax_scripts_draws(probe):
    L, H, F, NH, b = GEOM["layers"], GEOM["hidden"], GEOM["ffn"], GEOM["heads"], GEOM["batch"]
    rng = np.random.default_rng(0)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    want = {"wq": w(L, H, H), "wk": w(L, H, H), "wv": w(L, H, H), "wo": w(L, H, H), "cq": w(L, H, H),
            "co": w(L, H, H), "f1": w(L, H, F), "f2": w(L, F, H)}  # scripts/parler_step_probe.py:66-84
    for k, v in want.items():
        np.testing.assert_array_equal(probe.params[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(probe.ca_k.numpy(), w(L, b, NH, GEOM["enc_len"], H // NH))
    np.testing.assert_array_equal(probe.ca_v.numpy(), w(L, b, NH, GEOM["enc_len"], H // NH))
    np.testing.assert_array_equal(probe.x0.numpy(), w(b, 1, H))


@pytest.fixture(scope="module")
def hidden_states(probe):
    return {name: probe.variant(name)() for name in psp.VARIANTS}


@pytest.mark.parametrize("variant", [v for v in psp.VARIANTS if v != "unrolled"])
def test_step_probe_variant_matches_unrolled(hidden_states, variant):
    got, want = hidden_states[variant], hidden_states["unrolled"]
    assert got.shape == (GEOM["batch"], 1, GEOM["hidden"]) and torch.isfinite(got).all()
    if variant == "noattn":
        assert float((got - want).abs().max()) > 1e-2  # the self-attention matters
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_step_probe_kernel_attention_equals_the_pallas_kernel(probe, hidden_states):
    """``kernelattn``'s caches after S steps: its attention call (the plain
    version on the CPU) against the JAX kernel in interpret mode, K
    transposed and both caches padded to 128 positions as that kernel wants."""
    probe.variant("kernelattn")()
    ck, cv = probe.caches["unrolled"][1]
    b, NH, D = GEOM["batch"], GEOM["heads"], GEOM["hidden"] // GEOM["heads"]
    q = torch.as_tensor(np.random.default_rng(9).standard_normal((b, NH, 1, D)).astype(np.float32)) * D**-0.5
    bias = probe.biases(GEOM["total"])[GEOM["steps"] - 1]
    before = t_dec.decode_attention.launches
    got = probe.attend_kernel(q, ck, cv, bias).view(b, NH, 1, D)
    assert t_dec.decode_attention.launches == before  # CPU tensors: the plain version, no launch
    torch.testing.assert_close(got, t_dec.decode_attention_plain(q, ck, cv, bias), rtol=0, atol=0)
    total = GEOM["total"]
    pad = -(-total // 128) * 128 - total
    k, v = ck.numpy(), cv.numpy()
    want = j_dec.decode_attention(
        jnp.asarray(q.numpy()), jnp.asarray(np.pad(k, ((0, 0), (0, 0), (0, pad), (0, 0))).transpose(0, 1, 3, 2)),
        jnp.asarray(np.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0)))),
        jnp.asarray(np.pad(bias.numpy(), ((0, 0), (0, pad)), constant_values=-1e9)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(ck[:, :, GEOM["steps"]:].abs().max()) == 0.0 and float(ck[:, :, :GEOM["steps"]].abs().min()) > 0


def test_step_probe_bounds_count_the_jax_scripts_bytes(probe):
    L, H, F, NH, b = GEOM["layers"], GEOM["hidden"], GEOM["ffn"], GEOM["heads"], GEOM["batch"]
    D = H // NH
    assert probe.w_bytes() == 2 * L * (4 * H * H + 2 * H * H + 2 * H * F)  # scripts/parler_step_probe.py:270
    for name in psp.VARIANTS:
        tot = 256 if name == "shortcache" else GEOM["total"]  # the port's caches are unpadded
        assert probe.cache_bytes(name) == (0 if name == "noattn" else 2 * L * 2 * b * NH * tot * D), name
    out = psp.run(probe, iters=1, log=lambda *_: None)
    assert [r["variant"] for r in out["rows"]] == list(psp.VARIANTS)
    for r in out["rows"]:
        assert {"variant", "step_us", "bound_us", "bw_eff"} <= set(r) and "graph_step_us" not in r  # no graph on CPU
        assert r["bound_us"] == pytest.approx((out["w_bytes_per_step"] + probe.cache_bytes(r["variant"]))
                                              / PEAK_BYTES * 1e6)
