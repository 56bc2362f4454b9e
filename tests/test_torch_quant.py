"""The port's int8 (W8A8) serving path against the JAX package on the CPU, same
inputs from numpy seeds: ``quant_matmul_plain`` against the Pallas kernel in
interpret mode and its XLA fallback, ``_linear_int8`` / ``quantize_linear_params``
/ ``quantize_dit_params`` against ``f5tts_tpu/models``, the two floor
conventions, the quantized tiny-DiT forward and an int8 ``TTSEngine``.

Tolerances: one linear agrees to rtol 1e-6 in fp32 (the same correctly rounded
operations in the same order; the integer product is exact). Through several
layers a 1e-6 difference upstream can move one ``rint`` to the next int8 step,
so the DiT forward and the engine are held by relative L2 instead."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.engine import engine as j_engine
from f5tts_tpu.models import dit as jd
from f5tts_tpu.models import modules as jm
from f5tts_tpu.models import vocos as jv
from f5tts_tpu.ops.mel import MelConfig as JMelConfig
from f5tts_tpu.ops.pallas.quant_matmul import quant_matmul as j_quant_matmul
from f5tts_tpu.sampling import euler as je
from f5tts_tpu.text.tokenizer import Tokenizer as JTokenizer
from f5tts_tpu_torch.engine import engine as t_engine
from f5tts_tpu_torch.models import convert as t_convert
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models import vocos as tv
from f5tts_tpu_torch.ops.kernels import quant_matmul as tq
from f5tts_tpu_torch.ops.mel import MelConfig as TMelConfig
from f5tts_tpu_torch.sampling import euler as te
from f5tts_tpu_torch.text.tokenizer import Tokenizer as TTokenizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=95, text_dim=32,
            conv_layers=1, max_pos=1024)
VOC = dict(input_channels=20, dim=48, intermediate_dim=96, num_layers=2)
VOCAB = {" ": 0, **{chr(i): i - 31 for i in range(33, 127)}}
QUANTIZED = [("attn", n) for n in ("to_q", "to_k", "to_v", "to_out")] + [("ff", "in"), ("ff", "out")]


def _quantized_weight(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32)
    sw = (np.abs(w).max(0) / 127.0).astype(np.float32)
    return np.clip(np.round(w / sw), -127, 127).astype(np.int8), sw


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / np.linalg.norm(b))


# (M, K, N, block_m, block_n): the shapes of tests/test_quant_matmul.py (the
# Pallas kernel in interpret mode, then the odd shape that takes its XLA
# fallback) and one where K = 2048 lets sums pass 2^24
@pytest.mark.parametrize("m,k,n,block_m,block_n", [(256, 128, 256, 128, 128), (100, 64, 96, 512, 1024),
                                                   (64, 2048, 128, 64, 128)])
def test_quant_matmul_plain_matches_the_pallas_kernel(m, k, n, block_m, block_n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, sw = _quantized_weight(rng, k, n)
    ref = np.asarray(j_quant_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw), block_m=block_m,
                                    block_n=block_n, interpret=True))
    out = tq.quant_matmul(torch.as_tensor(x), torch.as_tensor(wq), torch.as_tensor(sw))  # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    dense = x @ (wq.astype(np.float32) * sw)
    assert _rel_l2(out.numpy(), dense) < 0.02


def test_quant_matmul_plain_accumulates_exactly_past_2_to_24():
    """Rows of +-max against columns of +-127 at K = 2048: every product is
    127 * 127 and the sum 33 032 192 > 2^24 is odd-stepped, so an fp32
    accumulation would round it; the plain version must not."""
    k, n = 2048, 16
    x = np.ones((2, k), np.float32)
    x[1, 1::2] = -1.0
    x[1, 0] = 1.0
    wq = np.full((k, n), 127, np.int8)
    wq[3, :] = 126  # makes the exact sums odd: not representable steps of an fp32 running sum
    sw = np.ones((n,), np.float32)
    out = tq.quant_matmul_plain(torch.as_tensor(x), torch.as_tensor(wq), torch.as_tensor(sw)).numpy()
    exact = (np.round(x / (np.abs(x).max(-1, keepdims=True) / 127.0)).astype(np.int64) @ wq.astype(np.int64))
    sx = (np.float32(1.0) / np.float32(127.0)).astype(np.float32)
    want = (exact.astype(np.float32) * sx) * sw
    assert int(exact[0, 0]) == 127 * 127 * 2047 + 127 * 126 and int(exact[0, 0]) > 2**24
    np.testing.assert_array_equal(out, want)


def test_quant_matmul_bf16_input():
    """bf16 activations: the same fp32 arithmetic on the upcast values, one
    rounding to bf16 at the end. With bf16 inputs ``x / sx`` hits exact .5 ties
    (x = ax / 2 gives 63.5), so the last bit of ``sx`` decides an int8 step.
    Run op by op (``jax.disable_jit``, the wrapper's XLA path), JAX divides by
    127 as the port does and the results are equal. Under ``jit`` XLA rewrites
    ``/ 127.0`` as a multiply by the reciprocal, ``sx`` moves by one ulp in a
    few rows and a tie in such a row rounds the other way (ROADMAP, section C):
    there the results agree up to those rows' int8 steps."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    wq, sw = _quantized_weight(rng, 128, 128)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    out = tq.quant_matmul(torch.as_tensor(x).bfloat16(), torch.as_tensor(wq), torch.as_tensor(sw))
    assert out.dtype == torch.bfloat16
    with jax.disable_jit():  # block_m 48 does not divide 64: the wrapper's plain XLA path, op by op
        ref = j_quant_matmul(xb, jnp.asarray(wq), jnp.asarray(sw), block_m=48, block_n=128, interpret=True)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    jitted = np.asarray(j_quant_matmul(xb, jnp.asarray(wq), jnp.asarray(sw), block_m=64, block_n=128,
                                       interpret=True).astype(jnp.float32))
    rows = np.unique(np.argwhere(out.float().numpy() != jitted)[:, 0])
    assert len(rows) <= 3 and _rel_l2(out.float().numpy(), jitted) < 2e-3


def _floor_rows(k=64):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, k)).astype(np.float32)
    x[1] = 0.0  # an all-padding row
    x[2] = (1e-7 * np.sign(x[2])).astype(np.float32)  # abs-max 1e-7: under both floors' crossover at 1.27e-6
    x[2, 0] = 0.8e-7
    return x


def test_the_two_floors_follow_their_jax_counterparts():
    """``quant_matmul`` floors the abs-max at 1e-6 (the Pallas kernel),
    ``_linear_int8`` floors the scale at 1e-8 (``modules.py``): a zero row is 0
    under both; a row of 1e-7 quantizes to 13s under the first (1e-7 * 127 /
    1e-6 = 12.7) and to 10s under the second (1e-7 / 1e-8), so the results
    differ, and each equals its JAX counterpart."""
    x = _floor_rows()
    rng = np.random.default_rng(3)
    wq, sw = _quantized_weight(rng, 64, 32)
    tx, twq, tsw = torch.as_tensor(x), torch.as_tensor(wq), torch.as_tensor(sw)
    kernel_ref = np.asarray(j_quant_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw), interpret=True))
    linear_ref = np.asarray(jm._linear_int8({"w_q": jnp.asarray(wq), "s_w": jnp.asarray(sw)}, jnp.asarray(x)))
    kernel_out = tq.quant_matmul(tx, twq, tsw).numpy()
    linear_out = tm._linear_int8({"w_q": twq, "s_w": tsw}, tx).numpy()
    np.testing.assert_allclose(kernel_out, kernel_ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(linear_out, linear_ref, rtol=1e-6, atol=0)
    assert not kernel_out[1].any() and not linear_out[1].any()
    assert np.abs(kernel_out[2]).max() > 0 and np.abs(linear_out[2]).max() > 0
    assert _rel_l2(kernel_out[2], linear_out[2]) > 1e-3  # 13 against 10 (and 10 against 8): not the same row
    np.testing.assert_allclose(kernel_out[[0, 3]], linear_out[[0, 3]], rtol=1e-6)  # ordinary rows: one formula
    # the quantized integers themselves
    acc13 = tq.quant_matmul_plain(tx[2:3], torch.eye(64, dtype=torch.int8), torch.ones(64), amax_floor=1e-6)
    acc10 = tq.quant_matmul_plain(tx[2:3], torch.eye(64, dtype=torch.int8), torch.ones(64), amax_floor=0.0,
                                  scale_floor=1e-8)
    sx13, sx10 = np.float32(1e-6) / np.float32(127.0), np.float32(1e-8)
    assert sorted(set(np.abs(np.round(acc13.numpy() / sx13)).astype(int).ravel())) == [10, 13]
    assert sorted(set(np.abs(np.round(acc10.numpy() / sx10)).astype(int).ravel())) == [8, 10]


def test_linear_int8_and_quantize_linear_params_match_jax():
    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((256, 512)).astype(np.float32) * 0.05,
         "b": rng.standard_normal((512,)).astype(np.float32)}
    p["w"][:, 7] = 0.0  # an all-zero output channel: its scale takes the 1e-8 floor
    x = rng.standard_normal((4, 33, 256)).astype(np.float32)
    jq = jm.quantize_linear_params({k: jnp.asarray(v) for k, v in p.items()})
    tq_ = tm.quantize_linear_params({k: torch.as_tensor(v) for k, v in p.items()})
    assert set(tq_) == set(jq) == {"w_q", "s_w", "b"}  # on the CPU the tree is the JAX tree
    assert tq_["w_q"].dtype == torch.int8 and tq_["s_w"].dtype == torch.float32
    np.testing.assert_array_equal(tq_["w_q"].numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_allclose(tq_["s_w"].numpy(), np.asarray(jq["s_w"]), rtol=1e-7)
    assert float(tq_["s_w"][7]) == pytest.approx(1e-8 / 127.0)
    ref = np.asarray(jm.linear(jq, jnp.asarray(x)))
    out = tm.linear(tq_, torch.as_tensor(x))
    assert out.shape == (4, 33, 512)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    fp = x @ p["w"] + p["b"]
    assert _rel_l2(out.numpy(), fp) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_int8_with_bias_matches_jax_and_the_separate_add(dtype):
    """The bias goes into ``quant_matmul`` (one kernel launch on the card):
    ``quant_matmul_plain(..., b=)`` equals the plain product followed by the
    separate add bit for bit, and ``_linear_int8`` with a bias matches the JAX
    ``_linear_int8``: to rtol 1e-6 in fp32; in bf16 (x and b in bf16, as the
    engine serves them) equal op by op, and under ``jit`` up to the rows where
    XLA's reciprocal ``/ 127.0`` moves a tie (ROADMAP, section C)."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((256, 384)).astype(np.float32) * 0.05
    b = rng.standard_normal((384,)).astype(np.float32)
    x = rng.standard_normal((3, 40, 256)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jq = jm.quantize_linear_params({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    jq["b"] = jq["b"].astype(jdt)
    tq_ = tm.quantize_linear_params({"w": torch.as_tensor(w), "b": torch.as_tensor(b)})
    tq_["b"] = tq_["b"].to(tdt)
    jx, tx = jnp.asarray(x).astype(jdt), torch.as_tensor(x).to(tdt)

    fused = tq.quant_matmul_plain(tx.reshape(-1, 256), tq_["w_q"], tq_["s_w"], b=tq_["b"], amax_floor=0.0,
                                  scale_floor=1e-8)
    separate = tq.quant_matmul_plain(tx.reshape(-1, 256), tq_["w_q"], tq_["s_w"], amax_floor=0.0,
                                     scale_floor=1e-8) + tq_["b"]
    assert fused.dtype == tdt and torch.equal(fused, separate)
    out = tm._linear_int8(tq_, tx)
    assert out.shape == (3, 40, 384) and out.dtype == tdt
    assert torch.equal(out.reshape(-1, 384), fused)
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, np.asarray(jm._linear_int8(jq, jx)), rtol=1e-6, atol=1e-6)
        return
    with jax.disable_jit():
        ref = np.asarray(jm._linear_int8(jq, jx).astype(jnp.float32))
    np.testing.assert_array_equal(got, ref)
    jitted = np.asarray(jax.jit(jm._linear_int8)(jq, jx).astype(jnp.float32)).reshape(-1, 384)
    rows = np.unique(np.argwhere(got.reshape(-1, 384) != jitted)[:, 0])
    assert len(rows) <= 3 and _rel_l2(got.reshape(-1, 384), jitted) < 2e-3


def test_quant_matmul_wrapper_passes_the_bias_to_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.standard_normal((20, 64)).astype(np.float32))
    wq, sw = _quantized_weight(rng, 64, 32)
    b = torch.as_tensor(rng.standard_normal((32,)).astype(np.float32))
    out = tq.quant_matmul(x, torch.as_tensor(wq), torch.as_tensor(sw), b=b)
    assert torch.equal(out, tq.quant_matmul_plain(x, torch.as_tensor(wq), torch.as_tensor(sw)) + b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_parallel_entry_points_compose_to_the_whole_linear(dtype):
    """The tensor-parallel entry points on the CPU (their plain versions): the
    row abs-max of the whole row (``row_amax``), each K-shard's int32
    accumulators quantized by it (``quant_matmul(amax=, raw=True)``), their
    sum, and ``rescale_rows`` with the bias give ``quant_matmul`` of the whole
    K bit for bit, under both floors; in fp32 also the JAX ``_linear_int8``
    to rtol 1e-6. A shard-local abs-max gives other accumulators (row 0's
    abs-max lives on one shard)."""
    rng = np.random.default_rng(13)
    tdt = getattr(torch, dtype)
    x = torch.as_tensor(rng.standard_normal((24, 256)).astype(np.float32)).to(tdt)
    x[0, 200] = 30.0
    x[1] = 1e-7  # under 1.27e-6: the two floors part here
    wq, sw = _quantized_weight(rng, 256, 96)
    w_q, s_w = torch.as_tensor(wq), torch.as_tensor(sw)
    b = torch.as_tensor(rng.standard_normal((96,)).astype(np.float32)).to(tdt)
    amax = tq.row_amax(x)
    assert amax.dtype == torch.float32 and torch.equal(amax, x.float().abs().amax(-1))
    for floors in (dict(amax_floor=1e-6, scale_floor=0.0), dict(amax_floor=0.0, scale_floor=1e-8)):
        shards = [tq.quant_matmul(x[:, i:i + 64].contiguous(), w_q[i:i + 64], s_w, amax=amax, raw=True, **floors)
                  for i in range(0, 256, 64)]
        assert all(a.dtype == torch.int32 for a in shards)
        acc = sum(shards)
        assert torch.equal(acc, tq.quant_matmul(x, w_q, s_w, amax=amax, raw=True, **floors))
        y = tq.rescale_rows(acc, amax, s_w, b=b, dtype=tdt, **floors)
        assert y.dtype == tdt and torch.equal(y, tq.quant_matmul(x, w_q, s_w, b=b, **floors))
        local = tq.quant_matmul(x[:, :64].contiguous(), w_q[:64], s_w, raw=True, **floors)
        assert not torch.equal(local[0], shards[0][0])
    if dtype == "float32":
        jq = {"w_q": jnp.asarray(wq), "s_w": jnp.asarray(sw), "b": jnp.asarray(b.numpy())}
        np.testing.assert_allclose(y.numpy(), np.asarray(jm._linear_int8(jq, jnp.asarray(x.numpy()))), rtol=1e-6,
                                   atol=1e-6)


def test_given_abs_max_sets_the_row_scale():
    """``quant_matmul(amax=)`` quantizes each row by the given abs-max (a
    larger one than the row's own, as a row-parallel shard sees), spelled out
    in numpy; the raw output takes no bias."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    wq, sw = _quantized_weight(rng, 64, 32)
    amax = (np.abs(x).max(-1) * np.linspace(1.0, 3.0, 8)).astype(np.float32)
    acc = tq.quant_matmul(torch.as_tensor(x), torch.as_tensor(wq), torch.as_tensor(sw), amax=torch.as_tensor(amax),
                          raw=True, amax_floor=0.0, scale_floor=1e-8).numpy()
    sx = np.maximum(amax / np.float32(127.0), np.float32(1e-8)).astype(np.float32)
    want = np.round(x / sx[:, None]).astype(np.int64) @ wq.astype(np.int64)
    np.testing.assert_array_equal(acc, want)
    y = tq.rescale_rows_plain(torch.as_tensor(acc), torch.as_tensor(amax), torch.as_tensor(sw), amax_floor=0.0,
                              scale_floor=1e-8).numpy()
    np.testing.assert_array_equal(y, (want.astype(np.float32) * sx[:, None]) * sw)
    with pytest.raises(ValueError, match="no bias"):
        tq.quant_matmul(torch.as_tensor(x), torch.as_tensor(wq), torch.as_tensor(sw), b=torch.zeros(32), raw=True)


@pytest.fixture(scope="module")
def tiny():
    cfg = jd.DiTConfig(**TINY)
    params = jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(0), cfg))
    return params, jd.quantize_dit_params(jax.tree.map(jnp.asarray, params))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, tree


def test_quantize_dit_params_tree_matches_jax_leaf_by_leaf(tiny):
    params, jq = tiny
    tq_ = td.quantize_dit_params(t_convert.dit_params_from_numpy(params, "cpu"))
    j_leaves, t_leaves = dict(_leaves(jq)), dict(_leaves(tq_))
    assert set(j_leaves) == set(t_leaves)
    n_int8 = 0
    for name, jl in j_leaves.items():
        tl = t_leaves[name]
        assert tuple(tl.shape) == tuple(jl.shape), name
        if name.endswith("/w_q"):
            assert tl.dtype == torch.int8
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            n_int8 += 1
        else:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-7, err_msg=name)
    assert n_int8 == 6
    for group, name in QUANTIZED:
        assert set(tq_["blocks"][group][name]) == {"w_q", "s_w", "b"}
    assert "w" in tq_["blocks"]["attn_norm"]["linear"] and "w" in tq_["proj_out"]  # AdaLN and the output stay fp


def test_quantized_dit_forward_matches_jax(tiny):
    """Relative L2 against the JAX quantized forward: measured 2.8e-7 on this
    input (no rint flips); the bound 1e-3 leaves room for a few flips, each of
    which moves one activation by 1/127 of its row's abs-max."""
    params, jq = tiny
    cfg_j, cfg_t = jd.DiTConfig(**TINY), td.DiTConfig(**TINY)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 20)).astype(np.float32)
    text = rng.integers(0, 20, (2, 10)).astype(np.int32)
    t = np.array([0.4, 0.6], np.float32)
    f = np.zeros((2,), bool)
    mask = np.arange(32)[None] < np.array([[32], [25]])
    ref_q = np.asarray(jd.dit_forward(jq, cfg_j, *(jnp.asarray(a) for a in (x, x, text, t, f, f, mask))))
    ref_fp = np.asarray(jd.dit_forward(jax.tree.map(jnp.asarray, params), cfg_j,
                                       *(jnp.asarray(a) for a in (x, x, text, t, f, f, mask))))
    tq_ = td.quantize_dit_params(t_convert.dit_params_from_numpy(params, "cpu"))
    with torch.no_grad():
        out = td.dit_forward(tq_, cfg_t, *(torch.as_tensor(a) for a in (x, x, text, t, f, f, mask))).numpy()
    assert _rel_l2(out, ref_q) < 1e-3
    cos = float(np.sum(out * ref_fp) / (np.linalg.norm(out) * np.linalg.norm(ref_fp)))
    assert _rel_l2(out, ref_fp) < 0.1 and cos > 0.995  # what tests/test_quantization.py holds the JAX package to


def test_int8_leaves_survive_the_params_bridge(tiny, tmp_path):
    """A quantized tree through ``save_params_npz`` / ``load_params_npz`` /
    ``params_from_numpy(dtype=bf16)``: int8 stays int8, ``s_w`` stays fp32,
    the other floating leaves take the serving dtype."""
    _, jq = tiny
    as_numpy = jax.tree.map(np.asarray, jq)
    path = str(tmp_path / "q.npz")
    t_convert.save_params_npz(path, t_convert.params_from_numpy(as_numpy, "cpu"))
    back = t_convert.load_params_npz(path)
    served = t_convert.dit_params_from_numpy(back, "cpu", torch.bfloat16)
    lin = served["blocks"]["ff"]["in"]
    assert lin["w_q"].dtype == torch.int8 and lin["s_w"].dtype == torch.float32 and lin["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(lin["w_q"].numpy(), as_numpy["blocks"]["ff"]["in"]["w_q"])
    np.testing.assert_array_equal(lin["s_w"].numpy(), as_numpy["blocks"]["ff"]["in"]["s_w"])
    assert served["proj_out"]["w"].dtype == torch.bfloat16


def test_engine_config_validates_quantization():
    assert t_engine.EngineConfig().quantization == "none"  # the default, as in the JAX package
    assert t_engine.EngineConfig(quantization="int8").quantization == "int8"
    with pytest.raises(ValueError, match="quantization"):
        t_engine.EngineConfig(quantization="int4")


def test_int8_engine_quantizes_after_the_cast_and_matches_jax(tiny):
    """An int8 ``TTSEngine`` on the CPU (fp32 compute, explicit noise) against
    the JAX engine's program on the JAX engine's own quantized params:
    relative L2 of the generated mel and the waveform under 1e-3 (measured
    1.2e-4 and 1.1e-4 over 8 forwards: some rint flips, see the module
    docstring). In bf16 the scales come from
    the weights after their rounding to bf16, and stay fp32."""
    params, _ = tiny
    vp = jax.tree.map(np.asarray, jv.init_vocos(jax.random.PRNGKey(1), jv.VocosConfig(**VOC)))
    sampler_j, sampler_t = je.serving_default_sampler(steps=2), te.serving_default_sampler(steps=2)
    j = j_engine.TTSEngine(params, jd.DiTConfig(**TINY), vp, JTokenizer(VOCAB), j_engine.EngineConfig(
        mel=JMelConfig(n_mels=20), vocoder=jv.VocosConfig(**VOC), sampler=sampler_j, compute_dtype="float32",
        quantization="int8"))
    t = t_engine.TTSEngine(params, td.DiTConfig(**TINY), vp, TTokenizer(VOCAB), t_engine.EngineConfig(
        mel=TMelConfig(n_mels=20), vocoder=tv.VocosConfig(**VOC), sampler=sampler_t, compute_dtype="float32",
        quantization="int8"), device="cpu")
    for group, name in QUANTIZED:
        np.testing.assert_array_equal(t.dit_params["blocks"][group][name]["w_q"].numpy(),
                                      np.asarray(j.dit_params["blocks"][group][name]["w_q"]))

    rng = np.random.default_rng(6)
    b, n = 2, 128
    cond = rng.standard_normal((b, n, 20)).astype(np.float32)
    cond_lens = np.array([30, 45], np.int32)
    text = np.where(np.arange(40)[None] < np.array([[40], [25]]), rng.integers(0, 90, (b, 40)), -1).astype(np.int32)
    duration = np.array([128, 100], np.int32)
    y0 = rng.standard_normal((b, n, 20)).astype(np.float32)
    jcfg, vcfg = j.dit_cfg, jv.VocosConfig(**VOC)

    @jax.jit
    def jax_program(dp, vp, cond, cond_lens, text, duration, y0):  # the JAX engine's program with explicit noise
        mel_out = je.sample_cfm(dp, jcfg, cond=cond, cond_lens=cond_lens, text=text, duration=duration,
                                sampler=sampler_j, y0=y0)
        idx = (jnp.arange(n)[None, :] + cond_lens[:, None]) % n
        gen = jnp.take_along_axis(mel_out, idx[..., None], axis=1)
        gen = jnp.where(jnp.arange(n)[None, :, None] < (duration - cond_lens)[:, None, None], gen, 0.0)
        return gen, jv.vocos_decode(vp, gen, vcfg)

    j_gen, j_wave = jax_program(j.dit_params, j.vocos_params, *(jnp.asarray(a) for a in (cond, cond_lens, text,
                                                                                        duration, y0)))
    t_gen, t_wave = t.bucket_program(*(torch.as_tensor(a) for a in (cond, cond_lens, text, duration)),
                                     steps=2, cfg_strength=2.0, y0=torch.as_tensor(y0))
    assert _rel_l2(t_gen.numpy(), j_gen) < 1e-3
    assert _rel_l2(t_wave.numpy(), j_wave) < 1e-3

    t16 = t_engine.TTSEngine(params, td.DiTConfig(**TINY), vp, TTokenizer(VOCAB), t_engine.EngineConfig(
        mel=TMelConfig(n_mels=20), vocoder=tv.VocosConfig(**VOC), sampler=sampler_t, quantization="int8"),
        device="cpu")
    lin = t16.dit_params["blocks"]["ff"]["in"]
    w16 = torch.tensor(params["blocks"]["ff"]["in"]["w"]).bfloat16().float()
    assert lin["s_w"].dtype == torch.float32 and lin["w_q"].dtype == torch.int8 and "w" not in lin
    torch.testing.assert_close(lin["s_w"], w16.abs().amax(-2) / 127.0, rtol=1e-6, atol=0)
    assert t16.dit_params["blocks"]["attn_norm"]["linear"]["w"].dtype == torch.bfloat16
    wave, sr, mel = t16.synthesize("A short int8 request.", (0.1 * np.sin(np.arange(24000) / 7.0)).astype(np.float32),
                                   24000, "Ref.", seed=0)
    assert sr == 24000 and len(wave) > 0 and np.isfinite(wave).all() and np.isfinite(mel).all()
