"""The port's Parler branch (``f5tts_tpu_torch/models/parler.py`` and the
decode-attention kernel's plain version) against the JAX package on the CPU.

The same numpy arrays (weights from the JAX initialisers, inputs from seeded
numpy) go through the JAX function and its counterpart; fp32, JAX matmul
precision ``highest`` (``tests/conftest.py``). Where the JAX function reaches
the Pallas decode kernel it runs in interpret mode, with K transposed and
padded to 128 positions as that kernel wants. Tolerances: decode attention
atol 1e-5 (summation order); T5 states, decoder logits and DAC waves atol 1e-4
(fp32 through 2 layers); buckets, delay patterns, greedy codes and lengths
equal. Sampled tokens are not compared with JAX's (different generators): the
port's sampling is checked for its own invariants."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import parler as JP
from f5tts_tpu.ops.pallas import decode_attention as j_dec
from f5tts_tpu_torch.models import convert as t_convert
from f5tts_tpu_torch.models import parler as TP
from f5tts_tpu_torch.ops.kernels import decode_attention as t_dec

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T5 = dict(vocab=60, d_model=24, d_kv=6, d_ff=32, heads=4, layers=2, rel_buckets=8, rel_max_dist=20)
DEC = dict(vocab=40, codebooks=4, hidden=32, layers=2, heads=4, ffn=48, cross_dim=24, prompt_vocab=60)
DEC_GQA = dict(vocab=40, codebooks=3, hidden=32, layers=2, heads=4, ffn=64, cross_dim=32, prompt_vocab=16,
               kv_heads=2, cross_kv_heads=2)
DAC = dict(num_codebooks=4, codebook_size=40, codebook_dim=6, latent_dim=24, decoder_dim=16, rates=(4, 2))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))  # a writable copy


def _torch_tree(tree):
    return t_convert.params_from_numpy(_np(tree), "cpu")


@pytest.fixture(scope="module")
def decoders():
    """geometry name -> (kwargs, JAX params, torch params)."""
    out = {}
    for name, kw in (("mha", DEC), ("gqa", DEC_GQA)):
        params = JP.init_parler_decoder(jax.random.PRNGKey(0), JP.ParlerDecoderConfig(**kw))
        out[name] = (kw, params, _torch_tree(params))
    return out


def _decode_inputs(kw, seed=5, b=3, enc_n=12, p=5, dead_enc_row=None):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, enc_n, kw["cross_dim"])).astype(np.float32)
    enc_mask = np.arange(enc_n)[None] < np.array([[enc_n], [7], [3]])[:b]
    if dead_enc_row is not None:
        enc_mask[dead_enc_row] = False
    prompt = rng.integers(0, kw["prompt_vocab"], (b, p)).astype(np.int32)
    prompt_mask = np.arange(p)[None] >= np.array([[0], [2], [4]])[:b]  # left-padded prompts
    return enc, enc_mask, prompt, prompt_mask


# ---------------------------------------------------------------------------
# decode attention: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


def _attn_case(b, h, n_kv, total, d, seed, bound, pad_row):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, 1, d)) * d**-0.5).astype(np.float32)
    k = rng.standard_normal((b, n_kv, total, d)).astype(np.float32)
    v = rng.standard_normal((b, n_kv, total, d)).astype(np.float32)
    allowed = np.broadcast_to(np.arange(total)[None] <= bound, (b, total)).copy()
    if pad_row is not None:
        allowed[pad_row, :3] = False
    return q, k, v, np.where(allowed, 0.0, -1e9).astype(np.float32)


def _pallas_interpret(q, k, v, bias):
    """The JAX kernel on the same arrays: K transposed, ``total`` padded to 128
    with banned positions."""
    pad = -(-k.shape[2] // 128) * 128 - k.shape[2]
    kt = jnp.asarray(np.pad(k, ((0, 0), (0, 0), (0, pad), (0, 0))).transpose(0, 1, 3, 2))
    vp = jnp.asarray(np.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0))))
    bp = jnp.asarray(np.pad(bias, ((0, 0), (0, pad)), constant_values=-1e9))
    return np.asarray(j_dec.decode_attention(jnp.asarray(q), kt, vp, bp, interpret=True))


@pytest.mark.parametrize("b,h,n_kv,total,d,bound,pad_row", [
    (2, 4, 4, 37, 64, 20, 1),  # MHA, causal bound in the middle of the cache, a row with padded keys
    (3, 4, 2, 50, 32, 49, None),  # GQA, whole cache allowed
    (2, 8, 2, 130, 16, 100, 0),  # group of 4, more than one 128 tile on the JAX side
])
def test_decode_attention_plain_matches_pallas_interpret(b, h, n_kv, total, d, bound, pad_row):
    q, k, v, bias = _attn_case(b, h, n_kv, total, d, 0, bound, pad_row)
    got = t_dec.decode_attention_plain(_t(q), _t(k), _t(v), _t(bias))
    assert got.shape == (b, h, 1, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas_interpret(q, k, v, bias), atol=1e-5)


def test_decode_attention_fully_masked_row_follows_the_xla_path():
    """Every bias -1e9: fp32 scores collapse to -1e9 and the weights are
    uniform over the positions GIVEN. The port's caches are unpadded, so it
    agrees with the JAX package's XLA formulation (the Pallas kernel also
    averages over its 128-padding)."""
    q, k, v, bias = _attn_case(2, 4, 2, 21, 32, 0, 20, None)
    bias[1] = -1e9
    got = t_dec.decode_attention_plain(_t(q), _t(k), _t(v), _t(bias)).numpy()
    kk, vv = (jnp.repeat(jnp.asarray(t), 2, axis=1) for t in (k, v))
    lg = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kk) + jnp.asarray(bias)[:, None, None, :]
    ref = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(lg, axis=-1), vv)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got[1], np.repeat(v[1].mean(1), 2, axis=0)[:, None, :], atol=1e-5)  # uniform
    assert np.abs(_pallas_interpret(q, k, v, bias)[1] - got[1]).max() > 1e-3  # the padded kernel differs here


def test_decode_attention_wrapper_on_cpu_takes_the_plain_version():
    q, k, v, bias = (_t(a) for a in _attn_case(2, 4, 2, 21, 32, 1, 10, 0))
    before = t_dec.decode_attention.launches
    out = t_dec.decode_attention(q, k, v, bias)
    assert t_dec.decode_attention.launches == before  # launches count kernel launches only
    torch.testing.assert_close(out, t_dec.decode_attention_plain(q, k, v, bias), rtol=0, atol=0)
    bf = t_dec.decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias)
    assert bf.dtype == torch.bfloat16 and float((bf.float() - out).abs().max()) < 2e-2


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,buckets,max_dist", [(64, 32, 128), (64, 8, 20), (48, 16, 64)])
def test_rel_bucket_matches_jax(n, buckets, max_dist):
    rel = np.arange(n)[None, :] - np.arange(n)[:, None]
    want = np.asarray(JP._rel_bucket(jnp.asarray(rel), buckets, max_dist))
    np.testing.assert_array_equal(TP._rel_bucket(_t(rel), buckets, max_dist).numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_t5_encode_matches_jax(masked):
    cfg = JP.T5Config(**T5)
    params = JP.init_t5_encoder(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab, (3, 64)).astype(np.int32)
    mask = (np.arange(64)[None] < np.array([[64], [30], [5]])) if masked else None
    want = JP.t5_encode(params, cfg, jnp.asarray(ids), None if mask is None else jnp.asarray(mask))
    got = TP.t5_encode(_torch_tree(params), TP.T5Config(**T5), _t(ids), None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    bias = TP.t5_relative_bias(_t(params["rel_bias"]), 64, TP.T5Config(**T5))
    np.testing.assert_allclose(bias.numpy(), np.asarray(JP.t5_relative_bias(params["rel_bias"], 64, cfg)), atol=1e-7)


# ---------------------------------------------------------------------------
# decoder: teacher-forced pass, delay pattern, generation
# ---------------------------------------------------------------------------


def test_sinusoidal_positions_match_jax():
    pos = np.arange(70)
    np.testing.assert_allclose(TP.sinusoidal_positions(_t(pos), 32).numpy(),
                               np.asarray(JP.sinusoidal_positions(jnp.asarray(pos), 32)), atol=1e-5)


@pytest.mark.parametrize("geometry", ["mha", "gqa"])
@pytest.mark.parametrize("with_prompt", [False, True])
def test_parler_decoder_forward_matches_jax(decoders, geometry, with_prompt):
    kw, jp, tp = decoders[geometry]
    enc, enc_mask, prompt, prompt_mask = _decode_inputs(kw)
    codes = np.random.default_rng(3).integers(0, kw["vocab"] + 1, (3, kw["codebooks"], 9)).astype(np.int32)
    j_extra = dict(prompt_ids=jnp.asarray(prompt), prompt_mask=jnp.asarray(prompt_mask)) if with_prompt else {}
    t_extra = dict(prompt_ids=_t(prompt), prompt_mask=_t(prompt_mask)) if with_prompt else {}
    want = JP.parler_decoder_forward(jp, JP.ParlerDecoderConfig(**kw), jnp.asarray(codes), jnp.asarray(enc),
                                     jnp.asarray(enc_mask), **j_extra)
    got = TP.parler_decoder_forward(tp, TP.ParlerDecoderConfig(**kw), _t(codes), _t(enc), _t(enc_mask), **t_extra)
    assert got.shape == (3, kw["codebooks"], 9, kw["vocab"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_delay_pattern_and_finalize_match_jax():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 40, (2, 4, 7)).astype(np.int32)
    for max_length in (12, 8):
        np.testing.assert_array_equal(TP.build_delay_pattern(codes, 40, max_length),
                                      JP.build_delay_pattern(codes, 40, max_length))
    delayed = TP.build_delay_pattern(codes, 40, 11)
    np.testing.assert_array_equal(TP.revert_delay_pattern(_t(delayed), 7).numpy(), codes)
    np.testing.assert_array_equal(TP.revert_delay_pattern(_t(delayed), 7).numpy(),
                                  np.asarray(JP.revert_delay_pattern(jnp.asarray(delayed), 7)))
    raw = rng.integers(-1, 48, (2, 4, 7)).astype(np.int32)  # strays below 0 and above the codec codebook
    eos = np.array([7, 3], np.int32)
    for max_code in (None, 36):
        jc, jl = JP.finalize_codes(jnp.asarray(raw), jnp.asarray(eos), JP.ParlerDecoderConfig(**DEC), max_code)
        tc, tl = TP.finalize_codes(_t(raw), _t(eos), TP.ParlerDecoderConfig(**DEC), max_code)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _jax_generate(jp, kw, attn, fuse, enc, enc_mask, prompt, prompt_mask, frames, eos):
    cfg = JP.ParlerDecoderConfig(**kw, decode_layout="unrolled", decode_attn=attn, fuse_decode_qkv=fuse)
    codes, lengths = JP.parler_generate(jp, cfg, jnp.asarray(enc), jnp.asarray(enc_mask), frames,
                                        jax.random.PRNGKey(0), prompt_ids=jnp.asarray(prompt),
                                        prompt_mask=jnp.asarray(prompt_mask), eos_token=eos, temperature=0.0)
    return np.asarray(codes), np.asarray(lengths)


def _torch_generate(tp, kw, fuse, enc, enc_mask, prompt, prompt_mask, frames, eos, **extra):
    cfg = TP.ParlerDecoderConfig(**kw, decode_attn="plain", fuse_decode_qkv=fuse)
    codes, lengths = TP.parler_generate(tp, cfg, _t(enc), _t(enc_mask), frames, 0, prompt_ids=_t(prompt),
                                        prompt_mask=_t(prompt_mask), eos_token=eos, temperature=0.0, **extra)
    return codes.numpy(), lengths.numpy()


@pytest.mark.parametrize("geometry", ["mha", "gqa"])
@pytest.mark.parametrize("jax_attn", ["xla", "pallas"])
@pytest.mark.parametrize("fuse", [False, True])
def test_greedy_generate_matches_jax(decoders, geometry, jax_attn, fuse):
    """Greedy codes and lengths equal the JAX package's under both of its
    decode paths: prompt, left-padded prompt mask, ragged ``enc_mask``, and an
    EOS that ends one row early."""
    kw, jp, tp = decoders[geometry]
    inputs = _decode_inputs(kw)
    frames = 8
    free, _ = _torch_generate(tp, kw, fuse, *inputs, frames, -1)
    eos = int(free[0, 0, 3])  # a token codebook 0 of row 0 emits mid-stream
    got = _torch_generate(tp, kw, fuse, *inputs, frames, eos)
    assert got[1][0] <= 3 and got[1].max() > got[1][0], got[1]  # row 0 stops early, another row runs on
    want = _jax_generate(jp, kw, jax_attn, fuse, *inputs, frames, eos)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32 and got[0].shape == (3, kw["codebooks"], frames)


def test_generate_with_a_fully_masked_encoder_row_follows_the_xla_path(decoders):
    kw, jp, tp = decoders["gqa"]
    inputs = _decode_inputs(kw, dead_enc_row=1)
    got = _torch_generate(tp, kw, True, *inputs, 6, -1)
    want = _jax_generate(jp, kw, "xla", True, *inputs, 6, -1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_kernel_switch_on_cpu_equals_plain_and_rejects_unknown(decoders):
    kw, _, tp = decoders["mha"]
    enc, enc_mask, prompt, prompt_mask = (_t(a) for a in _decode_inputs(kw))
    outs = [TP.parler_generate(tp, TP.ParlerDecoderConfig(**kw, decode_attn=attn), enc, enc_mask, 5, 0,
                               prompt_ids=prompt, prompt_mask=prompt_mask, temperature=0.0, eos_token=-1)
            for attn in ("kernel", "plain")]
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="decode_attn"):
        TP.ParlerDecoderConfig(**kw, decode_attn="xla")


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 5)])
def test_decode_segments_concatenate_to_generate(decoders, temperature, top_k):
    """Segments of 4 positions, the last running past ``steps`` (clamped onto
    the last cache slot, tokens discarded), equal one ``parler_generate``."""
    kw, _, tp = decoders["gqa"]
    cfg = TP.ParlerDecoderConfig(**kw, decode_attn="plain", fuse_decode_qkv=True)
    enc, enc_mask, prompt, prompt_mask = (_t(a) for a in _decode_inputs(kw))
    frames, K = 8, kw["codebooks"]
    steps = frames + K - 1
    common = dict(prompt_ids=prompt, prompt_mask=prompt_mask, eos_token=7, temperature=temperature, top_k=top_k,
                  row_seeds=[11, 12, 13])
    codes, lengths = TP.parler_generate(tp, cfg, enc, enc_mask, frames, 3, **common)
    carry, toks = None, []
    for j0 in range(1, steps + 1, 4):
        carry, seg = TP.parler_decode_segment(tp, cfg, enc, enc_mask, frames, np.arange(j0, j0 + 4), carry,
                                              seed=3, **common)
        assert seg.shape == (4, 3, K)
        toks.append(seg)
    assert steps % 4 != 0  # the tail segment really ran past the end
    toks = torch.cat(toks)[:steps]
    seg_codes, seg_lengths = TP.finalize_codes(TP.revert_delay_pattern(toks.permute(1, 2, 0), frames), carry[3], cfg)
    np.testing.assert_array_equal(seg_codes.numpy(), codes.numpy())
    np.testing.assert_array_equal(seg_lengths.numpy(), lengths.numpy())


def test_sampled_rows_do_not_depend_on_their_batch(decoders):
    """temperature > 0 with ``row_seeds``: a row's tokens are the same alone
    and in a batch, differ between row seeds, and top-k keeps them in the k
    most likely."""
    kw, _, tp = decoders["mha"]
    cfg = TP.ParlerDecoderConfig(**kw, decode_attn="plain")
    enc, enc_mask, prompt, prompt_mask = (_t(a) for a in _decode_inputs(kw))
    common = dict(eos_token=-1, temperature=0.9, top_k=8)
    batch, _ = TP.parler_generate(tp, cfg, enc, enc_mask, 10, 0, prompt_ids=prompt, prompt_mask=prompt_mask,
                                  row_seeds=[41, 42, 43], **common)
    alone, _ = TP.parler_generate(tp, cfg, enc[1:2], enc_mask[1:2], 10, 0, prompt_ids=prompt[1:2],
                                  prompt_mask=prompt_mask[1:2], row_seeds=[42], **common)
    np.testing.assert_array_equal(alone[0].numpy(), batch[1].numpy())
    other, _ = TP.parler_generate(tp, cfg, enc[1:2], enc_mask[1:2], 10, 0, prompt_ids=prompt[1:2],
                                  prompt_mask=prompt_mask[1:2], row_seeds=[7], **common)
    assert not np.array_equal(other.numpy(), alone.numpy())
    whole, _ = TP.parler_generate(tp, cfg, enc, enc_mask, 10, 5, prompt_ids=prompt, prompt_mask=prompt_mask, **common)
    again, _ = TP.parler_generate(tp, cfg, enc, enc_mask, 10, 5, prompt_ids=prompt, prompt_mask=prompt_mask, **common)
    np.testing.assert_array_equal(whole.numpy(), again.numpy())  # one seed keys the whole batch, reproducibly


def test_top_k_support_matches_jax_masking():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 4, 40)).astype(np.float32)
    probs = TP._filtered_probs(_t(logits), 0.7, 5).numpy()
    scaled = jnp.asarray(logits) / 0.7
    kth = jax.lax.top_k(scaled, 5)[0][..., -1:]
    want = np.asarray(jax.nn.softmax(jnp.where(scaled < kth, -jnp.inf, scaled), axis=-1))
    np.testing.assert_allclose(probs, want, atol=1e-6)
    assert ((probs > 0).sum(-1) == 5).all()
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([TP._sample(gen, _t(logits), 0.7, 5) for _ in range(200)])
    assert bool((torch.gather(_t(probs).expand(200, -1, -1, -1), -1, draws[..., None]) > 0).all())
    freq = torch.nn.functional.one_hot(draws, 40).float().mean(0).numpy()
    assert np.abs(freq - probs).max() < 0.15  # 200 draws: the frequencies follow the probabilities
    np.testing.assert_array_equal(TP._sample(None, _t(logits), 0.0, 0).numpy(), logits.argmax(-1))


# ---------------------------------------------------------------------------
# DAC decoder and the parameter converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rates", [(4, 2), (3, 2, 2)])  # an odd stride: ceil(stride / 2) crop
def test_dac_decode_matches_jax_through_the_converter(rates):
    cfg = JP.DacConfig(**{**DAC, "rates": rates})
    params = JP.init_dac_decoder(jax.random.PRNGKey(2), cfg)
    params = jax.tree.map(lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size, dtype=jnp.float32).reshape(a.shape)),
                          params)  # alphas off 1, so Snake's 1/alpha is exercised
    codes = np.random.default_rng(7).integers(0, cfg.codebook_size, (2, cfg.num_codebooks, 11)).astype(np.int32)
    t5 = JP.init_t5_encoder(jax.random.PRNGKey(1), JP.T5Config(**T5))
    dec = JP.init_parler_decoder(jax.random.PRNGKey(0), JP.ParlerDecoderConfig(**DEC))
    _, _, t_dac = t_convert.parler_params_from_numpy(_np(t5), _np(dec), _np(params), "cpu")
    t_cfg = TP.DacConfig(**{**DAC, "rates": rates})
    np.testing.assert_allclose(TP.dac_from_codes(t_dac, _t(codes)).numpy(),
                               np.asarray(JP.dac_from_codes(params, jnp.asarray(codes))), atol=1e-5)
    want = np.asarray(JP.dac_decode_codes(params, jnp.asarray(codes), cfg))
    got = TP.dac_decode_codes(t_dac, _t(codes), t_cfg)
    if all(r % 2 == 0 for r in rates):
        assert got.shape == (2, 11 * t_cfg.hop)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    k, c_in, c_out = np.asarray(params["blocks"][0]["convt"]["w"]).shape
    assert tuple(t_dac["blocks"][0]["convt"]["w"].shape) == (c_in, c_out, k)  # laid out for F.conv_transpose1d


def test_converter_rejects_a_tree_that_is_not_the_models():
    t5 = _np(JP.init_t5_encoder(jax.random.PRNGKey(1), JP.T5Config(**T5)))
    dec = _np(JP.init_parler_decoder(jax.random.PRNGKey(0), JP.ParlerDecoderConfig(**DEC)))
    dac = _np(JP.init_dac_decoder(jax.random.PRNGKey(2), JP.DacConfig(**DAC)))
    with pytest.raises(KeyError, match="T5"):
        t_convert.parler_params_from_numpy(dec, dec, dac, "cpu")
    with pytest.raises(KeyError, match="DAC"):
        t_convert.parler_params_from_numpy(t5, dec, t5, "cpu")
    before = dac["blocks"][0]["convt"]["w"].copy()
    t_convert.parler_params_from_numpy(t5, dec, dac, "cpu", torch.bfloat16)
    np.testing.assert_array_equal(dac["blocks"][0]["convt"]["w"], before)  # the caller's tree is left as it was


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(np.shape(tree))}


@pytest.mark.parametrize("which", ["t5", "decoder", "decoder_gqa_proj", "dac"])
def test_numpy_initialisers_build_the_jax_trees(which):
    """``init_*_numpy`` give the JAX initialisers' keys and shapes (any width),
    deterministically from their seed."""
    key = jax.random.PRNGKey(0)
    if which == "t5":
        want, make = JP.init_t5_encoder(key, JP.T5Config(**T5)), lambda s: t_convert.init_t5_numpy(TP.T5Config(**T5), s)
    elif which == "dac":
        want, make = JP.init_dac_decoder(key, JP.DacConfig(**DAC)), lambda s: t_convert.init_dac_numpy(TP.DacConfig(**DAC), s)
    else:
        kw = DEC if which == "decoder" else DEC_GQA | {"cross_dim": 20}  # cross_dim != hidden adds enc_proj
        want = JP.init_parler_decoder(key, JP.ParlerDecoderConfig(**kw))
        make = lambda s: t_convert.init_parler_decoder_numpy(TP.ParlerDecoderConfig(**kw), s)  # noqa: E731
    got = make(3)
    assert _shapes(got) == _shapes(want)
    flat, again, other = _shapes(got), make(3), make(4)
    assert all(np.asarray(a).dtype == np.float32 for a in jax.tree.leaves(got))
    first = sorted(flat)[0]

    def leaf(tree, path):
        for part in path.strip("/").split("/"):
            tree = tree[int(part)] if isinstance(tree, list) else tree[part]
        return np.asarray(tree)

    random_leaf = next(p for p in sorted(flat) if np.std(leaf(got, p)) > 0)
    np.testing.assert_array_equal(leaf(got, random_leaf), leaf(again, random_leaf))
    assert not np.array_equal(leaf(got, random_leaf), leaf(other, random_leaf)) and first in flat


def test_port_runs_in_bf16_end_to_end():
    """The serving dtype on the CPU: finite outputs of the right shape and
    dtype through T5, the decode (kernel switch -> plain version) and the DAC."""
    t5_cfg, dec_cfg, dac_cfg = TP.T5Config(**T5), TP.ParlerDecoderConfig(**DEC, fuse_decode_qkv=True), TP.DacConfig(**DAC)
    t5, dec, dac = t_convert.parler_params_from_numpy(
        t_convert.init_t5_numpy(t5_cfg), t_convert.init_parler_decoder_numpy(dec_cfg),
        t_convert.init_dac_numpy(dac_cfg), "cpu", torch.bfloat16)
    ids = torch.arange(24).reshape(2, 12) % 60
    mask = torch.arange(12)[None] < torch.tensor([[12], [5]])
    enc = TP.t5_encode(t5, t5_cfg, ids, mask, compute_dtype=torch.bfloat16)
    assert enc.dtype == torch.bfloat16 and bool(torch.isfinite(enc).all())
    codes, lengths = TP.parler_generate(dec, dec_cfg, enc, mask, 6, 0, prompt_ids=ids[:, :4], temperature=1.0,
                                        top_k=10, max_code=dac_cfg.codebook_size, row_seeds=[1, 2],
                                        compute_dtype=torch.bfloat16)
    assert codes.shape == (2, 4, 6) and int(codes.max()) < 40 and int(lengths.max()) <= 6
    wave = TP.dac_decode_codes(dac, codes, dac_cfg, compute_dtype=torch.bfloat16)
    assert wave.shape == (2, 6 * dac_cfg.hop) and wave.dtype == torch.bfloat16 and bool(torch.isfinite(wave).all())
