"""The port's Parler checkpoint path (``models/parler.py``'s converters and
``load_parler_checkpoint``, ``serve/service.py``'s Parler loader) and its
``parler_loss`` against the JAX package on the CPU.

State dicts come from random ``transformers`` models (T5EncoderModel,
MusicgenForCausalLM, DacModel) as in ``tests/test_parler.py``; a full
ParlerTTSForConditionalGeneration layout is composed from them (T5 under
``text_encoder.``, the decoder under ``decoder.``, a prompt table, an
``enc_to_dec_proj``, the DAC in descript's positional layout under
``audio_encoder.model.``). Tolerances: converted numpy trees, renamed key sets
and greedy codes equal; ``parler_loss`` atol 1e-5, its gradients atol 1e-4
(fp32, JAX matmul precision ``highest``)."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import parler as JP
from f5tts_tpu_torch.models import parler as TP
from f5tts_tpu_torch.models.convert import init_dac_numpy, init_parler_decoder_numpy, init_t5_numpy, params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T5 = dict(vocab=50, d_model=24, d_kv=8, d_ff=48, heads=3, layers=2, rel_buckets=8, rel_max_dist=20)
DEC = dict(vocab=40, codebooks=4, hidden=32, layers=2, heads=4, ffn=64, cross_dim=24, prompt_vocab=50)
DAC = dict(num_codebooks=4, codebook_size=32, codebook_dim=6, latent_dim=24, decoder_dim=16, rates=(4, 2))
CFGS = (TP.T5Config(**T5), TP.ParlerDecoderConfig(**DEC), TP.DacConfig(**DAC))
J_CFGS = (JP.T5Config(**T5), JP.ParlerDecoderConfig(**DEC), JP.DacConfig(**DAC))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sds():
    """Numpy state dicts of random transformers models: ``t5``, ``musicgen``,
    ``dac`` (plain weights) and ``dac_wn`` (weight-norm parametrizations)."""
    from transformers import DacConfig as HFDacConfig
    from transformers import DacModel, T5EncoderModel
    from transformers import T5Config as HFT5Config
    from transformers.models.musicgen.configuration_musicgen import MusicgenDecoderConfig
    from transformers.models.musicgen.modeling_musicgen import MusicgenForCausalLM

    torch.manual_seed(0)
    t5 = T5EncoderModel(HFT5Config(
        vocab_size=50, d_model=24, d_kv=8, d_ff=48, num_layers=2, num_heads=3, relative_attention_num_buckets=8,
        relative_attention_max_distance=20, feed_forward_proj="gated-gelu", dropout_rate=0.0, use_cache=False))
    musicgen = MusicgenForCausalLM(MusicgenDecoderConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, ffn_dim=64, num_codebooks=4,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, max_position_embeddings=256, audio_channels=1,
        scale_embedding=False, activation_function="gelu"))
    dac = DacModel(HFDacConfig(
        encoder_hidden_size=16, downsampling_ratios=[2, 4], decoder_hidden_size=16, upsampling_ratios=[4, 2],
        n_codebooks=4, codebook_size=32, codebook_dim=6, hidden_size=24, sampling_rate=16000))

    def np_sd(model):
        return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}

    out = {"t5": np_sd(t5), "musicgen": np_sd(musicgen), "dac": np_sd(dac)}
    dac.apply_weight_norm()
    out["dac_wn"] = np_sd(dac)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def assert_trees_equal(port, ref):
    """The port's numpy tree equals the JAX converter's, array for array."""
    p, r = _flat(port), _flat(jax.tree.map(np.asarray, ref))
    assert sorted(p) == sorted(r)
    for k in r:
        assert isinstance(p[k], np.ndarray) and p[k].dtype == np.float32 == r[k].dtype, k
        np.testing.assert_array_equal(p[k], r[k], err_msg=k)


def _weight_g_layout(sd_wn):
    """New-style parametrizations -> the legacy ``weight_g``/``weight_v`` pair,
    with g scaled so the fold is no identity."""
    out = {}
    for k, v in sd_wn.items():
        if k.endswith("parametrizations.weight.original0"):
            out[k.replace("parametrizations.weight.original0", "weight_g")] = v * np.float32(1.5)
        elif k.endswith("parametrizations.weight.original1"):
            out[k.replace("parametrizations.weight.original1", "weight_v")] = v
        else:
            out[k] = v
    return out


def _descript_layout(hf_sd, cfg):
    """An HF-named DAC state dict in descript's positional key layout."""
    inverse = {v: k for k, v in TP._descript_renames(cfg).items()}
    return {inverse.get(k, k): v for k, v in hf_sd.items()}


def _parler_state_dict(sds, seed=3):
    """A ParlerTTSForConditionalGeneration state dict composed from the
    random models, the DAC in descript's layout with weight_g/weight_v."""
    rng = np.random.default_rng(seed)
    sd = {f"text_encoder.{k}": v for k, v in sds["t5"].items()}
    sd.update({f"decoder.{k}": v for k, v in sds["musicgen"].items()})
    sd["embed_prompts.weight"] = rng.standard_normal((DEC["prompt_vocab"], DEC["hidden"])).astype(np.float32)
    sd["enc_to_dec_proj.weight"] = (rng.standard_normal((DEC["hidden"], DEC["cross_dim"])) * 0.2).astype(np.float32)
    sd["enc_to_dec_proj.bias"] = (rng.standard_normal(DEC["hidden"]) * 0.1).astype(np.float32)
    dac = _descript_layout(_weight_g_layout(sds["dac_wn"]), CFGS[2])
    sd.update({f"audio_encoder.model.{k}": v for k, v in dac.items()})
    return sd


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("embed", ["encoder.embed_tokens", "shared"])
@pytest.mark.parametrize("prefix", ["", "text_encoder."])
def test_t5_converter_matches_jax(sds, embed, prefix):
    sd = dict(sds["t5"])
    if embed == "shared":
        sd.pop("encoder.embed_tokens.weight")
    else:
        sd["encoder.embed_tokens.weight"] = sd.pop("shared.weight")
    sd = {f"{prefix}{k}": v for k, v in sd.items()}
    assert_trees_equal(TP.convert_t5_encoder(sd, CFGS[0], prefix=prefix),
                       JP.convert_t5_encoder(sd, J_CFGS[0], prefix=prefix))


@pytest.mark.parametrize("prompts", [False, True], ids=["no_prompts", "embed_prompts"])
@pytest.mark.parametrize("proj", [False, True], ids=["no_proj", "enc_to_dec_proj"])
def test_decoder_converter_matches_jax(sds, prompts, proj):
    """The Musicgen layout (``model.decoder.``, ``lm_heads.``) as torch tensors,
    with and without a prompt table and an encoder projection."""
    sd = {k: torch.from_numpy(v) for k, v in _parler_state_dict(sds).items() if k.startswith("decoder.")}
    sd = {k[len("decoder."):]: v for k, v in sd.items()}
    kw = {}
    if prompts:
        g = torch.Generator().manual_seed(1)
        sd["embed_prompts.weight"] = torch.randn(DEC["prompt_vocab"], DEC["hidden"], generator=g)
        kw["embed_prompts_key"] = "embed_prompts.weight"
    if proj:
        g = torch.Generator().manual_seed(2)
        sd["proj.weight"], sd["proj.bias"] = torch.randn(32, 24, generator=g), torch.randn(32, generator=g)
        kw["enc_proj_prefix"] = "proj"
    port, ref = TP.convert_parler_decoder(sd, CFGS[1], **kw), JP.convert_parler_decoder(sd, J_CFGS[1], **kw)
    assert ("enc_proj" in port) == proj
    assert_trees_equal(port, ref)


@pytest.mark.parametrize("layout", ["plain", "weight_g", "parametrizations"])
def test_dac_converter_matches_jax(sds, layout):
    """Plain weights, the legacy weight-norm pair and the new parametrizations;
    the transposed convolutions flipped along time as the JAX tree keeps them."""
    sd = {"plain": sds["dac"], "parametrizations": sds["dac_wn"], "weight_g": _weight_g_layout(sds["dac_wn"])}[layout]
    port = TP.convert_dac(sd, CFGS[2])
    assert_trees_equal(port, JP.convert_dac(sd, J_CFGS[2]))
    w = sds["dac"]["decoder.block.0.conv_t1.weight"]  # (in, out, k)
    if layout == "plain":
        np.testing.assert_array_equal(port["blocks"][0]["convt"]["w"], w.transpose(2, 0, 1)[::-1])


def test_descript_renaming_matches_jax(sds):
    """descript's positional keys under ``audio_encoder.model.`` -> the HF
    names; keys outside the prefix are dropped; the converted trees equal."""
    desc = _descript_layout(_weight_g_layout(sds["dac_wn"]), CFGS[2])
    assert "decoder.model.1.block.1.weight_g" in desc and "decoder.model.4.weight_v" in desc
    sd = {**{f"audio_encoder.model.{k}": v for k, v in desc.items()}, "text_encoder.shared.weight": np.zeros(3)}
    port = TP.descript_dac_to_hf_keys(sd, CFGS[2], prefix="audio_encoder.model.")
    ref = JP.descript_dac_to_hf_keys(sd, J_CFGS[2], prefix="audio_encoder.model.")
    assert sorted(port) == sorted(ref) == sorted(_weight_g_layout(sds["dac_wn"]))
    assert all(port[k] is ref[k] for k in ref)
    assert_trees_equal(TP.convert_dac(port, CFGS[2]), JP.convert_dac(ref, J_CFGS[2]))


@pytest.fixture(scope="module")
def checkpoint(sds, tmp_path_factory):
    """The composed ParlerTTS state dict saved as ``.safetensors`` and ``.pt``."""
    from safetensors.numpy import save_file

    sd = _parler_state_dict(sds)
    d = tmp_path_factory.mktemp("parler_ckpt")
    save_file(sd, str(d / "model.safetensors"))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / "model.pt")
    return {"safetensors": str(d / "model.safetensors"), "pt": str(d / "model.pt")}


@pytest.mark.parametrize("suffix", ["safetensors", "pt"])
def test_load_parler_checkpoint_matches_jax_and_serves_the_same_codes(checkpoint, suffix, monkeypatch):
    """Both file formats give the JAX trees; greedy codes of the port's engine
    on them equal JAX's ``t5_encode`` + ``parler_generate`` on the same padded
    ids (the codes captured where the engine hands them to the DAC)."""
    from f5tts_tpu_torch.engine.ar_engine import ParlerEngineConfig, ParlerTTSEngine

    port = TP.load_parler_checkpoint(checkpoint[suffix], *CFGS)
    ref = JP.load_parler_checkpoint(checkpoint[suffix], *J_CFGS)
    for p, r in zip(port, ref):
        assert_trees_equal(p, r)
    assert "enc_proj" in port[1]

    frames = 6
    engine = ParlerTTSEngine(port[0], CFGS[0], port[1], CFGS[1], port[2], CFGS[2],
                             ParlerEngineConfig(max_frames=frames, desc_pad=12, prompt_pad=8, temperature=0.0,
                                                eos_token=-1, compute_dtype="float32"),
                             encode_fn=lambda s: [ord(c) % T5["vocab"] for c in s], device="cpu")
    captured = []
    dac_decode = TP.dac_decode_codes
    monkeypatch.setattr(TP, "dac_decode_codes", lambda params, codes, *a, **k: (
        captured.append(codes.clone()), dac_decode(params, codes, *a, **k))[1])
    descs, prompts = ["a calm voice", "fast and loud speech"], ["hello", "a longer line"]
    waves = engine.synthesize_batch(descs, prompts)
    assert [len(w) for w in waves] == [frames * CFGS[2].hop] * 2

    desc, desc_mask = engine._pad_ids([engine.encode_fn(d) for d in descs], 12)
    prompt, prompt_mask = engine._pad_ids([engine.encode_fn(p) for p in prompts], 8, side="left")
    enc = JP.t5_encode(ref[0], J_CFGS[0], jnp.asarray(desc), jnp.asarray(desc_mask))
    codes, _ = JP.parler_generate(ref[1], J_CFGS[1], enc, jnp.asarray(desc_mask), frames, jax.random.PRNGKey(0),
                                  prompt_ids=jnp.asarray(prompt), prompt_mask=jnp.asarray(prompt_mask),
                                  temperature=0.0, eos_token=-1, max_code=CFGS[2].codebook_size)
    np.testing.assert_array_equal(captured[0].numpy(), np.asarray(codes))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_inverse_key_map_round_trips(tmp_path):
    """``chip_smoke.py:parler_hf_state_dict`` writes seeded trees in the
    ParlerTTS layout that ``load_parler_checkpoint`` reads back: T5 and
    decoder bit-equal, the DAC (weight_g/weight_v) within 1e-6 relative."""
    trees = init_t5_numpy(CFGS[0], 0), init_parler_decoder_numpy(CFGS[1], 1), init_dac_numpy(CFGS[2], 2)
    assert "enc_proj" in trees[1]
    sd = _chip_smoke().parler_hf_state_dict(*trees, CFGS[0], CFGS[1])
    assert any(k.endswith(".weight_g") for k in sd) and not any("decoder.block." in k for k in sd)
    torch.save(sd, tmp_path / "model.pt")
    loaded = TP.load_parler_checkpoint(str(tmp_path / "model.pt"), *CFGS)
    for got, want in zip(loaded[:2], trees[:2]):
        g, w = _flat(got), _flat(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    g, w = _flat(loaded[2]), _flat(trees[2])
    assert sorted(g) == sorted(w)
    for k in w:
        assert np.abs(g[k] - w[k]).max() <= 1e-6 * np.abs(w[k]).max(), k


# ---------------------------------------------------------------------------
# parler_loss
# ---------------------------------------------------------------------------


def _loss_inputs(seed=4):
    rng = np.random.default_rng(seed)
    b, frames, K, pad = 2, 5, DEC["codebooks"], DEC["vocab"]
    codes = rng.integers(0, DEC["vocab"], (b, K, frames))
    delayed = JP.build_delay_pattern(codes, pad, frames + K - 1)
    full = np.concatenate([np.full((b, K, 1), pad), delayed], axis=2).astype(np.int32)
    mask = np.ones(full.shape, bool)
    mask[1, :, 6:] = False
    enc = rng.standard_normal((b, 6, DEC["cross_dim"])).astype(np.float32)
    enc_mask = np.arange(6)[None] < np.array([[6], [4]])
    prompt = rng.integers(0, DEC["prompt_vocab"], (b, 3)).astype(np.int32)
    prompt_mask = np.arange(3)[None] >= np.array([[0], [1]])
    return full, mask, enc, enc_mask, prompt, prompt_mask


@pytest.fixture(scope="module")
def loss_params():
    return jax.tree.map(np.asarray, JP.init_parler_decoder(jax.random.PRNGKey(2), J_CFGS[1]))


@pytest.mark.parametrize("pad_token", [None, DEC["vocab"], -1], ids=["default", "explicit", "disabled"])
def test_parler_loss_and_gradients_match_jax(loss_params, pad_token):
    """Value at atol 1e-5, every gradient leaf at atol 1e-4, with a prompt, an
    encoder mask and masked code positions."""
    inputs = _loss_inputs()

    def j_loss(p):
        return JP.parler_loss(p, J_CFGS[1], *map(jnp.asarray, inputs[:3]), jnp.asarray(inputs[3]),
                              jnp.asarray(inputs[4]), jnp.asarray(inputs[5]), pad_token=pad_token)

    j_val, j_grads = jax.value_and_grad(j_loss)(loss_params)
    params = params_from_numpy(loss_params, "cpu")
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    t_inputs = [torch.as_tensor(np.array(a)) for a in inputs]
    loss = TP.parler_loss(params, CFGS[1], *t_inputs[:3], t_inputs[3], t_inputs[4], t_inputs[5], pad_token=pad_token)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), atol=1e-5)
    ref = _flat(jax.tree.map(np.asarray, j_grads))
    assert sorted(ref) == sorted(leaves)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), ref[k], atol=1e-4, err_msg=k)


def test_parler_loss_pad_rule(loss_params):
    """``tests/test_parler.py``'s pad rule on the port: pad exclusion is on by
    default (== the explicit pad slot) and differs once disabled."""
    params = params_from_numpy(loss_params, "cpu")
    full, mask, enc = (torch.as_tensor(np.array(a)) for a in _loss_inputs()[:3])
    losses = [TP.parler_loss(params, CFGS[1], full, mask, enc, pad_token=p).item() for p in (None, DEC["vocab"], -1)]
    assert losses[0] == losses[1] and losses[0] != losses[2]


# ---------------------------------------------------------------------------
# the service's Parler checkpoint path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A local character-level fast tokenizer, loadable by AutoTokenizer."""
    from tokenizers import Regex, Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    chars = sorted(set("abcdefghijklmnopqrstuvwxyz .,"))
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, **{c: i + 3 for i, c in enumerate(chars)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex("."), behavior="isolated")
    d = tmp_path_factory.mktemp("t5_tokenizer")
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", pad_token="<pad>", eos_token="</s>")
    fast.save_pretrained(d)
    return str(d)


@pytest.fixture
def small_parler(monkeypatch):
    """The service builds ``T5Config()`` etc.; here they default to the test's widths."""
    for name, cfg in zip(("T5Config", "ParlerDecoderConfig", "DacConfig"), (T5, DEC, DAC)):
        monkeypatch.setattr(TP, name, functools.partial(getattr(TP, name), **cfg))


def _service(**kw):
    from f5tts_tpu_torch.serve.service import ModelService
    from f5tts_tpu_torch.utils.config import Settings

    return ModelService(Settings(**{"tts_model": "parler", "demo_tiny": False, "warmup": False, "device": "cpu",
                                    "dtype": "float32", "parler_max_frames": 8, "parler_desc_pad": 24,
                                    "parler_prompt_pad": 24, **kw}))


def test_service_serves_a_parler_checkpoint(checkpoint, tokenizer_dir, small_parler):
    """``ModelService(tts_model="parler")`` reads the checkpoint and the local
    tokenizer, serves a request, and a swap reloads the same model."""
    from f5tts_tpu_torch.audio.io import read_wav
    from f5tts_tpu_torch.serve.schemas import SpeechRequest

    svc = _service(parler_ckpt=checkpoint["pt"], parler_tokenizer=tokenizer_dir)
    svc.load()
    try:
        assert svc.engine.t5_cfg == CFGS[0] and "enc_proj" in svc.engine.dec_params
        assert svc.engine.encode_fn("ab c") == [6, 7, 3, 8]  # " ,." sort before the letters
        req = SpeechRequest(text="hello there.", description="a calm voice.", seed=3)
        first = svc.synthesize_sync(req)
        wave, sr = read_wav(first)
        assert sr == CFGS[2].sampling_rate and 0 < len(wave) <= 8 * CFGS[2].hop and np.isfinite(wave).all()
        svc.swap(lambda: None)  # the hot-swap path: unload, then the same loader
        assert svc.synthesize_sync(req) == first
    finally:
        svc.unload()


@pytest.mark.parametrize("missing", ["parler_ckpt", "parler_tokenizer"])
def test_service_parler_needs_a_checkpoint_and_a_tokenizer(checkpoint, tokenizer_dir, missing):
    paths = {"parler_ckpt": checkpoint["pt"], "parler_tokenizer": tokenizer_dir, missing: ""}
    with pytest.raises(ValueError) as err:
        _service(**paths).load()
    assert str(err.value) == ("tts_model=parler needs F5TPU_PARLER_CKPT and F5TPU_PARLER_TOKENIZER "
                              "(local T5 tokenizer dir)")
