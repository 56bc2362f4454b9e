"""The port's Indic Parler-TTS against the benchmark's plain reference
(``benchmark/reference/parler.py``, plain float32 PyTorch written from the
published equations) on the CPU at a tiny geometry with 9 codebooks, on seeded
weights and the kernels' plain versions: the T5 states, prefill then cached
decode (``parler_replay_logits``) against the full forward, the codes
``synthesize_rows`` returns against the reference's draw from the same
streams, the DAC, and the engine's spans and counters.

Tolerance: the largest |difference| over the peak |value| at most ``TOL``
(1e-4). Both sides compute in float32 and differ only in the order of their
sums (~1e-7 of the peak); the port in bf16 rounds every product's operands to
8 bits of mantissa (~4e-3) and must fail it, which the last tests check."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import weights as W  # noqa: E402
from benchmark.backbones import parler as BP  # noqa: E402
from benchmark.reference import parler as R  # noqa: E402
from f5tts_tpu_torch.engine.ar_engine import ParlerEngineConfig, ParlerRow, ParlerTTSEngine  # noqa: E402
from f5tts_tpu_torch.models import parler as P  # noqa: E402
from f5tts_tpu_torch.models.convert import parler_params_from_numpy  # noqa: E402
from f5tts_tpu_torch.utils.profiling import GLOBAL_TIMER  # noqa: E402

TOL = 1e-4
M = {
    "t5": {"vocab": 200, "d_model": 32, "d_kv": 8, "d_ff": 48, "heads": 4, "layers": 2, "rel_buckets": 8,
           "rel_max_dist": 20},
    "decoder": {"vocab": 40, "codebooks": 9, "hidden": 32, "layers": 2, "heads": 4, "ffn": 64, "cross_dim": 32,
                "prompt_vocab": 200},
    "dac": {"num_codebooks": 9, "codebook_size": 32, "codebook_dim": 4, "latent_dim": 16, "decoder_dim": 16,
            "rates": [2, 2], "sampling_rate": 44100},
}
TOK = {"seed": 5, "pieces_per_word": 2, "first_id": 3, "end_id": 200}
DESCS = ["a calm clear voice at a moderate pace.", "a fast bright voice.", "a slow deep voice in a quiet room today."]
TEXTS = ["hello there, friend.", "भारत एक देश है।", "one two three four five six."]
FRAMES = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """``(reference tree (fp32 tensors), the program's numpy trees)`` of one seed."""
    ref = W.make(BP.layout(M), 1234, torch.device("cpu"))
    return ref, BP.program_trees(W.to_numpy(ref))


def _port(trees, dtype=torch.float32):
    return parler_params_from_numpy(*trees[1], "cpu", dtype)


def _inputs():
    desc, desc_mask = R.padded([R.token_ids(d, TOK) for d in DESCS], 24, False, "cpu")
    prompt, prompt_mask = R.padded([R.token_ids(t, TOK) for t in TEXTS], 24, True, "cpu")
    return desc, desc_mask, prompt, prompt_mask


def _err(got, want) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


def _codes(seed=0, high=None):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, high or M["decoder"]["vocab"], (len(DESCS), 9, FRAMES), generator=g)


def _t5(trees, dtype):
    t5, _, _ = _port(trees, dtype)
    desc, desc_mask, _, _ = _inputs()
    got = P.t5_encode(t5, P.T5Config(**M["t5"]), desc, desc_mask, compute_dtype=dtype)
    return got, R.t5_encode(trees[0]["t5"], M["t5"], desc, desc_mask)


def _replay(trees, dtype, fuse):
    _, dec, _ = _port(trees, dtype)
    desc, desc_mask, prompt, prompt_mask = _inputs()
    enc = R.t5_encode(trees[0]["t5"], M["t5"], desc, desc_mask)
    stream = torch.as_tensor(P.build_delay_pattern(_codes().numpy(), M["decoder"]["vocab"], FRAMES + 8))
    cfg = P.ParlerDecoderConfig(**M["decoder"], fuse_decode_qkv=fuse)
    got = P.parler_replay_logits(dec, cfg, enc.to(dtype), desc_mask, stream, [2, 0], prompt_ids=prompt,
                                 prompt_mask=prompt_mask, compute_dtype=dtype)
    want = R.decoder_logits(trees[0]["decoder"], M["decoder"], enc, desc_mask, prompt, prompt_mask, stream)
    return got, want[[2, 0]]


def _dac(trees, dtype):
    _, _, dac = _port(trees, dtype)
    codes = _codes(1, M["dac"]["codebook_size"])
    cfg = P.DacConfig(**{**M["dac"], "rates": tuple(M["dac"]["rates"])})
    return P.dac_decode_codes(dac, codes, cfg, compute_dtype=dtype), R.dac_decode(trees[0]["dac"], M["dac"], codes)


def test_t5_states_match_the_reference(trees):
    got, want = _t5(trees, torch.float32)
    assert got.shape == want.shape and _err(got, want) < TOL


@pytest.mark.parametrize("fuse", [False, True])
def test_prefill_then_cached_decode_matches_the_full_forward(trees, fuse):
    got, want = _replay(trees, torch.float32, fuse)
    assert got.shape == (2, FRAMES + 8, 9, M["decoder"]["vocab"]) == want.shape
    assert _err(got, want) < TOL


def test_dac_matches_the_reference(trees):
    got, want = _dac(trees, torch.float32)
    assert got.shape == want.shape == (len(DESCS), FRAMES * 4) and _err(got, want) < TOL


def _engine(trees, **kw):
    cfg = P.T5Config(**M["t5"]), P.ParlerDecoderConfig(**M["decoder"]), P.DacConfig(
        **{**M["dac"], "rates": tuple(M["dac"]["rates"])})
    t5, dec, dac = trees[1]
    opts = dict(max_frames=FRAMES, desc_pad=24, prompt_pad=24, eos_token=-1, compute_dtype="float32",
                batch_buckets=(1, 2, 4), **kw)
    return ParlerTTSEngine(t5, cfg[0], dec, cfg[1], dac, cfg[2], ParlerEngineConfig(**opts),
                           encode_fn=lambda s: R.token_ids(s, TOK), device="cpu")


@pytest.mark.parametrize("top_k", [0, 7])
def test_synthesize_rows_codes_are_the_references_draws(trees, top_k):
    """Every drawn token equals the reference's own draw from its own logits
    over the returned codes and the same (seed, row seed, position) stream:
    in float32 the two logits differ by ~1e-7, and the exponential race flips
    only where two candidates' ratios lie that close."""
    engine = _engine(trees, temperature=1.0, top_k=top_k)
    rows = [ParlerRow(d, t, seed=100 + i) for i, (d, t) in enumerate(zip(DESCS, TEXTS))]
    results = engine.synthesize_rows(rows)
    desc, desc_mask, prompt, prompt_mask = _inputs()
    enc = R.t5_encode(trees[0]["t5"], M["t5"], desc, desc_mask)
    codes = torch.stack([torch.as_tensor(c) for _, c in results])
    assert codes.shape == (3, 9, FRAMES)
    pad, steps = M["decoder"]["vocab"], FRAMES + 8
    stream = torch.stack([R.delay_stream(c, FRAMES, steps, pad) for c in codes])
    logits = R.decoder_logits(trees[0]["decoder"], M["decoder"], enc, desc_mask, prompt, prompt_mask, stream)
    for n, row in enumerate(rows):
        drawn = R.draw(logits[n], row.seed, 1.0, top_k)  # (steps, K): position s + 1
        assert torch.equal(R.delay_stream(codes[n], FRAMES, steps, -1).T, torch.where(stream[n].T == pad, -1, drawn))
    # the returned waves are the DAC over the codes, specials read as 0
    waves = R.dac_decode(trees[0]["dac"], M["dac"], codes)
    for (w, _), ref in zip(results, waves):
        assert _err(torch.as_tensor(w), ref) < TOL


def test_spans_and_counters_once_a_flush(trees):
    engine = _engine(trees)
    rows = [ParlerRow(d, t, seed=i) for i, (d, t) in enumerate(zip(DESCS, TEXTS))]
    seen = []
    for _ in range(2):  # a description-cache miss, then a hit
        before = GLOBAL_TIMER.totals()
        engine.synthesize_rows(rows)
        after = GLOBAL_TIMER.totals()
        seen.append(({k: after["counters"][k] - before["counters"].get(k, 0) for k in after["counters"]
                      if k.startswith("parler.")},
                     {k: v["count"] - before["times"].get(k, {}).get("count", 0) for k, v in after["times"].items()
                      if k.startswith("parler.")}))
    steps = FRAMES + 8  # positions 1 .. frames + K - 1
    common = {"parler.flushes": 1, "parler.rows": 4, "parler.positions": steps, "parler.row_positions": 4 * steps,
              "parler.frames": 4 * FRAMES}
    (c0, t0), (c1, t1) = seen
    assert {k: v for k, v in c0.items() if v} == {**common, "parler.encode_rows": 4}
    assert {k: v for k, v in c1.items() if v} == {**common, "parler.desc_cache_hits": 4}
    spans = {"parler.prefill": 1, "parler.decode": 1, "parler.dac": 1, "parler.finalize": 1}
    assert {k: v for k, v in t0.items() if v} == {**spans, "parler.encode": 1}  # no device events on the CPU
    assert {k: v for k, v in t1.items() if v} == spans


@pytest.mark.parametrize("part", ["t5", "replay", "dac"])
def test_the_port_in_bf16_fails_the_tolerance(trees, part):
    """The tolerance is tight enough that the port computing in bf16, where
    these tests state float32, fails it."""
    if part == "t5":
        got, want = _t5(trees, torch.bfloat16)
    elif part == "replay":
        got, want = _replay(trees, torch.bfloat16, True)
    else:
        got, want = _dac(trees, torch.bfloat16)
    assert np.isfinite(_err(got, want)) and _err(got, want) > TOL
