"""Offline sentence batches through Indic Parler-TTS: one client in a closed
loop calling ``ParlerTTSEngine.synthesize_rows``, the primitive the service's
batcher calls, with flushes of the engine's largest batch bucket.

The mix file gives a fixed pool of ``rows`` sentences (drawn once from its
``pool_seed``: ``words_min``-``words_max`` words of the word list, Hindi and
English), row ``i`` in the voice of description ``i % len(descriptions)``,
sent in that order; the run's seed draws each row's sampling seed and the
weights. A pass sends the whole pool, so every pass does the same work on
every seed. A warm-up flush before the window builds the kernels and fills
the engine's description cache, as a deployment's named voices do. The
window is whole passes: it closes at the end of the first pass that ends
after ``--seconds``. ``voice_seconds`` is empty: a Parler row has no voice
clip, its description names the voice.

The window's readings of the program's own spans and counters are the
difference of ``GLOBAL_TIMER.totals()`` across it (``ctx.counters["timer"]``);
the traced flush's likewise (``ctx.traced_counters["timer"]``).

``correct``: after the window, 8 rows of one of its flushes (the flush drawn
from the seed, the row with the longest prompt always in the sample) are
judged against the plain reference (``reference/parler.py``) on the same
weights, token ids and codes:

- ``logit_err``: the program's cached decode path teacher-forced on the
  flush's codes at the flush's batch (``ParlerTTSEngine.replay_logits``)
  against the reference's full forward on the same codes: the RMS of the
  difference over the sample's logits, over the peak |logit| of the
  reference's;
- ``draw_mismatch``: the share of the sample's drawn tokens (every codebook
  of every frame) that the reference's own draw, from its own logits and the
  same seeded streams, does not give;
- ``wave_err``: the rows' waves against the reference's DAC over the same
  codes, pooled (``judge.pooled_err``).

With the control ``reference:fp8`` the reference held in fp8 stands in for
the program in all three.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import judge, serving
from benchmark import weights as W
from benchmark.reference import layers as L
from benchmark.reference import parler as R


def pool(cell) -> list[dict]:
    traffic = cell.traffic
    words = serving.word_list(cell)
    rng = np.random.default_rng(traffic["pool_seed"])
    descs = traffic["descriptions"]
    return [{"text": serving.sentence(rng, words, int(rng.integers(traffic["words_min"], traffic["words_max"] + 1))),
             "description": descs[i % len(descs)]} for i in range(traffic["rows"])]


def requests(cell, seed: int):
    """The pool in its fixed order, cycled, each row with a sampling seed from
    the run's seed."""
    rows = pool(cell)
    rng = np.random.default_rng(W.seed_of(seed, "traffic"))
    while True:
        for r in rows:
            yield {**r, "seed": int(rng.integers(2**31 - 1))}


def _delta(before: dict, after: dict) -> dict:
    """``GLOBAL_TIMER.totals()`` after minus before."""
    times = {k: {"count": v["count"] - before["times"].get(k, {}).get("count", 0),
                 "total_s": v["total_s"] - before["times"].get(k, {}).get("total_s", 0.0)}
             for k, v in after["times"].items()}
    return {"times": times, "counters": {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()}}


def run(ctx) -> dict:
    """Set-up, the window, the traced flush (``--trace 1``) and the judgement."""
    from f5tts_tpu_torch.models import parler as P

    if not hasattr(P, "parler_replay_logits"):
        raise RuntimeError("this program has no parler_replay_logits: the cell cannot be judged")
    from f5tts_tpu_torch.engine.ar_engine import ParlerRow
    from f5tts_tpu_torch.utils.profiling import GLOBAL_TIMER

    cell, traffic, dev, fam = ctx.cell, ctx.cell.traffic, ctx.device, ctx.family()
    engine = fam.build_engine(cell, ctx.seed, dev)
    top = engine.cfg.batch_buckets[-1]
    n_pool = traffic["rows"]
    sr = engine.dac_cfg.sampling_rate
    flushes: list[dict] = []  # per flush: its rows and results
    attempted = failed = 0

    def flush(reqs):
        nonlocal attempted, failed
        rows = [ParlerRow(r["description"], r["text"], seed=r["seed"]) for r in reqs]
        attempted += len(rows)
        with ctx.spans.span("synthesize_rows"):
            try:
                results = engine.synthesize_rows(rows)
            except Exception as e:  # a failed flush fails its rows; the run goes on
                ctx.errors.append(repr(e))
                failed += len(rows)
                return 0.0
        flushes.append({"rows": rows, "results": results})
        return sum(len(w) for w, _ in results) / sr

    def one_pass(source):
        return sum(flush([next(source) for _ in range(min(top, n_pool - k))]) for k in range(0, n_pool, top))

    flush([next(requests(cell, ctx.seed)) for _ in range(top)])  # kernels, the description cache, the allocator
    flushes.clear()
    attempted = failed = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the peak of serving, not of drawing the weights
    source = requests(cell, ctx.seed)
    before = GLOBAL_TIMER.totals()
    audio_s, t0 = 0.0, time.perf_counter()
    ctx.counters["setup_done"] = time.time()
    passes = []
    while True:
        t1 = time.perf_counter()
        passes.append((one_pass(source), time.perf_counter() - t1))
        audio_s += passes[-1][0]
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.window_s = time.perf_counter() - t0
    ctx.counters["timer"] = _delta(before, GLOBAL_TIMER.totals())
    print("passes (audio s, wall s):", [(round(a, 2), round(s, 3)) for a, s in passes], file=sys.stderr)
    window = {"attempted": attempted, "failed": failed}
    window_flushes = list(flushes)
    if ctx.trace:
        from benchmark.trace import profile

        source, before = requests(cell, ctx.seed), GLOBAL_TIMER.totals()
        traced = traffic["trace_flushes"]
        ctx.traced = profile(lambda: [flush([next(source) for _ in range(top)]) for _ in range(traced)], dev, ctx.spans)
        ctx.traced_counters["timer"] = _delta(before, GLOBAL_TIMER.totals())
    ctx.counters["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    departures = fam.departures(engine, cell)
    sample = pick_sample(ctx, window_flushes)
    # the program's logits: its cached decode path teacher-forced on the flush's codes, at the flush's batch
    got_logits = (engine.replay_logits(sample["rows"], sample["codes"], sample["picked"]).float()
                  if sample and ctx.control != "reference:fp8" else None)
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge_sample(ctx, sample, got_logits)
    checks["departures"] = {"value": departures, "limit": cell.workload["limits"]["departures"]}
    return {**window, "checks": checks, "end_to_end": {"audio_s_per_s": audio_s / ctx.window_s}}


def pick_sample(ctx, flushes: list[dict]) -> dict | None:
    """One of the window's flushes, drawn from the seed, and the rows of it
    to judge: ``{"rows", "codes", "waves", "picked"}`` (None: no flush)."""
    rng = np.random.default_rng(W.seed_of(ctx.seed, "sample"))
    if not flushes:
        return None
    f = flushes[int(rng.integers(len(flushes)))]
    tok = ctx.cell.config["tokenizer"]
    picked = judge.sample(rng, [len(R.token_ids(r.prompt, tok)) for r in f["rows"]], ctx.cell.workload["sample_rows"])
    return {"rows": f["rows"], "codes": [c for _, c in f["results"]], "waves": [w for w, _ in f["results"]],
            "picked": picked}


def judge_sample(ctx, sample: dict | None, got_logits) -> dict:
    """``logit_err``, ``draw_mismatch`` and ``wave_err`` of the sampled rows
    (the module's docstring); ``got_logits`` the program's replay of them."""
    cell, dev, fam = ctx.cell, ctx.device, ctx.family()
    lim = cell.workload["limits"]
    if sample is None:
        return {k: {"value": math.inf, "limit": lim[k]} for k in ("logit_err", "draw_mismatch", "wave_err")}
    m, stated, tok = cell.config["model"], fam.stated_engine(cell), cell.config["tokenizer"]
    fp8 = ctx.control == "reference:fp8"
    picked, codes = sample["picked"], sample["codes"]
    weights = fam.make_weights(cell, ctx.seed, dev)
    dec = m["decoder"]
    K, frames = dec["codebooks"], stated["max_frames"]
    steps, pad = frames + K - 1, dec["vocab"]
    sub = [sample["rows"][i] for i in picked]
    lengths = [codes[i].shape[1] for i in picked]
    full = torch.zeros((len(sub), K, frames), dtype=torch.long)
    for n, i in enumerate(picked):
        full[n, :, : lengths[n]] = torch.as_tensor(codes[i])
    full = full.to(dev)
    streams = torch.stack([R.delay_stream(full[n], lengths[n], steps, pad) for n in range(len(sub))])
    desc, desc_mask = R.padded([R.token_ids(r.description, tok) for r in sub], stated["desc_pad"], False, dev)
    prompt, prompt_mask = R.padded([R.token_ids(r.prompt, tok) for r in sub], stated["prompt_pad"], True, dev)

    def forward(precision):
        with judge.full_fp32():
            L.PRECISION["all"] = precision
            try:
                enc = R.t5_encode(weights["t5"], m["t5"], desc, desc_mask)
                logits = R.decoder_logits(weights["decoder"], dec, enc, desc_mask, prompt, prompt_mask, streams)
                tokens = [R.draw(logits[n], r.seed, stated["temperature"], stated["top_k"]) for n, r in enumerate(sub)]
                waves = R.dac_decode(weights["dac"], m["dac"], full)
            finally:
                L.PRECISION["all"] = None
        return logits, tokens, waves

    ref_logits, ref_tokens, ref_waves = forward(None)
    if fp8:
        got_logits, got_tokens, got_waves = forward("fp8")
        got_waves = [w[: lengths[n] * _hop(m)].cpu().numpy() for n, w in enumerate(got_waves)]
    else:
        got_waves = [sample["waves"][i] for i in picked]
    ref_waves = [w[: lengths[n] * _hop(m)].cpu().numpy() for n, w in enumerate(ref_waves)]
    logit_err = math.inf  # a replay of another shape reads inf
    if got_logits.shape == ref_logits.shape:
        diff = (got_logits.double() - ref_logits.double()).pow(2).mean().sqrt()
        logit_err = float(diff / ref_logits.abs().max().double())
    mismatch = total = 0
    for n in range(len(sub)):
        # the program's draws by position (code (k, i) was drawn at position i + 1 + k), -1 where none was
        drawn = R.delay_stream(full[n], lengths[n], steps, -1).T
        got = got_tokens[n] if fp8 else drawn
        mismatch += int(((got != ref_tokens[n]) & (drawn >= 0)).sum())
        total += int((drawn >= 0).sum())
    return {"logit_err": {"value": logit_err, "limit": lim["logit_err"]},
            "draw_mismatch": {"value": mismatch / total if total else math.inf, "limit": lim["draw_mismatch"]},
            "wave_err": {"value": judge.pooled_err(zip(got_waves, ref_waves)), "limit": lim["wave_err"]}}


def _hop(m) -> int:
    return math.prod(m["dac"]["rates"])

