"""Offline long-form batches: one client in a closed loop making the calls of
``cli/infer_batch.py``'s loop.

The mix file gives a fixed pool of paragraphs (drawn once from its
``pool_seed``: ``paragraphs`` of ``words_min``-``words_max`` words from the
word list, voice ``i % len(voice_seconds)``), sent in that order; the run's
seed draws each request's noise seed, the voices' signals and the weights.
Requests are prepared one by one (``TTSEngine.prepare_request``); whenever the
pending rows fill the largest batch bucket they go through
``synthesize_rows`` together, and each request is finalized
(``finalize_request``). One pass sends the whole pool and flushes what is
left at its end, so every pass does the same work, on every seed. The window
is whole passes: it starts at the first request and closes at the end of the
first pass that ends after ``--seconds``, so every run's rate is that of the
same work, whichever pass the time runs out in (flushes differ in their
audio, so a window cut at a flush would rate different work).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import judge, serving
from benchmark import weights as W


def pool(cell) -> list[dict]:
    traffic = cell.traffic
    words = serving.word_list(cell)
    rng = np.random.default_rng(traffic["pool_seed"] + 1)
    nv = len(traffic["voice_seconds"])
    return [{"text": serving.paragraph(rng, words, int(rng.integers(traffic["words_min"], traffic["words_max"] + 1))),
             "voice": i % nv} for i in range(traffic["paragraphs"])]


def requests(cell, seed: int):
    """The pool in its fixed order, cycled, each request with a noise seed
    from the run's seed."""
    paras = pool(cell)
    rng = np.random.default_rng(W.seed_of(seed, "traffic"))
    while True:
        for p in paras:
            yield {**p, "seed": int(rng.integers(2**31 - 1))}


def warm_shapes(engine, voices: list[dict]) -> list[tuple[int, int]]:
    """The (duration bucket, batch bucket) programs ``synthesize_rows`` can run
    for this traffic: the buckets from the shortest reference's up to the
    chunk budget, each at every batch bucket up to its solve cap."""
    cfg = engine.cfg
    caps = dict(cfg.solve_batch_caps)
    shortest = min(len(v["audio"]) for v in voices) // cfg.mel.hop_length + 2
    out = []
    budget = cfg.chunk_frames_budget or cfg.max_duration  # None: chunks by the reference's byte budget
    for nb in cfg.duration_buckets:
        if nb < judge.S.bucket_of(shortest, cfg.duration_buckets) or nb > budget:
            continue
        cap = min(caps.get(nb, cfg.batch_buckets[-1]), cfg.batch_buckets[-1])
        out += [(nb, bb) for bb in cfg.batch_buckets if bb <= cap]
    return out


class _SolveCounter:
    """Wraps ``bucket_program``: the shape and steps of every solve, read from
    its arguments (no device value is read)."""

    def __init__(self, engine):
        self.solves: list[tuple[int, int, int]] = []
        inner = engine.bucket_program

        def counted(cond, *args, **kw):
            self.solves.append((cond.shape[0], cond.shape[1], kw["steps"]))
            return inner(cond, *args, **kw)

        engine.bucket_program = counted


CONTROLS = {"program:int8": {"quantization": "int8"}}  # the program's own lower-precision paths


def run(ctx) -> dict:
    """Set-up, the window, the traced part (``--trace 1``) and the judgement.
    Returns the run's numbers for the result line."""
    from f5tts_tpu_torch.audio.preprocess import clip_ref_audio, ensure_sentence_punctuation

    cell, traffic, dev = ctx.cell, ctx.cell.traffic, ctx.device
    engine = serving.build_engine(cell, ctx.seed, dev, **CONTROLS.get(ctx.control, {}))
    voices = serving.voices(cell, ctx.seed)
    refs = [(clip_ref_audio(v["audio"], serving.SR), ensure_sentence_punctuation(v["text"])) for v in voices]
    engine.warmup(warm_shapes(engine, voices), nfe_step=2)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counter = _SolveCounter(engine)
    top = engine.cfg.batch_buckets[-1]
    n_pool = traffic["paragraphs"]
    served: list[dict] = []  # per request: its plan, results, paragraph, voice, seed
    attempted = failed = 0

    def flush(pending):
        nonlocal failed
        rows = [r for p in pending for r in p["plan"].rows]
        with ctx.spans.span("synthesize_rows"):
            try:
                results = engine.synthesize_rows(rows)
            except Exception as e:  # a failed flush fails its requests; the run goes on
                ctx.errors.append(repr(e))
                failed += len(pending)
                return 0.0
        pos, audio = 0, 0.0
        for p in pending:
            k = len(p["plan"].rows)
            with ctx.spans.span("finalize_request"):
                wave, sr, _ = engine.finalize_request(p["plan"], results[pos : pos + k])
            p["results"] = results[pos : pos + k]
            pos += k
            audio += len(wave) / sr
            served.append(p)
        return audio

    def prepare(req):
        nonlocal attempted
        ref_audio, ref_text = refs[req["voice"]]
        attempted += 1
        with ctx.spans.span("prepare_request"):
            plan = engine.prepare_request(req["text"], ref_audio, serving.SR, ref_text, seed=req["seed"])
        return {**req, "plan": plan}

    def one_flush(source):
        pending = []
        while sum(len(p["plan"].rows) for p in pending) < top:
            pending.append(prepare(next(source)))
        return flush(pending)

    def one_pass(source):
        audio, pending = 0.0, []
        for _ in range(n_pool):
            pending.append(prepare(next(source)))
            if sum(len(p["plan"].rows) for p in pending) >= top:
                audio += flush(pending)
                pending = []
        return audio + (flush(pending) if pending else 0.0)

    one_flush(requests(cell, ctx.seed))  # before the window: pinned host buffers, the fetch pipeline's depth
    served.clear()
    counter.solves.clear()
    ctx.spans.times.clear()
    attempted = failed = 0
    source = requests(cell, ctx.seed)
    audio_s, t0 = 0.0, time.perf_counter()
    ctx.counters["setup_done"] = time.time()
    passes = []
    while True:
        t1 = time.perf_counter()
        passes.append((one_pass(source), time.perf_counter() - t1))
        audio_s += passes[-1][0]
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    print("passes (audio s, wall s):", [(round(a, 2), round(s, 3)) for a, s in passes], file=sys.stderr)
    ctx.window_s = time.perf_counter() - t0
    ctx.counters["spans"] = {k: list(v) for k, v in ctx.spans.times.items()}
    window = {"attempted": attempted, "failed": failed}
    ctx.counters.update(audio_s=audio_s, solves=list(counter.solves), requests=len(served),
                        rows_needed=sum(min(r.duration, _bucket(engine, r)) for p in served for r in p["plan"].rows))
    if ctx.trace:
        from benchmark.trace import profile

        counter.solves.clear()
        source = requests(cell, ctx.seed)
        ctx.traced = profile(lambda: [one_flush(source) for _ in range(traffic["trace_flushes"])], dev, ctx.spans)
        ctx.traced_counters["solves"] = list(counter.solves)
    ctx.counters["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    departures = serving.departures(engine, cell)
    window_requests = served[: ctx.counters["requests"]]
    del engine, counter
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = {**judge_offline(ctx, voices, window_requests),
              "departures": {"value": departures, "limit": cell.workload["limits"]["departures"]}}
    return {**window, "checks": checks,
            "end_to_end": {"audio_s_per_s": audio_s / ctx.window_s}}


def _bucket(engine, row) -> int:
    return judge.S.bucket_of(max(row.duration, row.ref_frames + 2), engine.cfg.duration_buckets)


def judge_offline(ctx, voices: list[dict], served: list[dict]) -> dict:
    """The sampled rows of the window against the reference."""
    cell, dev = ctx.cell, ctx.device
    wl = cell.workload
    rows = [(p, i) for p in served for i in range(len(p["plan"].rows))]
    rng = np.random.default_rng(W.seed_of(ctx.seed, "sample"))
    picked = [rows[k] for k in judge.sample(rng, [p["plan"].rows[i].duration for p, i in rows], wl["sample_rows"])]
    vin = [judge.voice_inputs(cell.config, v, dev) for v in voices]
    items = [{"voice": vin[p["voice"]], "text": p["plan"].rows[i].text, "duration": p["plan"].rows[i].duration,
              "seed": p["seed"], "covered": judge.chunks_cover(p["text"], [r.text for r in p["plan"].rows],
                                                              vin[p["voice"]]["text"])} for p, i in picked]
    got = [p["results"][i][::-1] for p, i in picked]  # (wave, mel) -> (mel, wave)
    mel_err, wave_err = judge.judge_rows(ctx, items, got)
    ctx.counters["rows_compared"] = len(picked)
    lim = wl["limits"]
    return {"mel_err": {"value": mel_err, "limit": lim["mel_err"]},
            "wave_err": {"value": wave_err, "limit": lim["wave_err"]}}
