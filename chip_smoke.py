"""On-card smoke test of the PyTorch/CUDA port (``f5tts_tpu_torch``).

    python3 chip_smoke.py               # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels-only

Phases, each of which fails the run (non-zero exit) on any error:

1. build every CUDA kernel of the synthesis path from ``f5tts_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. kernels: each kernel against its plain PyTorch version on the card at the
   main-path shapes (F5-TTS Base, fused CFG at batch 8: 16 rows of 1024
   frames), max abs error on valid rows against a stated tolerance, median
   times over 20 runs (CUDA events) of the kernel, its plain version and one
   PyTorch library call of the same function, and the least time the card
   could take (``bound_ms``);
3. engine: ``TTSEngine.synthesize`` at F5-TTS Base width (random weights from a
   seed) for three requests, one of which chunks into several rows of the
   1024-frame bucket; the launch counts of each kernel, set to 0 just before,
   must equal what the solves need; the waveforms must be finite, non-zero
   and of the planned length; a small-input parity check of the serving path
   (bf16 + kernels) against the fp32 plain path;
4. bench geometry: batch 8, 1024-frame bucket, 128 reference frames, text_pad
   512, Ralston NFE 20, CFG 2, bf16 — wall time and audio-seconds per second;
5. training kernels (with phase 2): the forward-with-logsumexp and backward
   attention kernels at the training shape (F5-TTS Base heads, bf16, one
   38 400-frame batch packed as 37 x 1024, a ragged n = 1000 and the 30-s
   bucket n = 3072) against their fp32 plain versions, with times, bounds and
   SDPA forward / backward as the library yardstick;
6. training: ``Trainer`` at F5-TTS Base width (full depth, random init from
   seed 0), bf16 compute over fp32 params, AdamW + EMA, five steps on
   synthetic frame-packed batches of ~38 400 frames (one of them 12 x 3072);
   launch counts per step against the design (44 forward launches with the
   per-block recompute, 44 backward launches = 22 x (dK/dV + dQ), 2 conv-pos
   launches), finite loss and gradient norm, params that move, step time and
   mel-frames/s, a profiler breakdown of one step; and one step's gradients
   through the kernels (bf16) against the fp32 plain path on a small
   geometry.

The last lines are the card's name and power limit, one ``{"kernels": [...]}``
JSON line and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ATTN_TOL = 2e-2  # bf16 kernel vs fp32 plain on the same bf16 inputs
CONV_TOL = 3e-2  # bf16 (bf16 intermediate) vs fp32 plain (fp32 intermediate)
LSE_TOL = 1e-3  # training forward's lse: fp32 in both, scores from the same bf16 inputs
GRAD_TOL = 3e-2  # attention gradients, max abs error over max(1, peak |ref|): p and dS rounded to bf16
TRAIN_GRAD_RTOL = 5e-2  # relative L2 of a bf16 kernel train step's gradients vs the fp32 plain path
HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def attention_phase(dev) -> dict:
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_attention_plain
    from f5tts_tpu_torch.ops.rope import apply_rotary_per_head, rotary_freqs

    b, h, n, d = 16, 16, 1024, 64  # fused CFG at batch 8: 2*8 rows, F5-TTS Base heads
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((b, h, n, d), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    lens = torch.randint(n // 2, n + 1, (b,), generator=g).to(dev)
    lens[0] = n
    mask = torch.arange(n, device=dev)[None, :] < lens[:, None]
    freqs = torch.as_tensor(rotary_freqs(n, d), device=dev)

    out = flash_attention(q, k, v, mask, rope_freqs=freqs)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), mask, freqs)
    err = float(((out.float() - ref).abs() * mask[:, None, :, None]).max())
    log(f"attention: kernel vs fp32 plain, max abs err on valid rows {err:.3e} (tol {ATTN_TOL})")
    check(np.isfinite(err) and err <= ATTN_TOL, f"flash_attention error {err} > {ATTN_TOL}")

    # off-main-path variants: fp32 inputs, all-heads RoPE, a ragged n, a batch
    # row whose keys are all masked (every key then weighs the same)
    for dtype, rope_all, nn_, dead_row in ((torch.float32, False, 1024, False), (torch.bfloat16, True, 1000, False),
                                           (torch.bfloat16, False, 256, True)):
        qs, ks, vs = (t[:2, :, :nn_].to(dtype).contiguous() for t in (q, k, v))
        ms = mask[:2, :nn_].clone()
        if dead_row:
            ms[1] = False
        fs = freqs[:nn_].contiguous()
        o2 = flash_attention(qs, ks, vs, ms, rope_freqs=fs, rope_all_heads=rope_all)
        r2 = flash_attention_plain(qs.float(), ks.float(), vs.float(), ms, fs, rope_all)
        rows = ms | ~ms.any(-1, keepdim=True)  # valid query rows; all rows of a dead batch row
        e2 = float(((o2.float() - r2).abs() * rows[:, None, :, None]).max())
        tol = 1e-4 if dtype == torch.float32 else ATTN_TOL
        log(f"attention {dtype} rope_all={rope_all} n={nn_} all-masked row={dead_row}: max abs err {e2:.3e} (tol {tol})")
        check(e2 <= tol, f"flash_attention variant error {e2} > {tol}")

    ms_kernel = time_ms(lambda: flash_attention(q, k, v, mask, rope_freqs=freqs))
    ms_plain = time_ms(lambda: flash_attention_plain(q, k, v, mask, freqs))
    qr, kr = apply_rotary_per_head(q[:, :1], freqs), apply_rotary_per_head(k[:, :1], freqs)
    qr, kr = torch.cat([qr, q[:, 1:]], 1), torch.cat([kr, k[:, 1:]], 1)
    bias = torch.where(mask, 0.0, -1e30)[:, None, None, :].to(torch.bfloat16)
    ms_lib = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=bias))
    flops = 4.0 * b * h * n * n * d
    nbytes = 4 * b * h * n * d * 2 + b * n + 2 * n * d * 4  # q, k, v, o + mask + cos/sin tables
    bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"attention times: kernel {ms_kernel:.4f} ms, plain {ms_plain:.4f} ms, "
        f"library (SDPA on pre-roped q/k) {ms_lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "flash_attention", "route": "cuda", "source": "f5tts_tpu_torch/csrc/flash_attention.cu",
            "replaces": "f5tts_tpu/ops/pallas/flash_attention.py:250", "max_abs_err": err, "ms": ms_kernel,
            "plain_ms": ms_plain, "bound_ms": bms, "bound_by": by, "library_ms": ms_lib}


def conv_phase(dev) -> dict:
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos, conv_pos_plain, mish

    b, n, c, kw, groups = 16, 1024, 1024, 31, 16
    cg = c // groups
    g = torch.Generator(device="cpu").manual_seed(1)
    bound = 1.0 / (cg * kw) ** 0.5
    w1, w2 = ((torch.rand((kw, cg, c), generator=g) * 2 - 1) * bound for _ in range(2))
    b1, b2 = ((torch.rand((c,), generator=g) * 2 - 1) * bound for _ in range(2))
    w1, w2, b1, b2 = (t.to(dev, torch.bfloat16) for t in (w1, w2, b1, b2))
    lens = torch.randint(n // 2, n + 1, (b,), generator=g).to(dev, torch.int32)
    lens[0] = n
    mask = torch.arange(n, device=dev)[None, :] < lens[:, None]
    x = torch.randn((b, n, c), generator=g).to(dev, torch.bfloat16) * mask[..., None]

    out = conv_pos(x, w1, b1, w2, b2, lens)
    torch.cuda.synchronize()
    ref = conv_pos_plain(x.float(), w1.float(), b1.float(), w2.float(), b2.float(), lens)
    err = float(((out.float() - ref).abs() * mask[..., None]).max())
    log(f"conv_pos: kernel vs fp32 plain, max abs err on valid rows {err:.3e} (tol {CONV_TOL})")
    check(np.isfinite(err) and err <= CONV_TOL, f"conv_pos error {err} > {CONV_TOL}")

    # off-main-path variants: fp32 (CUDA-core path), and a group width other than 64
    xs = x[:2, :300].float().contiguous()
    o2 = conv_pos(xs, w1.float(), b1, w2.float(), b2, lens[:2].clamp(max=300))
    r2 = conv_pos_plain(xs, w1.float(), b1, w2.float(), b2, lens[:2].clamp(max=300))
    e2 = float((o2 - r2).abs().max())
    log(f"conv_pos fp32 n=300: max abs err {e2:.3e} (tol 1e-4)")
    check(e2 <= 1e-4, f"conv_pos fp32 error {e2}")
    xs = x[:2, :200, :128].contiguous()
    ws1, ws2 = w1[:, :8, :128].contiguous(), w2[:, :8, :128].contiguous()
    o3 = conv_pos(xs, ws1, b1[:128], ws2, b2[:128], lens[:2].clamp(max=200))
    r3 = conv_pos_plain(xs.float(), ws1.float(), b1[:128].float(), ws2.float(), b2[:128].float(),
                        lens[:2].clamp(max=200))
    e3 = float((o3.float() - r3).abs().max())
    log(f"conv_pos bf16 group width 8: max abs err {e3:.3e} (tol {CONV_TOL})")
    check(e3 <= CONV_TOL, f"conv_pos narrow-group error {e3}")

    ms_kernel = time_ms(lambda: conv_pos(x, w1, b1, w2, b2, lens))
    ms_plain = time_ms(lambda: conv_pos_plain(x, w1, b1, w2, b2, lens))
    xt = x.transpose(1, 2).contiguous()
    wt1, wt2 = w1.permute(2, 1, 0).contiguous(), w2.permute(2, 1, 0).contiguous()

    def library():
        y = mish(F.conv1d(xt, wt1, b1, padding=kw // 2, groups=groups))
        return mish(F.conv1d(y, wt2, b2, padding=kw // 2, groups=groups))

    ms_lib = time_ms(library)
    flops = 2 * 2.0 * b * n * c * kw * cg
    nbytes = 2 * b * n * c * 2 + 2 * (kw * cg * c * 2 + c * 2) + b * 4  # x, y; weights, biases; lens
    bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"conv_pos times: kernel pair {ms_kernel:.4f} ms, plain {ms_plain:.4f} ms, "
        f"library (2x F.conv1d groups=16 + Mish) {ms_lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "conv_pos", "route": "cuda", "source": "f5tts_tpu_torch/csrc/conv_pos.cu",
            "replaces": "f5tts_tpu/ops/pallas/conv_pos.py:141", "max_abs_err": err, "ms": ms_kernel,
            "plain_ms": ms_plain, "bound_ms": bms, "bound_by": by, "library_ms": ms_lib}


# ---------------------------------------------------------------------------
# engine phase
# ---------------------------------------------------------------------------


def synthetic_ref(seconds: float, f0: float, seed: int, sr: int = 24000) -> np.ndarray:
    """A voiced-sounding reference clip: harmonics of f0 with a syllable-rate
    envelope and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wave = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t) ** 2
    return (0.1 * wave * env + 0.005 * rng.standard_normal(t.shape)).astype(np.float32)


def planned_length(engine, plan) -> int:
    """Samples of the stitched waveform the plan must produce."""
    n_fade = int(plan.cross_fade_duration * 24000)
    total = None
    for r in plan.rows:
        nb = min(b for b in engine.cfg.duration_buckets if b >= max(r.duration, r.ref_frames + 2))
        seg = engine._wave_samples(min(r.duration, nb) - min(r.ref_frames, nb))
        total = seg if total is None else total + seg - min(n_fade, total, seg)
    return total


def engine_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, launches: dict) -> None:
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention
    from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm

    engine = TTSEngine(dit_np, dit_cfg, voc_np, tok, EngineConfig(vocoder=voc_cfg), device=dev)
    solves = []
    program = engine.bucket_program

    def counted(*a, **kw):
        solves.append((kw["steps"], a[0].shape[0]))
        return program(*a, **kw)

    engine.bucket_program = counted
    requests = [
        ("Hello there, this is a short test of the ported engine.", synthetic_ref(2.5, 140.0, 0),
         "A short reference clip."),
        ("नमस्ते, यह एक लंबा परीक्षण वाक्य है जो कई हिस्सों में बाँटा जाएगा। " * 4
         + "The same request mixes scripts, so the chunker packs words into several rows of one bucket.",
         synthetic_ref(3.0, 110.0, 1), "यह संदर्भ वाक्य है।"),
        ("ನಮಸ್ಕಾರ, ಇದು ಮೂರನೇ ವಿನಂತಿ.", synthetic_ref(4.0, 180.0, 2), "Reference speech for the third voice."),
    ]
    n_blocks = dit_cfg.depth
    forwards_per_step = 2  # ralston: two model evals per interval, each one fused 2b-row forward
    flash_attention.launches = 0
    conv_pos.launches = 0
    t0 = time.perf_counter()
    for i, (text, ref, ref_text) in enumerate(requests):
        plan = engine.prepare_request(text, ref, 24000, ref_text, seed=i)
        t_req = time.perf_counter()
        wave, sr, mel = engine.synthesize(text, ref, 24000, ref_text, seed=i)
        torch.cuda.synchronize()
        want = planned_length(engine, plan)
        log(f"request {i}: {len(plan.rows)} rows, {len(wave) / sr:.3f} s of audio in "
            f"{time.perf_counter() - t_req:.3f} s; mel {mel.shape}")
        check(sr == 24000 and wave.ndim == 1 and len(wave) == want, f"request {i}: {len(wave)} samples, want {want}")
        check(bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) > 0, f"request {i}: wave not finite/non-zero")
        check(bool(np.isfinite(mel).all()), f"request {i}: mel not finite")
    wall = time.perf_counter() - t0
    launches["flash_attention"]["serve"] = flash_attention.launches
    launches["conv_pos"]["serve"] = conv_pos.launches
    n_forwards = sum(steps * forwards_per_step for steps, _ in solves)
    want_flash, want_conv = n_blocks * n_forwards, 2 * n_forwards
    log(f"engine: {len(requests)} requests, {len(solves)} solves {solves} in {wall:.3f} s; launches "
        f"flash_attention {flash_attention.launches} (want {want_flash}), conv_pos {conv_pos.launches} (want {want_conv})")
    check(any(b > 1 for _, b in solves), "no solve batched several rows")
    check(flash_attention.launches == want_flash and want_flash > 0, "flash_attention launch count")
    check(conv_pos.launches == want_conv and want_conv > 0, "conv_pos launch count")

    # serving path (bf16 + kernels) vs the fp32 plain path on a small input
    import dataclasses

    rng = np.random.default_rng(3)
    pb, pn, pref = 2, 256, 64
    cond = torch.as_tensor(rng.standard_normal((pb, pn, 100)), dtype=torch.float32, device=dev)
    cl = torch.full((pb,), pref, dtype=torch.int32, device=dev)
    text = torch.as_tensor(rng.integers(0, 90, (pb, 48)), dtype=torch.int32, device=dev)
    dur = torch.tensor([pn, pn - 40], dtype=torch.int32, device=dev)
    y0 = torch.as_tensor(rng.standard_normal((pb, pn, 100)), dtype=torch.float32, device=dev)
    sampler = SamplerConfig(steps=4, method="ralston", cfg_strength=2.0)
    serving = sample_cfm(engine.dit_params, engine.dit_cfg, cond=cond, cond_lens=cl, text=text, duration=dur,
                         sampler=sampler, y0=y0, compute_dtype=torch.bfloat16).float()
    from f5tts_tpu_torch.models.convert import dit_params_from_numpy

    p32 = dit_params_from_numpy(dit_np, dev, torch.float32)
    plain_cfg = dataclasses.replace(engine.dit_cfg, attn_impl="plain", conv_pos_impl="plain")
    ref = sample_cfm(p32, plain_cfg, cond=cond, cond_lens=cl, text=text, duration=dur, sampler=sampler, y0=y0,
                     compute_dtype=torch.float32)
    gen = torch.zeros((pb, pn), dtype=torch.bool, device=dev)
    for r in range(pb):
        gen[r, pref : int(dur[r])] = True
    rmse = float(torch.sqrt(((serving - ref) ** 2 * gen[..., None]).sum() / (gen.sum() * 100)))
    log(f"parity: serving path (bf16 + kernels) vs fp32 plain path, mel RMSE over generated frames {rmse:.4f} (tol 0.5)")
    check(np.isfinite(rmse) and rmse < 0.5, f"serving path diverged from the plain path: {rmse}")
    del p32


def bench_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str) -> None:
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.sampling.euler import DEFAULT_NFE, nfe_to_steps

    batch, n, ref_frames, text_pad = 8, 1024, 128, 512
    steps = nfe_to_steps(DEFAULT_NFE["ralston"], "ralston")
    engine = TTSEngine(dit_np, dit_cfg, voc_np, tok, EngineConfig(
        vocoder=voc_cfg, duration_buckets=(n,), batch_buckets=(batch,), text_pad=text_pad), device=dev)
    rng = np.random.default_rng(0)
    cond = torch.as_tensor(rng.standard_normal((batch, n, 100)), dtype=torch.float32, device=dev)
    cond_lens = torch.full((batch,), ref_frames, dtype=torch.int32, device=dev)
    text = torch.as_tensor(rng.integers(0, 90, (batch, text_pad)), dtype=torch.int32, device=dev)
    duration = torch.full((batch,), n, dtype=torch.int32, device=dev)
    seeds = np.arange(batch)

    def run():
        _, wave = engine.bucket_program(cond, cond_lens, text, duration, seeds, steps=steps, cfg_strength=2.0)
        return float(wave[:, :64].sum())  # host fetch: the solve has finished

    run()
    profile_solve(run)
    iters = []
    for _ in range(3):
        t0 = time.perf_counter()
        check(np.isfinite(run()), "bench waveform not finite")
        iters.append(time.perf_counter() - t0)
    dt = statistics.median(iters)
    audio_s = batch * (n - ref_frames) / (24000 / 256)
    log(f"bench geometry on {card}: batch {batch}, bucket {n}, ref {ref_frames}, ralston NFE 20, CFG 2, bf16: "
        f"iter_s {[round(t, 4) for t in iters]}, median {dt:.4f} s, {audio_s / dt:.2f} audio-s/s")


def profile_solve(run) -> None:
    """Device time of one bench-geometry solve by kernel family
    (``torch.profiler``, kernels only), and the device's busy share of the
    wall time (single stream: kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = (("flash_attention", ("flash_fwd",)), ("conv_pos", ("conv_wmma", "conv_generic")),
                ("gemm", ("gemm", "cutlass", "xmma", "nvjet")), ("reduction", ("reduce_kernel",)),
                ("elementwise", ("elementwise", "vectorized", "unrolled")))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    sums: dict[str, float] = {}
    for e in kernels:
        fam = next((f for f, keys in families if any(k in e.key for k in keys)), "other")
        sums[fam] = sums.get(fam, 0.0) + e.self_device_time_total / 1e3
    busy = sum(sums.values())
    log(f"profile of one bench solve: wall {wall_ms:.1f} ms (profiler on), kernels {busy:.1f} ms "
        f"= {100 * busy / wall_ms:.1f}% busy, {100 - 100 * busy / wall_ms:.1f}% idle")
    for fam, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.1f} ms ({100 * ms / busy:.1f}% of kernel time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  kernel {e.key[:80]!r}: {e.self_device_time_total / 1e3:.1f} ms, {e.count} launches")


# ---------------------------------------------------------------------------
# training kernels and the training path
# ---------------------------------------------------------------------------


def _rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))


def train_kernel_phase(dev) -> list[dict]:
    from f5tts_tpu_torch.ops.kernels import flash_attention_train as ft

    h, d = 16, 64  # F5-TTS Base heads
    rows = []
    for b, n, what in ((37, 1024, "one 38 400-frame batch"), (4, 1000, "ragged n"), (12, 3072, "30-s bucket")):
        g = torch.Generator(device="cpu").manual_seed(n)
        q, k, v, do = (torch.randn((b, h, n, d), generator=g).to(dev, torch.bfloat16) for _ in range(4))
        o, lse = ft.flash_attention_train_fwd(q, k, v)
        dq, dk, dv = ft.flash_attention_train_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        nb = b if b * n * n <= 37 * 1024 * 1024 else 2  # fp32 plain on 2 rows of the 3072 bucket (its n^2 tensors)
        f32 = [t[:nb].float() for t in (q, k, v, do)]
        ref_o, ref_lse = ft.flash_attention_train_fwd_plain(*f32[:3])
        refs = ft.flash_attention_train_bwd_plain(*f32[:3], ref_o, ref_lse, f32[3])
        err_o = float((o[:nb].float() - ref_o).abs().max())
        err_lse = float((lse[:nb] - ref_lse).abs().max())
        errs = [float((got[:nb].float() - ref).abs().max()) for got, ref in zip((dq, dk, dv), refs)]
        rels = [_rel_err(got[:nb], ref) for got, ref in zip((dq, dk, dv), refs)]
        peaks = [float(ref.abs().max()) for ref in refs]
        del ref_o, ref_lse, refs, f32
        log(f"train attention b={b} n={n} ({what}; fp32 plain on {nb} rows): o err {err_o:.3e} (tol {ATTN_TOL}), "
            f"lse err {err_lse:.3e} (tol {LSE_TOL}), dq/dk/dv max abs err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} "
            f"at peaks {peaks[0]:.3f}/{peaks[1]:.3f}/{peaks[2]:.3f}, relative {max(rels):.3e} (tol {GRAD_TOL})")
        check(np.isfinite(err_o) and err_o <= ATTN_TOL, f"train forward o error {err_o}")
        check(np.isfinite(err_lse) and err_lse <= LSE_TOL, f"train forward lse error {err_lse}")
        check(all(np.isfinite(rels)) and max(rels) <= GRAD_TOL, f"train backward error {rels}")

        fwd_ms = time_ms(lambda: ft.flash_attention_train_fwd(q, k, v))
        bwd_ms = time_ms(lambda: ft.flash_attention_train_bwd(q, k, v, o, lse, do))
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True))
        lib_both = time_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), do))
        plain_fwd = plain_bwd = None
        if nb == b and what.startswith("one"):
            plain_fwd = time_ms(lambda: ft.flash_attention_train_fwd_plain(q, k, v), iters=5, warmup=1)
            plain_bwd = time_ms(lambda: ft.flash_attention_train_bwd_plain(q, k, v, o, lse, do), iters=5, warmup=1)
        elems = b * h * n * d
        fb, fby = bound_ms(4.0 * b * h * n * n * d, 4 * elems * 2 + b * h * n * 4, PEAK_BF16_FLOPS)
        bb, bby = bound_ms(10.0 * b * h * n * n * d, 8 * elems * 2 + b * h * n * 4, PEAK_BF16_FLOPS)
        log(f"train attention b={b} n={n} times: forward {fwd_ms:.4f} ms (bound {fb:.4f} {fby}, SDPA {lib_fwd:.4f}), "
            f"backward {bwd_ms:.4f} ms (bound {bb:.4f} {bby}, SDPA backward {lib_bwd:.4f}, SDPA forward+backward "
            f"{lib_both:.4f}); plain forward {plain_fwd} ms, plain backward {plain_bwd} ms")
        if what.startswith("one"):  # the main-path shape: the numbers of the kernels line
            rows = [
                {"name": "flash_attention_train_fwd", "route": "cuda",
                 "source": "f5tts_tpu_torch/csrc/flash_attention_train.cu",
                 "replaces": "f5tts_tpu/ops/pallas/flash_attention.py:387", "max_abs_err": max(err_o, err_lse),
                 "ms": fwd_ms, "plain_ms": plain_fwd, "bound_ms": fb, "bound_by": fby, "library_ms": lib_fwd},
                {"name": "flash_attention_train_bwd", "route": "cuda",
                 "source": "f5tts_tpu_torch/csrc/flash_attention_train.cu",
                 "replaces": "f5tts_tpu/ops/pallas/flash_attention.py:401", "max_abs_err": max(errs),
                 "ms": bwd_ms, "plain_ms": plain_bwd, "bound_ms": bb, "bound_by": bby, "library_ms": lib_bwd},
            ]
        del q, k, v, do, o, lse, dq, dk, dv, qs, ks, vs, out
        torch.cuda.empty_cache()
    return rows


def train_grad_parity(dev, tok) -> None:
    """One step's gradients through the kernels (bf16) against the fp32 plain
    path, same params, batch and draws, on a small geometry."""
    import dataclasses

    from f5tts_tpu_torch.models.cfm import CFMConfig, cfm_draws, cfm_loss
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.train.data import synthetic_packed_batch
    from f5tts_tpu_torch.train.trainer import TrainConfig, init_train_state
    from f5tts_tpu_torch.train.tree import tree_leaves

    small = DiTConfig(dim=256, depth=2, heads=4, dim_head=64, text_num_embeds=tok.vocab_size, text_dim=128,
                      conv_layers=1)
    batch = synthetic_packed_batch(small, 256, 4, seed=5)
    mel, text, lens = (torch.as_tensor(batch[k], device=dev) for k in ("mel", "text", "lens"))
    cfg_k = CFMConfig(model=small)
    draws = cfm_draws(torch.Generator(device=dev).manual_seed(6), lens, 256, small.mel_dim, cfg_k)
    grads = []
    for cfg, dtype in ((cfg_k, torch.bfloat16),
                       (CFMConfig(model=dataclasses.replace(small, attn_impl="plain", conv_pos_impl="plain")),
                        torch.float32)):
        params = init_train_state(cfg, TrainConfig(), dev)["params"]
        loss, _ = cfm_loss(params, cfg, draws, mel, text, lens, dtype)
        loss.backward()
        grads.append({name: t.grad.float() for name, t in tree_leaves(params)})
    num = sum(float(torch.sum((grads[0][k] - grads[1][k]) ** 2)) for k in grads[1])
    den = sum(float(torch.sum(grads[1][k] ** 2)) for k in grads[1])
    rel = (num / den) ** 0.5
    worst = max(grads[1], key=lambda k: float(torch.linalg.vector_norm(grads[0][k] - grads[1][k]))
                / max(float(torch.linalg.vector_norm(grads[1][k])), 1e-30))
    wrel = float(torch.linalg.vector_norm(grads[0][worst] - grads[1][worst]) / torch.linalg.vector_norm(grads[1][worst]))
    log(f"train gradient parity (dim 256, depth 2, 4 x 64 heads, 4 x 256 frames, dropout 0.1 with the same seeds): "
        f"kernels bf16 vs plain fp32, relative L2 over all leaves {rel:.4e} (tol {TRAIN_GRAD_RTOL}); "
        f"worst leaf {worst} {wrel:.4e}")
    check(np.isfinite(rel) and rel <= TRAIN_GRAD_RTOL, f"train gradients diverged from the plain path: {rel}")


def profile_step(step) -> None:
    """Device time of one train step by kernel family (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = (("flash_attention_train_fwd", ("fwd_lse",)), ("flash_attention_train_bwd", ("bwd_dkdv", "bwd_dq")),
                ("conv_pos", ("conv_wmma", "conv_generic")), ("gemm", ("gemm", "cutlass", "xmma", "nvjet")),
                ("reduction", ("reduce_kernel",)), ("elementwise", ("elementwise", "vectorized", "unrolled")))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    sums: dict[str, float] = {}
    for e in kernels:
        fam = next((f for f, keys in families if any(key in e.key for key in keys)), "other")
        sums[fam] = sums.get(fam, 0.0) + e.self_device_time_total / 1e3
    busy = sum(sums.values())
    log(f"profile of one train step: wall {wall_ms:.1f} ms (profiler on), kernels {busy:.1f} ms "
        f"= {100 * busy / wall_ms:.1f}% busy, {100 - 100 * busy / wall_ms:.1f}% idle")
    for fam, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.1f} ms ({100 * ms / busy:.1f}% of kernel time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  kernel {e.key[:80]!r}: {e.self_device_time_total / 1e3:.1f} ms, {e.count} launches")


TRAIN_SHAPES = ((37, 1024), (12, 3072), (37, 1024), (37, 1024), (37, 1024))  # (rows, frames) per step


def train_phase(dev, model, shapes, tok, card: str, launches: dict) -> None:
    from f5tts_tpu_torch.models.cfm import CFMConfig
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention
    from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train_fwd, flash_attention_train_bwd
    from f5tts_tpu_torch.train.data import synthetic_packed_batch
    from f5tts_tpu_torch.train.trainer import TrainConfig, Trainer
    from f5tts_tpu_torch.train.tree import tree_leaves

    train_grad_parity(dev, tok)
    # warmup 2 updates: the first update uses schedule(0) = 0 (optax's count), the later ones move the params
    trainer = Trainer(CFMConfig(model=model), TrainConfig(warmup_updates=2), compute_dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    state, _ = trainer.init_or_resume()
    log(f"train state (dim {model.dim}, depth {model.depth}, {sum(t.numel() for _, t in tree_leaves(state['params']))} "
        f"params) in {time.perf_counter() - t0:.1f} s")
    watch = {name: t.detach().clone() for name, t in tree_leaves(state["params"])}
    batches = [synthetic_packed_batch(model, n, b, seed=i) for i, (b, n) in enumerate(shapes)]
    per_step = {"flash_attention_train_fwd": 2 * model.depth, "flash_attention_train_bwd": 2 * model.depth,
                "conv_pos": 2, "flash_attention": 0}
    wrappers = {"flash_attention_train_fwd": flash_attention_train_fwd,
                "flash_attention_train_bwd": flash_attention_train_bwd, "conv_pos": conv_pos,
                "flash_attention": flash_attention}
    for w in wrappers.values():
        w.launches = 0
    times = []
    for i, batch in enumerate(batches):
        before = {name: w.launches for name, w in wrappers.items()}
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        metrics = trainer.step(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t_step
        times.append(dt)
        frames = int(batch["lens"].sum())
        counts = {name: w.launches - before[name] for name, w in wrappers.items()}
        log(f"train step {i + 1} ({batch['mel'].shape[0]} x {batch['mel'].shape[1]}, {frames} mel frames): "
            f"loss {loss:.4f}, grad norm {gnorm:.4f}, {dt:.3f} s = {frames / dt:.0f} mel-frames/s; launches {counts}")
        check(np.isfinite(loss) and np.isfinite(gnorm), f"train step {i + 1}: loss {loss}, grad norm {gnorm}")
        check(counts == per_step, f"train step {i + 1}: launches {counts}, want {per_step}")
    for name in ("flash_attention_train_fwd", "flash_attention_train_bwd", "conv_pos"):
        launches[name]["train"] = wrappers[name].launches
    moved = sum(not torch.equal(watch[name], t.detach()) for name, t in tree_leaves(state["params"]))
    log(f"params: {moved} of {len(watch)} leaves changed over {len(batches)} updates")
    check(moved == len(watch), "some parameter leaves did not change")
    first = shapes[0]
    steady = [t for shape, t in zip(shapes, times) if shape == first][1:]  # the first step warms up
    med = statistics.median(steady)
    frames = statistics.mean(int(b["lens"].sum()) for b, shape in zip(batches, shapes) if shape == first)
    log(f"train throughput on {card}: dim {model.dim} depth {model.depth}, bf16, {first[0]} x {first[1]} "
        f"frame-packed batches: step s {[round(t, 4) for t in steady]}, median {med:.4f} s, {frames / med:.0f} "
        f"mel-frames/s ({first[0] * first[1] / med:.0f} padded frames/s); other steps "
        f"{[(shape, round(t, 4)) for shape, t in zip(shapes, times) if shape != first]}")
    profile_step(lambda: trainer.step(state, batches[2]))
    del state, trainer
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the engine, bench and training phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, HERE)
    from f5tts_tpu_torch.ops.kernels import KERNEL_SOURCES, _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = card_line()
    log(card)

    t0 = time.perf_counter()
    _build.build(list(KERNEL_SOURCES))
    log(f"built {list(KERNEL_SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")

    kernels = [attention_phase(dev), conv_phase(dev), *train_kernel_phase(dev)]
    launches = {k["name"]: {} for k in kernels}  # kernel -> path -> launches, each path's counts set to 0 before it
    if not args.kernels_only:
        from f5tts_tpu_torch.models.convert import init_dit_numpy, init_vocos_numpy
        from f5tts_tpu_torch.models.dit import DiTConfig
        from f5tts_tpu_torch.models.vocos import VocosConfig
        from f5tts_tpu_torch.text.tokenizer import Tokenizer

        tok = Tokenizer.from_file(os.path.join(HERE, "examples", "vocab.txt"))
        dit_cfg, voc_cfg = DiTConfig(text_num_embeds=tok.vocab_size), VocosConfig()  # F5-TTS Base + Vocos
        dit_np, voc_np = init_dit_numpy(dit_cfg, seed=0), init_vocos_numpy(voc_cfg, seed=1)
        engine_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, launches)
        bench_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card)
        del dit_np, voc_np
        train_phase(dev, dit_cfg, TRAIN_SHAPES, tok, card, launches)  # F5-TTS Base, dropout 0.1, kernels
    for k in kernels:
        k["launches_by_path"] = launches[k["name"]]
        k["launches"] = sum(launches[k["name"]].values())
    log(card_line())
    log(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "launches_by_path")} for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
