"""On-card smoke test of the PyTorch/CUDA port (``f5tts_tpu_torch``).

    python3 chip_smoke.py               # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels-only

Phases, each of which fails the run (non-zero exit) on any error:

1. build every CUDA kernel of the port from ``f5tts_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
2. kernels: each kernel against its plain PyTorch version on the card at the
   main-path shapes (F5-TTS Base, fused CFG at batch 8: 16 rows of 1024
   frames), max abs error on valid rows against a stated tolerance, median
   times over 20 runs (CUDA events) of the kernel, its plain version and one
   PyTorch library call of the same function, and the least time the card
   could take (``bound_ms``); the serving attention on head-split views (as
   the DiT hands them over) held bit-equal to the contiguous call, its d 32 /
   d 128 / fp32 branches, all-heads RoPE, a ragged n and an all-masked row,
   its device time in a CUDA graph with and without RoPE and the mask beside
   SDPA's (cos/sin made once, as the DiT makes them once per bucket), and at the engine's long buckets (2 rows x 16 heads at 2048 and
   4096 frames); the conv-pos pair (one launch) also at ragged rows shorter
   than the kernel, n under the kernel width and batch 1, and in a CUDA graph
   beside the cuDNN pair;
3. engine: ``TTSEngine.synthesize`` at F5-TTS Base width (random weights from a
   seed) for three requests, one of which chunks into several rows of the
   1024-frame bucket; the launch counts of each kernel, set to 0 just before,
   must equal what the solves need (per DiT forward 22 attention kernels,
   22 of their RoPE pre-pass and 1 conv-pos pair); the waveforms must be finite, non-zero
   and of the planned length; a small-input parity check of the serving path
   (bf16 + kernels) against the fp32 plain path;
4. bench geometry: batch 8, 1024-frame bucket, 128 reference frames, text_pad
   512, Ralston NFE 20, CFG 2, bf16 — wall time and audio-seconds per second,
   and the profile's launches of each F5 kernel per solve (22 x 20 attention,
   22 x 20 pre-pass, 20 conv-pos);
5. training kernels (with phase 2): the forward-with-logsumexp and backward
   attention kernels at the training shape (F5-TTS Base heads, bf16, one
   38 400-frame batch packed as 37 x 1024, a ragged n = 1000 and the 30-s
   bucket n = 3072) against their fp32 plain versions, with times, bounds and
   SDPA forward / backward as the library yardstick;
6. training: ``Trainer`` at F5-TTS Base width (full depth, random init from
   seed 0), bf16 compute over fp32 params, AdamW + EMA, five steps on
   synthetic frame-packed batches of ~38 400 frames (one of them 12 x 3072);
   launch counts per step against the design (44 forward launches with the
   per-block recompute, 44 backward launches = 22 x (dK/dV + dQ), 1 conv-pos
   launches), finite loss and gradient norm, params that move, step time and
   mel-frames/s, a profiler breakdown of one step; and one step's gradients
   through the kernels (bf16) against the fp32 plain path on a small
   geometry;
7. decode attention (with phase 2): the decode-step attention kernel at the
   shapes of one Parler decode position (16 heads of 64, bf16: batch 16
   against a 503-position self-attention cache with a causal bound in the
   middle and padded prompt keys, and against 64 encoder positions with a
   ragged mask and a fully masked row), grouped-query cases, batch 1 and 32,
   fp32, each against the fp32 plain version; device time per call in a CUDA
   graph of 24 calls over cache sets that exceed the L2, beside the plain
   version, SDPA and the bound from the bytes of K and V;
8. Parler: ``ParlerTTSEngine`` at the width and depth of indic-parler-tts
   (flan-t5-large encoder, 24-layer decoder over 9 codebooks, 44.1 kHz DAC;
   random weights from seeds 0-2, bf16, a stand-in ``ord(c) % vocab``
   tokenizer): three requests through ``ContinuousBatcher`` that share one
   decode, the same burst again (description cache: the T5 must not run), one
   streamed request whose segments equal the batch path's wave, and the
   bench request (batch 16 x 430 frames, greedy, no EOS: audio-s/s and decode
   steps/s, median of 3 after a warm call). Every call's decode-attention
   launches must equal 2 x 24 x (frames + 8) and the F5 kernels' counts stay
   0; a profiler breakdown of one bench call with the busy/idle share; and at
   a small geometry the step logits of bf16 + kernel against fp32 + plain,
   teacher-forced;
9. quant_matmul (with phase 2): the fused quantize + int8 tensor-core matmul
   at the shapes the int8 engine gives it at the bench geometry (16 x 1024
   rows of bf16 against the q/k/v/out, feed-forward in and feed-forward out
   weights of F5-TTS Base), a ragged fp32 shape, shapes that are no multiple
   of its tiles, a zero row and a row of 1e-7 under both floor conventions:
   every result bit-equal to the plain version; times beside the plain
   version, PyTorch's quantize + ``torch._int_mm`` + rescale, the bf16
   ``torch.matmul`` of the same shape (what int8 has to beat) and the bound;
   and the rate of the ``mma.sync`` s8 instruction alone;
10. int8 engine (after phase 4): ``TTSEngine(EngineConfig(quantization="int8"))``
   at F5-TTS Base + Vocos: one request with exact launch counts (quant_matmul
   6 x 22, attention 22, its RoPE pre-pass 22, conv-pos 1 per DiT forward), one DiT forward and one
   whole solve against the bf16 engine from the same noise, a strict request
   (estimate, escalations), ``synthesize_batch`` of three chunks as one
   solve, ``synthesize_streaming`` against ``synthesize``'s wave, then the
   bench geometry at int8 beside the bf16 figure of the same run, with a
   profile whose library-GEMM launches must drop by exactly the 2640 that
   moved to quant_matmul;
11. attention-layout ablation (with phase 2): the kernel of the five layouts
   of ``scripts/ablate_attention.py`` at BH 256, N 1024, D 64, bf16, BQ 64 and
   128, zero bias and a -1e9 tail, against its fp32 plain version and the
   unpacked kernel; the four shapes it refuses; then the ablation itself
   (``f5tts_tpu_torch.scripts.ablate_attention.run``) at BQ 64 and 128: device
   time per call of each layout, its ``mma.sync`` count (the kernel's own),
   warps per SM, ``unpacked`` at the pair layouts' occupancy, the shipping
   kernel and SDPA on the same inputs. Its launches must stay 0 through
   phases 3-10.

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
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ATTN_TOL = 2e-2  # bf16 kernel vs fp32 plain on the same bf16 inputs
CONV_TOL = 3e-2  # bf16 (bf16 intermediate) vs fp32 plain (fp32 intermediate)
LSE_TOL = 1e-3  # training forward's lse: fp32 in both, scores from the same bf16 inputs
GRAD_TOL = 3e-2  # attention gradients, max abs error over max(1, peak |ref|): p and dS rounded to bf16
TRAIN_GRAD_RTOL = 5e-2  # relative L2 of a bf16 kernel train step's gradients vs the fp32 plain path
INT8_SOLVE_REL, INT8_SOLVE_COS = 0.1, 0.995  # int8 vs bf16 engine, generated mel of one solve from the same noise
STREAM_REL_RMS = 5e-2  # streamed vs batched chunks, bf16: library GEMMs pick other algorithms at other batch sizes
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


def time_graph_ms(calls, replays: int = 10) -> float:
    """Median device time per call of a CUDA graph that holds every call of
    ``calls`` once: the kernels run back to back with no host launch gap, which
    is what a kernel of a few microseconds needs to be timed at all."""
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = [c() for c in calls]  # outputs stay alive in the graph's pool
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del keep, graph
    return statistics.median(times) / len(calls)


def bound_ms(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def _head_split(g, dev, dtype, b, h, n, d):
    """q, k, v as the DiT hands them to the kernel: (b, h, n, d) views of
    (b, n, h*d) projections."""
    return [torch.randn((b, n, h * d), generator=g).to(dev, dtype).view(b, n, h, d).transpose(1, 2) for _ in range(3)]


def attention_phase(dev) -> dict:
    from f5tts_tpu_torch.ops.kernels.flash_attention import cos_sin_of, flash_attention, flash_attention_plain, rope_rows
    from f5tts_tpu_torch.ops.rope import apply_rotary_per_head, rotary_freqs

    b, h, n, d = 16, 16, 1024, 64  # fused CFG at batch 8: 2*8 rows, F5-TTS Base heads
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = _head_split(g, dev, torch.bfloat16, b, h, n, d)
    lens = torch.randint(n // 2, n + 1, (b,), generator=g).to(dev)
    lens[0] = n
    mask = torch.arange(n, device=dev)[None, :] < lens[:, None]
    freqs = torch.as_tensor(rotary_freqs(n, d), device=dev)

    before = flash_attention.launches, rope_rows.launches
    out = flash_attention(q, k, v, mask, rope_freqs=freqs)
    torch.cuda.synchronize()
    check((flash_attention.launches, rope_rows.launches) == (before[0] + 1, before[1] + 1),
          "a head-0 RoPE call did not launch the pre-pass and the wgmma kernel once each")
    ref = flash_attention_plain(q.float(), k.float(), v.float(), mask, freqs)
    err = float(((out.float() - ref).abs() * mask[:, None, :, None]).max())
    log(f"attention: kernel vs fp32 plain, max abs err on valid rows {err:.3e} (tol {ATTN_TOL})")
    check(np.isfinite(err) and err <= ATTN_TOL, f"flash_attention error {err} > {ATTN_TOL}")
    dense = flash_attention(*(t.contiguous() for t in (q, k, v)), mask, rope_freqs=freqs)
    check(torch.equal(out, dense), "flash_attention on head-split views differs from the contiguous call")
    trig = cos_sin_of(freqs)  # made once, as the DiT makes them once per bucket; the timings below take them
    check(torch.equal(out, flash_attention(q, k, v, mask, rope_freqs=freqs, rope_cos_sin=trig)),
          "flash_attention with the caller's cos/sin differs from the call that makes them")
    log("attention: head-split views and contiguous q/k/v give bit-equal outputs, with or without the caller's cos/sin")
    del ref, dense

    # other branches and variants: fp32 (CUDA cores), bf16 d 32 (mma.sync), bf16 d 128 (wgmma), all-heads RoPE,
    # a ragged n, a batch row whose keys are all masked (every key then weighs the same)
    for dtype, rope_all, nn_, dd, dead_row in ((torch.float32, False, 1024, 64, False), (torch.bfloat16, True, 1000, 64, False),
                                               (torch.bfloat16, False, 256, 64, True), (torch.bfloat16, True, 1024, 32, True),
                                               (torch.bfloat16, False, 1000, 128, True), (torch.float32, True, 300, 32, False)):
        qs, ks, vs = _head_split(g, dev, dtype, 2, h, nn_, dd)
        ms = mask[:2, :nn_].clone()
        if dead_row:
            ms[1] = False
        fs = torch.as_tensor(rotary_freqs(nn_, dd), device=dev)
        o2 = flash_attention(qs, ks, vs, ms, rope_freqs=fs, rope_all_heads=rope_all)
        r2 = flash_attention_plain(qs.float(), ks.float(), vs.float(), ms, fs, rope_all)
        rows = ms | ~ms.any(-1, keepdim=True)  # valid query rows; all rows of a dead batch row
        e2 = float(((o2.float() - r2).abs() * rows[:, None, :, None]).max())
        tol = 1e-4 if dtype == torch.float32 else ATTN_TOL
        log(f"attention {dtype} d={dd} rope_all={rope_all} n={nn_} all-masked row={dead_row}: max abs err {e2:.3e} "
            f"(tol {tol})")
        check(np.isfinite(e2) and e2 <= tol, f"flash_attention variant error {e2} > {tol}")

    def library_call(q_, k_, v_, mask_, freqs_):  # SDPA on pre-roped q/k, the key mask as an additive bias
        qr, kr = apply_rotary_per_head(q_[:, :1], freqs_), apply_rotary_per_head(k_[:, :1], freqs_)
        qr, kr = torch.cat([qr, q_[:, 1:]], 1), torch.cat([kr, k_[:, 1:]], 1)
        bias = torch.where(mask_, 0.0, -1e30)[:, None, None, :].to(q_.dtype)
        return lambda: F.scaled_dot_product_attention(qr, kr, v_, attn_mask=bias)

    def bound_of(b_, n_):
        nbytes = 4 * b_ * h * n_ * d * 2 + b_ * n_ + 2 * n_ * d * 4  # q, k, v, o + mask + cos/sin tables
        return bound_ms(4.0 * b_ * h * n_ * n_ * d, nbytes, PEAK_BF16_FLOPS)

    ms_kernel = time_ms(lambda: flash_attention(q, k, v, mask, rope_freqs=freqs, rope_cos_sin=trig))
    ms_plain = time_ms(lambda: flash_attention_plain(q, k, v, mask, freqs))
    ms_lib = time_ms(library_call(*(t.contiguous() for t in (q, k, v)), mask, freqs))  # SDPA's own layout
    bms, by = bound_of(b, n)
    log(f"attention times: kernel {ms_kernel:.4f} ms, plain {ms_plain:.4f} ms, "
        f"library (SDPA on pre-roped q/k) {ms_lib:.4f} ms, bound {bms:.4f} ms ({by})")
    # where a launch's time goes: device time per call back to back in a CUDA graph (no host gaps), with and
    # without the RoPE and the key mask; SDPA the same way (its q/k roped before the graph)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    split = {what: time_graph_ms([fn] * 20) for what, fn in (
        ("rope_mask", lambda: flash_attention(q, k, v, mask, rope_freqs=freqs, rope_cos_sin=trig)),
        ("mask", lambda: flash_attention(q, k, v, mask)), ("neither", lambda: flash_attention(q, k, v)),
        ("sdpa_mask", library_call(qc, kc, vc, mask, freqs)),
        ("sdpa_neither", lambda: F.scaled_dot_product_attention(qc, kc, vc)))}
    log(f"attention device time per call in a CUDA graph of 20 calls: with head-0 RoPE and the key mask "
        f"{split['rope_mask']:.4f} ms, the mask only {split['mask']:.4f} ms, neither {split['neither']:.4f} ms "
        f"(one eager call through the wrapper: {ms_kernel:.4f} ms); SDPA with the mask as a bias "
        f"{split['sdpa_mask']:.4f} ms, without {split['sdpa_neither']:.4f} ms")
    del qc, kc, vc

    # the engine's long buckets (EngineConfig.duration_buckets up to 4096 frames): 2 rows x 16 heads, bf16,
    # head-0 RoPE, a ragged key mask, against the fp32 plain version
    long = {}
    for nl in (2048, 4096):
        gl = torch.Generator(device="cpu").manual_seed(nl)
        ql, kl, vl = _head_split(gl, dev, torch.bfloat16, 2, h, nl, d)
        lens_l = torch.tensor([nl, int(torch.randint(nl // 2, nl, (1,), generator=gl))], device=dev)
        ml = torch.arange(nl, device=dev)[None, :] < lens_l[:, None]
        fl = torch.as_tensor(rotary_freqs(nl, d), device=dev)
        ol = flash_attention(ql, kl, vl, ml, rope_freqs=fl)
        torch.cuda.synchronize()
        rl = flash_attention_plain(ql.float(), kl.float(), vl.float(), ml, fl)
        el = float(((ol.float() - rl).abs() * ml[:, None, :, None]).max())
        del rl, ol
        torch.cuda.empty_cache()
        trig_l = cos_sin_of(fl)
        ms_k, ms_l = time_ms(lambda: flash_attention(ql, kl, vl, ml, rope_freqs=fl, rope_cos_sin=trig_l)), time_ms(
            library_call(*(t.contiguous() for t in (ql, kl, vl)), ml, fl))
        bl, byl = bound_of(2, nl)
        log(f"attention n={nl} (2 x 16 heads, bf16, head-0 RoPE, key lengths {lens_l.tolist()}): max abs err on valid "
            f"rows {el:.3e} (tol {ATTN_TOL}); kernel {ms_k:.4f} ms, library (SDPA on pre-roped q/k) {ms_l:.4f} ms, "
            f"bound {bl:.4f} ms ({byl})")
        check(np.isfinite(el) and el <= ATTN_TOL, f"flash_attention n={nl} error {el} > {ATTN_TOL}")
        long[f"b2_n{nl}"] = {"max_abs_err": el, "ms": ms_k, "library_ms": ms_l, "bound_ms": bl, "bound_by": byl}
    return {"name": "flash_attention", "route": "cuda", "source": "f5tts_tpu_torch/csrc/flash_attention.cu",
            "replaces": "f5tts_tpu/ops/pallas/flash_attention.py:250", "max_abs_err": err, "ms": ms_kernel,
            "plain_ms": ms_plain, "bound_ms": bms, "bound_by": by, "library_ms": ms_lib, "graph_ms": split,
            "other_shapes": long}


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
    err = float((out.float() - ref).abs().max())
    log(f"conv_pos: kernel vs fp32 plain, max abs err over every row (those past lens too) {err:.3e} (tol {CONV_TOL})")
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

    # the fused pair at the edges: rows shorter than the kernel, n no multiple of the 256-frame tile, n under the
    # kernel width, batch 1
    for nn_, lens_ in ((20, [20, 7]), (700, [700, 13]), (300, [1])):
        ls = torch.tensor(lens_, dtype=torch.int32, device=dev)
        ms_ = (torch.arange(nn_, device=dev)[None] < ls[:, None])[..., None]
        xe = x[:len(lens_), :nn_] * ms_
        before = conv_pos.launches
        oe = conv_pos(xe, w1, b1, w2, b2, ls)
        check(conv_pos.launches == before + 1, "the bf16 conv-pos pair did not run as one launch")
        re_ = conv_pos_plain(xe.float(), w1.float(), b1.float(), w2.float(), b2.float(), ls)
        ee = float((oe.float() - re_).abs().max())
        log(f"conv_pos bf16 b={len(lens_)} n={nn_} lens={lens_}: max abs err over every row {ee:.3e} (tol {CONV_TOL})")
        check(np.isfinite(ee) and ee <= CONV_TOL, f"conv_pos edge case error {ee}")

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
    graph = {"kernel": time_graph_ms([lambda: conv_pos(x, w1, b1, w2, b2, lens)] * 10),
             "library": time_graph_ms([library] * 10)}
    log(f"conv_pos times: kernel (the fused pair, one launch) {ms_kernel:.4f} ms, plain {ms_plain:.4f} ms, "
        f"library (2x F.conv1d groups=16 + Mish) {ms_lib:.4f} ms, bound {bms:.4f} ms ({by}); device time per call "
        f"in a CUDA graph of 10 calls: kernel {graph['kernel']:.4f} ms, library {graph['library']:.4f} ms")
    return {"name": "conv_pos", "route": "cuda", "source": "f5tts_tpu_torch/csrc/conv_pos.cu",
            "replaces": "f5tts_tpu/ops/pallas/conv_pos.py:141", "max_abs_err": err, "ms": ms_kernel,
            "plain_ms": ms_plain, "bound_ms": bms, "bound_by": by, "library_ms": ms_lib, "graph_ms": graph}



def _decode_inputs(dev, dtype, b, h, n_kv, total, d, seed, *, bound=None, pad_row=None, dead_row=None, ragged=False):
    """q (pre-scaled), K/V caches and the additive bias of one decode step.
    ``bound``: positions past it are banned and hold zeros, as in a cache that
    is filled up to there; ``pad_row``: a row whose first 20 keys are padding;
    ``ragged``: per-row valid prefixes (an encoder mask); ``dead_row``: a row
    with every position banned."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn((b, h, 1, d), generator=g) * d**-0.5).to(dev, dtype)
    k, v = (torch.randn((b, n_kv, total, d), generator=g).to(dev, dtype) for _ in range(2))
    allowed = torch.ones((b, total), dtype=torch.bool)
    if bound is not None:
        allowed[:, bound + 1:] = False
        k[:, :, bound + 1:] = 0
        v[:, :, bound + 1:] = 0
    if ragged:
        lens = torch.randint(1, total + 1, (b,), generator=g)
        lens[0] = total
        allowed &= torch.arange(total)[None, :] < lens[:, None]
    if pad_row is not None:
        allowed[pad_row, :20] = False
    if dead_row is not None:
        allowed[dead_row] = False
    bias = torch.where(allowed, 0.0, -1e9).to(dev, torch.float32)
    return q, k, v, bias


def decode_attention_phase(dev) -> dict:
    """The decode-step attention kernel at the shapes of one Parler decode
    position (indic-parler-tts: 16 heads of 64; batch 16; 64 prompt + 1 + 438
    positions of self-attention cache, 64 encoder positions of cross-attention)."""
    from f5tts_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_plain

    def err_of(q, k, v, bias):
        out = decode_attention(q, k, v, bias)
        torch.cuda.synchronize()
        ref = decode_attention_plain(q.float(), k.float(), v.float(), bias)
        check(out.shape == q.shape and out.dtype == q.dtype, "decode_attention output shape/dtype")
        return float((out.float() - ref).abs().max())

    bf, f32 = torch.bfloat16, torch.float32
    cases = (  # name, dtype, b, h, n_kv, total, d, options
        ("self b16", bf, 16, 16, 16, 503, 64, dict(bound=300, pad_row=3)),
        ("cross b16", bf, 16, 16, 16, 64, 64, dict(ragged=True, dead_row=5)),
        ("self GQA n_kv 4", bf, 16, 16, 4, 503, 64, dict(bound=411, pad_row=0)),
        ("self GQA group 8, d 128", bf, 4, 16, 2, 200, 128, dict(bound=150)),
        ("self group 3, d 32", bf, 3, 6, 2, 77, 32, dict(bound=40, dead_row=1)),
        ("self b1 (streaming)", bf, 1, 16, 16, 503, 64, dict(bound=502)),
        ("self b32", bf, 32, 16, 16, 503, 64, dict(bound=250, pad_row=31)),
        ("self fp32", f32, 16, 16, 16, 503, 64, dict(bound=300, pad_row=3)),
        ("cross fp32 GQA", f32, 4, 16, 8, 64, 64, dict(ragged=True, dead_row=2)),
    )
    errs = {}
    for i, (name, dtype, b, h, n_kv, total, d, opts) in enumerate(cases):
        tol = ATTN_TOL if dtype == bf else 1e-5
        errs[name] = e = err_of(*_decode_inputs(dev, dtype, b, h, n_kv, total, d, 100 + i, **opts))
        log(f"decode_attention {name}: {dtype} b={b} h={h} n_kv={n_kv} total={total} d={d} {opts}: "
            f"max abs err vs fp32 plain {e:.3e} (tol {tol})")
        check(np.isfinite(e) and e <= tol, f"decode_attention {name} error {e} > {tol}")

    # times at the two main-path shapes. Every layer has its own cache, so the
    # real caller finds K and V cold: the timed calls rotate over cache sets
    # that together exceed the 50 MB L2; "warm" repeats one set.
    rows = {}
    for name, b, total, opts in (("self", 16, 503, dict(bound=300, pad_row=3)),
                                 ("cross", 16, 64, dict(ragged=True, dead_row=5)),
                                 ("self_b1", 1, 503, dict(bound=300)), ("self_b32", 32, 503, dict(bound=300))):
        h = n_kv = 16
        d = 64
        set_bytes = 2 * b * n_kv * total * d * 2
        n_sets = max(2, -(-int(120e6) // set_bytes))
        sets = [_decode_inputs(dev, bf, b, h, n_kv, total, d, 200 + s, **opts) for s in range(min(n_sets, 64))]

        def library(q, k, v, bias):  # q is pre-scaled: scale 1
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias[:, None, None, :].to(q.dtype), scale=1.0)

        def in_turn(fn, n=24):  # 24 calls, as the 24 layers of one position, each on the next cache set
            return [(lambda a=sets[i % len(sets)]: fn(*a)) for i in range(n)]

        launches_before = decode_attention.launches
        ms_kernel = time_graph_ms(in_turn(decode_attention))
        ms_warm = time_graph_ms(in_turn(lambda *a: decode_attention(*sets[0])))
        ms_plain = time_graph_ms(in_turn(decode_attention_plain))
        ms_lib = time_graph_ms(in_turn(library))
        turn = iter(range(10**9))
        ms_eager = time_ms(lambda: decode_attention(*sets[next(turn) % len(sets)]))
        check(decode_attention.launches > launches_before, "decode_attention did not count its launches")
        lib_err = float((library(*sets[0]).float() - decode_attention_plain(*(t.float() for t in sets[0]))).abs().max())
        nbytes = set_bytes + 2 * b * h * d * 2 + b * total * 4  # K, V; q, o; bias
        bms, by = bound_ms(4.0 * b * h * total * d, nbytes, PEAK_BF16_FLOPS)
        log(f"decode_attention times, {name} (b {b}, h 16, total {total}, d 64, bf16; device time per call in a CUDA "
            f"graph of 24 calls over {len(sets)} cache sets in turn): kernel {ms_kernel:.5f} ms (one set repeated: "
            f"{ms_warm:.5f}), plain {ms_plain:.5f} ms, library (SDPA, bias as attn_mask; its max abs err vs fp32 "
            f"plain {lib_err:.3e}) {ms_lib:.5f} ms, bound {bms:.5f} ms ({by}) = {100 * bms / ms_kernel:.1f}% of the "
            f"kernel's time; one eager call with its host launch: {ms_eager:.4f} ms")
        rows[name] = {"ms": ms_kernel, "warm_ms": ms_warm, "plain_ms": ms_plain, "library_ms": ms_lib,
                      "bound_ms": bms, "bound_by": by, "eager_call_ms": ms_eager}
        del sets
        torch.cuda.empty_cache()
    return {"name": "decode_attention", "route": "cuda", "source": "f5tts_tpu_torch/csrc/decode_attention.cu",
            "replaces": "f5tts_tpu/ops/pallas/decode_attention.py:88", "max_abs_err": max(
                e for name, e in errs.items() if "fp32" not in name), **rows["self"],
            "other_shapes": {k: v for k, v in rows.items() if k != "self"}}


def _quant_inputs(dev, dtype, m, k, n, seed):
    """Activations with rows of very different magnitude and some all-zero
    (padding) rows, random int8 weights and positive column scales."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((m, k), generator=g) * torch.exp(2.0 * torch.randn((m, 1), generator=g))
    x[torch.rand((m,), generator=g) < 0.05] = 0.0
    w_q = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    s_w = (torch.rand((n,), generator=g) * 0.01 + 1e-4).float()
    return x.to(dev, dtype), w_q.to(dev), s_w.to(dev)


def quant_matmul_phase(dev) -> dict:
    """The fused W8A8 matmul at the shapes the int8 engine gives it at the
    bench geometry (16 x 1024 rows; q/k/v/out, ff in, ff out of F5-TTS Base),
    held bit-equal to its plain version: the integer product is exact and
    every fp32 step is one correctly rounded operation in a fixed order."""
    from f5tts_tpu_torch.ops.kernels.quant_matmul import (kernel_layout, mma_rate_probe, quant_matmul,
                                                          quant_matmul_plain)

    bf, f32 = torch.bfloat16, torch.float32
    kernel_floor, linear_floor = dict(amax_floor=1e-6, scale_floor=0.0), dict(amax_floor=0.0, scale_floor=1e-8)

    def differing(x, w_q, s_w, **floors):
        out = quant_matmul(x, w_q, s_w, w_qt=kernel_layout(w_q), **floors)
        torch.cuda.synchronize()
        ref = quant_matmul_plain(x, w_q, s_w, **floors)
        check(out.shape == ref.shape and out.dtype == x.dtype, "quant_matmul output shape/dtype")
        check(bool(torch.isfinite(out.float()).all()), "quant_matmul output not finite")
        return int((out != ref).sum()), float((out.float() - ref.float()).abs().max())

    cases = (  # name, dtype, M, K, N, floors
        ("q/k/v/out", bf, 16384, 1024, 1024, linear_floor), ("ff in", bf, 16384, 1024, 2048, linear_floor),
        ("ff out", bf, 16384, 2048, 1024, linear_floor), ("ragged fp32", f32, 1000, 1024, 2048, kernel_floor),
        ("K, N not multiples of the tile", bf, 77, 80, 48, kernel_floor),
        ("fp32, 32 rows per block", f32, 300, 4096, 64, linear_floor))
    worst = 0.0
    for i, (name, dtype, m, k, n, floors) in enumerate(cases):
        bad, err = differing(*_quant_inputs(dev, dtype, m, k, n, 300 + i), **floors)
        worst = max(worst, err)
        log(f"quant_matmul {name}: {dtype} ({m}, {k}) x ({k}, {n}), floors {floors}: {bad} of {m * n} elements differ "
            f"from the plain version, max abs difference {err:.3e} (must be bit-equal)")
        check(bad == 0, f"quant_matmul {name}: {bad} elements differ from the plain version")
    # the two floors: a zero row and a row of 1e-7 (abs-max under 1.27e-6, where the conventions part)
    for dtype in (bf, f32):
        x, w_q, s_w = _quant_inputs(dev, dtype, 64, 1024, 1024, 310)
        x[1] = 0.0
        x[2] = torch.where(x[3] >= 0, 1e-7, -1e-7).to(dtype)
        outs = {}
        for name, floors in (("abs-max 1e-6", kernel_floor), ("scale 1e-8", linear_floor)):
            bad, err = differing(x, w_q, s_w, **floors)
            outs[name] = quant_matmul(x, w_q, s_w, w_qt=kernel_layout(w_q), **floors)
            log(f"quant_matmul floors {dtype}, floor on {name}: {bad} elements differ from the plain version; zero row "
                f"max |out| {float(outs[name][1].abs().max()):.1e}, 1e-7 row max |out| {float(outs[name][2].abs().max()):.3e}")
            check(bad == 0 and float(outs[name][1].abs().max()) == 0.0, f"quant_matmul floor {name} ({dtype})")
        a, b = outs["abs-max 1e-6"], outs["scale 1e-8"]
        check(torch.equal(a[3:], b[3:]) and not torch.equal(a[2], b[2]),
              "the two floors must agree on ordinary rows and differ on the 1e-7 row")

    # the rate of the mma.sync s8 instruction alone (register operands, no memory): what the
    # kernel's product phase can reach at most, with the kernel's 8 warps per SM and with 32
    mma_rate = {}
    for warps_per_sm in (8, 32):
        blocks, iters = 132 * warps_per_sm // 8, 4096
        ms = time_ms(lambda: mma_rate_probe(blocks, iters, dev), iters=5, warmup=1)
        mma_rate[warps_per_sm] = blocks * 8 * 8 * iters * (16 * 8 * 32 * 2) / ms / 1e9
        log(f"mma.sync m16n8k32 s8 rate, {warps_per_sm} warps per SM, 8 independent accumulators per warp: "
            f"{mma_rate[warps_per_sm]:.1f} TOP/s ({100 * mma_rate[warps_per_sm] * 1e12 / PEAK_INT8_OPS:.1f}% of the "
            f"card's dense int8 peak)")

    log(f"time_ms of an empty call (what the event pair itself reads): {time_ms(lambda: None):.4f} ms")
    rows = {}
    for name, m, k, n in (("qkvo", 16384, 1024, 1024), ("ff_in", 16384, 1024, 2048), ("ff_out", 16384, 2048, 1024)):
        x, w_q, s_w = _quant_inputs(dev, bf, m, k, n, 320)
        w_qt = kernel_layout(w_q)
        w_bf = (w_q.float() * s_w).to(bf)
        launches_before = quant_matmul.launches
        ms_kernel = time_ms(lambda: quant_matmul(x, w_q, s_w, w_qt=w_qt, **linear_floor))
        check(quant_matmul.launches == launches_before + 23, "quant_matmul did not count its launches")
        ms_plain = time_ms(lambda: quant_matmul_plain(x, w_q, s_w, **linear_floor), iters=5, warmup=1)
        ms_bf16 = time_ms(lambda: x @ w_bf)
        sx = (x.float().abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
        xq = torch.round(x.float() / sx).to(torch.int8)

        def library():  # PyTorch's quantize ops, one library int8 GEMM, PyTorch's rescale
            sx_ = (x.float().abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
            xq_ = torch.round(x.float() / sx_).to(torch.int8)
            return ((torch._int_mm(xq_, w_q).float() * sx_) * s_w).to(bf)

        try:
            lib_err = float((library().float() - quant_matmul_plain(x, w_q, s_w, **linear_floor).float()).abs().max())
            ms_lib, ms_int_mm = time_ms(library), time_ms(lambda: torch._int_mm(xq, w_q))
        except (RuntimeError, AttributeError) as e:  # the yardstick only: this build has no int8 GEMM call
            log(f"quant_matmul {name}: torch._int_mm is not available here ({type(e).__name__}: {e})")
            lib_err = ms_lib = ms_int_mm = None
        nbytes = m * k * 2 + k * n + n * 4 + m * n * 2  # x, w_q, s_w, out
        bms, by = bound_ms(2.0 * m * k * n, nbytes, PEAK_INT8_OPS)
        log(f"quant_matmul times, {name} ({m}, {k}) x ({k}, {n}) bf16: kernel {ms_kernel:.4f} ms "
            f"({2.0 * m * k * n / ms_kernel / 1e9:.1f} TOP/s), plain {ms_plain:.4f} ms, library (PyTorch quantize + "
            f"torch._int_mm + rescale; its max abs difference from the plain version {lib_err}) {ms_lib} ms, of which "
            f"torch._int_mm on pre-quantized operands {ms_int_mm} ms; bf16 torch.matmul of the same shape "
            f"{ms_bf16:.4f} ms; bound {bms:.4f} ms ({by}) = {100 * bms / ms_kernel:.1f}% of the kernel's time")
        rows[name] = {"ms": ms_kernel, "plain_ms": ms_plain, "library_ms": ms_lib, "int_mm_ms": ms_int_mm,
                      "bf16_matmul_ms": ms_bf16, "bound_ms": bms, "bound_by": by}
        del x, w_q, s_w, w_qt, w_bf, xq, sx
        torch.cuda.empty_cache()
    return {"name": "quant_matmul", "route": "cuda", "source": "f5tts_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "f5tts_tpu/ops/pallas/quant_matmul.py:36", "max_abs_err": worst, **rows["qkvo"],
            "mma_sync_s8_top_s": mma_rate,
            "other_shapes": {k: v for k, v in rows.items() if k != "qkvo"}}


def ablate_attention_phase(dev) -> dict:
    """The layout ablation's kernel (the d = 64 attention core in the five
    layouts of ``scripts/ablate_attention.py``) at the ablation's shape, BH 256
    (fused CFG at batch 8: 16 rows x 16 heads), N 1024, bf16: every layout at
    BQ 64 and 128, with a zero bias and with the last quarter of the keys at
    -1e9, against its fp32 plain version and against the unpacked kernel; the
    shapes it refuses; then ``scripts/ablate_attention.run`` at BQ 64 (its
    default) and 128, with the occupancy of each layout. Returns the kernel row
    with the launches of the ablation path under ``ablation_launches``."""
    from f5tts_tpu_torch.ops.kernels.ablate_attention import (LAYOUTS, ablate_attention, ablate_attention_plain,
                                                              smem_bytes)
    from f5tts_tpu_torch.scripts.ablate_attention import SDPA, SHIPPING, TOL_VS_UNPACKED, run

    bh, n, d = 256, 1024, 64
    g = torch.Generator(device="cpu").manual_seed(7)
    q, k, v = (torch.randn((bh, n, d), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    zero = torch.zeros((1, 1, n), device=dev)
    tail = zero.clone()
    tail[..., 3 * n // 4:] = -1e9
    worst = 0.0
    for bias_name, bias in (("zero bias", zero), ("last quarter of the keys at -1e9", tail)):
        for layout in LAYOUTS:
            ref = ablate_attention_plain(layout, bias, q.float(), k.float(), v.float())
            for bq in (64, 128):
                out = ablate_attention(layout, bias, q, k, v, bq=bq)
                torch.cuda.synchronize()
                unpacked = out if layout == "unpacked" else ablate_attention("unpacked", bias, q, k, v, bq=bq)
                err = float((out.float() - ref).abs().max())
                vs = float((out.float() - unpacked.float()).abs().max())
                worst = max(worst, err)
                log(f"ablate_attention {layout} BQ {bq}, {bias_name}: max abs err vs fp32 plain {err:.3e} (tol "
                    f"{ATTN_TOL}), vs the unpacked kernel {vs:.3e} (tol {TOL_VS_UNPACKED})")
                check(np.isfinite(err) and err <= ATTN_TOL, f"ablate_attention {layout} BQ {bq} error {err}")
                check(vs <= TOL_VS_UNPACKED, f"ablate_attention {layout} BQ {bq} differs from unpacked by {vs}")
            del ref
    torch.cuda.empty_cache()

    # shapes the kernel does not take raise before any launch
    small = [t[:4, :128].contiguous() for t in (q, k, v)]
    b96, b128 = zero[..., :96].contiguous(), zero[..., :128].contiguous()
    refused = (("an odd BH on a pair layout", ValueError,
                lambda: ablate_attention("packed_blockdiag", b128, *(t[:3] for t in small))),
               ("N % BQ != 0", ValueError,
                lambda: ablate_attention("unpacked", b96, *(t[:, :96].contiguous() for t in small))),
               ("d != 64", ValueError,
                lambda: ablate_attention("unpacked", b128, *(t[..., :32].contiguous() for t in small))),
               ("fp32", TypeError, lambda: ablate_attention("unpacked", b128, *(t.float() for t in small))))
    before = ablate_attention.launches
    for what, exc, call in refused:
        try:
            call()
        except exc as e:
            log(f"ablate_attention refuses {what}: {type(e).__name__}: {e}")
        else:
            check(False, f"ablate_attention took {what}")
    check(ablate_attention.launches == before, "a refused shape launched the kernel")

    # the ablation path: its launches counted from 0 and read right after
    ablate_attention.launches = 0
    runs = {bq: run(bh, n, bq, 50, 3, device=dev) for bq in (64, 128)}
    launches = ablate_attention.launches
    ablate_attention.launches = 0
    check(launches > 0, "the ablation did not launch the kernel")
    ms_plain = time_ms(lambda: ablate_attention_plain("unpacked", zero, q, k, v), iters=5, warmup=1)
    bms, by = bound_ms(4.0 * bh * n * n * d, 4 * bh * n * d * 2 + n * 4, PEAK_BF16_FLOPS)  # q, k, v, o; bias
    for bq, rows in runs.items():
        by_name = {r["name"]: r for r in rows}
        unp, ship = by_name["unpacked"]["ms"], by_name[SHIPPING]["ms"]
        log(f"ablation at BQ {bq} (BH {bh}, N {n}, D 64, bf16, zero bias; device time per call in a CUDA graph of 50 "
            f"chained calls, median of 3 replays; shared memory per block: "
            f"{ {name: smem_bytes(name, bq) for name in LAYOUTS} } bytes):")
        for r in rows:
            extra = "" if r["mma"] is None else (
                f", {r['mma']} mma.sync per call ({r['mma'] / by_name['unpacked']['mma']:.2f}x unpacked), "
                f"{r['warps_per_sm']} warps per SM")
            log(f"  {r['name']:>22}: {r['ms']:.4f} ms = {r['ms'] / unp:.3f}x unpacked, {r['ms'] / ship:.3f}x the "
                f"shipping kernel, bound {100 * bms / r['ms']:.1f}% of it; max abs diff vs unpacked "
                f"{r['max_abs_diff']:.4f}{extra}")
    log(f"ablate_attention: plain unpacked {ms_plain:.4f} ms, bound {bms:.4f} ms ({by}: the true work 4 BH N^2 D, the "
        f"same for every layout); {launches} launches on the ablation path")
    main_rows = {r["name"]: r for r in runs[64]}
    return {"name": "ablate_attention", "route": "cuda", "source": "f5tts_tpu_torch/csrc/ablate_attention.cu",
            "replaces": "scripts/ablate_attention.py:177", "max_abs_err": worst, "ms": main_rows["unpacked"]["ms"],
            "plain_ms": ms_plain, "bound_ms": bms, "bound_by": by, "library_ms": main_rows[SDPA]["ms"],
            "layouts_ms": {name: main_rows[name]["ms"] for name in LAYOUTS},
            "ablation_rows": {f"bq{bq}": {r["name"]: {key: r[key] for key in ("ms", "mma", "warps_per_sm")}
                                          for r in rows} for bq, rows in runs.items()},
            "ablation_launches": launches}


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
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm

    engine = TTSEngine(dit_np, dit_cfg, voc_np, tok, EngineConfig(vocoder=voc_cfg), device=dev)
    solves = _count_solves(engine)
    requests = [
        ("Hello there, this is a short test of the ported engine.", synthetic_ref(2.5, 140.0, 0),
         "A short reference clip."),
        ("नमस्ते, यह एक लंबा परीक्षण वाक्य है जो कई हिस्सों में बाँटा जाएगा। " * 4
         + "The same request mixes scripts, so the chunker packs words into several rows of one bucket.",
         synthetic_ref(3.0, 110.0, 1), "यह संदर्भ वाक्य है।"),
        ("ನಮಸ್ಕಾರ, ಇದು ಮೂರನೇ ವಿನಂತಿ.", synthetic_ref(4.0, 180.0, 2), "Reference speech for the third voice."),
    ]
    n_blocks = dit_cfg.depth
    wrappers = {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos}
    for w in wrappers.values():
        w.launches = 0
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
    got = {name: w.launches for name, w in wrappers.items()}
    for name, count in got.items():
        launches[name]["serve"] = count
    n_forwards = sum(forwards for forwards, _ in solves)  # each one fused 2b-row forward
    # per forward: each block's attention kernel and its RoPE pre-pass; the conv-pos pair is one launch
    want = {"flash_attention": n_blocks * n_forwards, "rope_rows": n_blocks * n_forwards, "conv_pos": n_forwards}
    log(f"engine: {len(requests)} requests, {len(solves)} solves (forwards, rows) {solves} in {wall:.3f} s; launches "
        f"{got} (want {want})")
    check(any(b > 1 for _, b in solves), "no solve batched several rows")
    check(got == want and n_forwards > 0, f"engine launch counts {got}, want {want}")

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


INT8_FORWARD_REL, INT8_FORWARD_COS = 0.1, 0.995  # what tests/test_quantization.py holds the JAX package to
QUANTIZED_LINEARS = 6  # to_q, to_k, to_v, to_out, ff in, ff out of every block


def _count_solves(engine) -> list:
    """Record ``(model forwards, rows)`` of every bucket program the engine
    runs: 2 evals per Ralston interval, 1 per euler step of the recipe."""
    solves = []
    program = engine.bucket_program

    def counted(*a, **kw):
        solves.append((kw["steps"] * (1 if kw.get("recipe") else 2), a[0].shape[0]))
        return program(*a, **kw)

    engine.bucket_program = counted
    return solves


def int8_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, launches: dict, bf16_bench: dict) -> None:
    """The int8 (W8A8) engine at F5-TTS Base + Vocos: one request with exact
    launch counts, parity against the bf16 engine, the bench geometry beside
    the bf16 figure, then strict, batch and streaming requests."""
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.models.dit import dit_forward
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.quant_matmul import quant_matmul

    wrappers = {"quant_matmul": quant_matmul, "flash_attention": flash_attention, "rope_rows": rope_rows,
                "conv_pos": conv_pos}
    # per DiT forward: every block's six linears, its attention kernel and that kernel's RoPE pre-pass; one conv pair
    per_forward = {"quant_matmul": QUANTIZED_LINEARS * dit_cfg.depth, "flash_attention": dit_cfg.depth,
                   "rope_rows": dit_cfg.depth, "conv_pos": 1}
    engine = TTSEngine(dit_np, dit_cfg, voc_np, tok, EngineConfig(vocoder=voc_cfg, quantization="int8"), device=dev)
    blocks = engine.dit_params["blocks"]
    for group, name in [("attn", n) for n in ("to_q", "to_k", "to_v", "to_out")] + [("ff", "in"), ("ff", "out")]:
        lin = blocks[group][name]
        check("w" not in lin and lin["w_q"].dtype == torch.int8 and lin["s_w"].dtype == torch.float32
              and lin["w_qt"].shape == (dit_cfg.depth, lin["w_q"].shape[2], lin["w_q"].shape[1]),
              f"{group}.{name} is not quantized with its kernel layout")
    solves = _count_solves(engine)

    def counted(what: str, path: str, fn):
        """Run ``fn`` with the four counts set to 0 before it; they must equal
        what the solves it ran need, exactly."""
        for w in wrappers.values():
            w.launches = 0
        del solves[:]
        out = fn()
        torch.cuda.synchronize()
        forwards = sum(f for f, _ in solves)
        got = {name: w.launches for name, w in wrappers.items()}
        want = {name: per_forward[name] * forwards for name in wrappers}
        log(f"{what}: solves (forwards, rows) {list(solves)}; launches {got} (want {want}: per DiT forward "
            f"{per_forward})")
        check(got == want and forwards > 0, f"{what}: launches {got}, want {want}")
        for name in wrappers:
            launches[name][path] = launches[name].get(path, 0) + got[name]
        return out

    ref, ref_text = synthetic_ref(3.0, 120.0, 4), "A reference clip for the int8 engine."
    text = "This request runs every block's six linears through the int8 tensor-core kernel."
    plan = engine.prepare_request(text, ref, 24000, ref_text, seed=7)
    t0 = time.perf_counter()
    wave, sr, mel = counted("int8 request", "serve_int8", lambda: engine.synthesize(text, ref, 24000, ref_text, seed=7))
    log(f"int8 request: {len(plan.rows)} rows, {len(wave) / sr:.3f} s of audio in {time.perf_counter() - t0:.3f} s; mel {mel.shape}")
    check(sr == 24000 and len(wave) == planned_length(engine, plan), "int8 request: wrong waveform length")
    check(bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) > 0 and bool(np.isfinite(mel).all()),
          "int8 request: wave or mel not finite/non-zero")

    # parity against the bf16 engine: one DiT forward (the JAX package's own
    # test and bounds), then a whole solve from the same noise
    plain = TTSEngine(dit_np, dit_cfg, voc_np, tok, EngineConfig(vocoder=voc_cfg), device=dev)
    rng = np.random.default_rng(5)
    pb, pn, pref = 2, 256, 64
    cond = torch.as_tensor(rng.standard_normal((pb, pn, 100)), dtype=torch.float32, device=dev)
    cl = torch.full((pb,), pref, dtype=torch.int32, device=dev)
    ids = torch.as_tensor(rng.integers(0, 90, (pb, 48)), dtype=torch.int32, device=dev)
    dur = torch.tensor([pn, pn - 40], dtype=torch.int32, device=dev)
    y0 = torch.as_tensor(rng.standard_normal((pb, pn, 100)), dtype=torch.float32, device=dev)
    valid = torch.arange(pn, device=dev)[None] < dur[:, None]
    gen = valid & (torch.arange(pn, device=dev)[None] >= pref)

    def rel_cos(a, b, rows):
        a, b = a.float()[rows], b.float()[rows]
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)), float(
            (a * b).sum() / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)))

    f = torch.zeros((pb,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        fwd = [dit_forward(e.dit_params, e.dit_cfg, y0, cond, ids, torch.tensor([0.4, 0.6], device=dev), f, f, valid,
                           compute_dtype=torch.bfloat16) for e in (engine, plain)]
    rel, cos = rel_cos(fwd[0], fwd[1], valid)
    log(f"parity, one DiT forward (2 x 256 frames, bf16): int8 against bf16, relative L2 {rel:.4f} (tol "
        f"{INT8_FORWARD_REL}), cosine {cos:.5f} (tol {INT8_FORWARD_COS}) over valid frames")
    check(rel < INT8_FORWARD_REL and cos > INT8_FORWARD_COS, f"int8 forward diverged from bf16: rel {rel}, cos {cos}")
    mels = [e.bucket_program(cond, cl, ids, dur, steps=10, cfg_strength=2.0, y0=y0)[0] for e in (engine, plain)]
    gen0 = gen.roll(-pref, 1)  # the program rolls the generated frames to the origin
    rel, cos = rel_cos(mels[0], mels[1], gen0)
    log(f"parity, one solve from the same y0 (Ralston NFE 20, CFG 2): int8 against bf16 engine, generated mel "
        f"relative L2 {rel:.4f} (tol {INT8_SOLVE_REL}), cosine {cos:.5f} (tol {INT8_SOLVE_COS}) over generated frames")
    check(rel < INT8_SOLVE_REL and cos > INT8_SOLVE_COS, f"int8 solve diverged from bf16: rel {rel}, cos {cos}")
    del plain, fwd, mels
    torch.cuda.empty_cache()

    # strict: the estimate of every row, escalation past the threshold
    strict = counted("int8 strict request", "serve_int8", lambda: engine.synthesize(
        "A strict request estimates its own solver error.", ref, 24000, ref_text, seed=8, quality="strict"))
    log(f"strict: estimates {engine.last_estimates} against threshold {engine.cfg.strict_threshold}; "
        f"escalations {engine.escalations}; {len(strict[0]) / 24000:.3f} s of audio")
    check(len(engine.last_estimates) == 1 and all(np.isfinite(e) and e > 0 for e in engine.last_estimates.values()),
          "strict request recorded no estimate")
    check(engine.escalations == sum(e > engine.cfg.strict_threshold for e in engine.last_estimates.values()),
          "escalation count does not follow the estimates")
    check(bool(np.isfinite(strict[0]).all()) and len(strict[0]) > 0, "strict wave not finite")

    # synthesize_batch: three chunks of one voice as one batched solve
    row = plan.rows[0]
    chunks = ["the first chunk.", "a second, longer chunk of text.", "and a third."]
    durations = [row.ref_frames + 150, row.ref_frames + 220, row.ref_frames + 120]  # all in the 512 bucket
    waves, mels = counted("int8 synthesize_batch", "serve_int8", lambda: engine.synthesize_batch(
        chunks, row.cond_mel, row.ref_frames, ref_text + " ", durations, steps=10, cfg_strength=2.0, seed=9))
    check([len(m_) for m_ in mels] == [d - row.ref_frames for d in durations], "synthesize_batch mel lengths")
    check(all(len(w) == engine._wave_samples(len(m_)) and np.isfinite(w).all() and np.abs(w).max() > 0
              for w, m_ in zip(waves, mels)), "synthesize_batch waves")
    check(solves == [(20, 4)], f"synthesize_batch did not run as one solve of the batch-4 bucket: {solves}")

    # streaming: the concatenated segments against synthesize's wave, same seed
    long_text = ("Streaming hands back each chunk as its solve ends, so the first audio arrives early. " * 5).strip()
    full = counted("int8 synthesize (batched chunks)", "serve_int8",
                   lambda: engine.synthesize(long_text, ref, 24000, ref_text, seed=10))[0]
    t0 = time.perf_counter()
    first = [None]

    def stream():
        out = []
        for seg in engine.synthesize_streaming(long_text, ref, 24000, ref_text, seed=10):
            first[0] = first[0] or time.perf_counter() - t0
            out.append(seg)
        return out

    segments = counted("int8 synthesize_streaming", "serve_int8", stream)
    joined = np.concatenate(segments)
    check(joined.shape == full.shape and len(segments) > 1, f"stream {joined.shape} in {len(segments)} segments vs {full.shape}")
    rel_rms = float(np.sqrt(np.mean((joined - full) ** 2)) / np.sqrt(np.mean(full**2)))
    log(f"streaming: {len(segments)} segments of {[len(s_) for s_ in segments]} samples, first after {first[0]:.3f} s, "
        f"all after {time.perf_counter() - t0:.3f} s; against synthesize's wave (chunks solved as one batch): max abs "
        f"difference {float(np.abs(joined - full).max()):.3e} at a peak of {float(np.abs(full).max()):.3f}, RMS of "
        f"the difference over the wave's RMS {rel_rms:.3e} (tol {STREAM_REL_RMS})")
    check(rel_rms <= STREAM_REL_RMS, f"streamed wave differs from synthesize's: {rel_rms}")
    del engine
    torch.cuda.empty_cache()

    # the bench geometry at int8, beside the bf16 figure of this run
    for w in wrappers.values():
        w.launches = 0
    int8_bench = bench_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, quantization="int8")
    for name, w in wrappers.items():
        launches[name]["bench_int8"] = w.launches
    forwards = 5 * 20  # a warm call, the profiled call and three timed ones, 20 forwards each
    check(all(w.launches == per_forward[name] * forwards for name, w in wrappers.items()),
          f"int8 bench launch counts {({name: w.launches for name, w in wrappers.items()})}, want "
          f"{({name: per_forward[name] * forwards for name in wrappers})}")
    gemm_bf16, gemm_int8 = bf16_bench["launch_counts"].get("gemm", 0), int8_bench["launch_counts"].get("gemm", 0)
    moved = per_forward["quant_matmul"] * 20
    log(f"int8 against bf16 at the bench geometry on {card}: {int8_bench['audio_s_per_s']:.2f} against "
        f"{bf16_bench['audio_s_per_s']:.2f} audio-s/s (median solve {int8_bench['median_s']:.4f} against "
        f"{bf16_bench['median_s']:.4f} s); library GEMM launches per solve {gemm_int8} against {gemm_bf16}, "
        f"quant_matmul launches per solve {int8_bench['launch_counts'].get('quant_matmul', 0)} (want {moved})")
    check(int8_bench["launch_counts"].get("quant_matmul", 0) == moved and gemm_int8 == gemm_bf16 - moved,
          "the six linears of every block did not all move from library GEMMs to quant_matmul")


BENCH_FAMILIES = (("flash_attention", ("flash_wgmma", "flash_fwd")), ("rope_rows", ("rope_rows",)),
                  ("conv_pos", ("conv_pair", "conv_generic")), ("quant_matmul", ("quant_matmul_kernel",)))


def bench_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, quantization: str = "none") -> dict:
    """One bucket program at the bench geometry, profiled once and timed three
    times. Returns the audio-s/s, the median seconds and the profile's launch
    counts by kernel family."""
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.sampling.euler import DEFAULT_NFE, nfe_to_steps

    batch, n, ref_frames, text_pad = 8, 1024, 128, 512
    steps = nfe_to_steps(DEFAULT_NFE["ralston"], "ralston")
    engine = TTSEngine(dit_np, dit_cfg, voc_np, tok, EngineConfig(
        vocoder=voc_cfg, duration_buckets=(n,), batch_buckets=(batch,), text_pad=text_pad,
        quantization=quantization), device=dev)
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
    what = "bf16" if quantization == "none" else quantization
    _, counts = profile_by_family(f"one bench solve ({what})", run, BENCH_FAMILIES)
    forwards = steps * 2  # Ralston: two DiT forwards per step
    want = {"flash_attention": dit_cfg.depth * forwards, "rope_rows": dit_cfg.depth * forwards, "conv_pos": forwards}
    got = {fam: counts.get(fam, 0) for fam in want}
    check(got == want, f"bench solve ({what}): kernel launches in the profile {got}, want {want}")
    iters = []
    for _ in range(3):
        t0 = time.perf_counter()
        check(np.isfinite(run()), "bench waveform not finite")
        iters.append(time.perf_counter() - t0)
    dt = statistics.median(iters)
    audio_s = batch * (n - ref_frames) / (24000 / 256)
    log(f"bench geometry on {card}: batch {batch}, bucket {n}, ref {ref_frames}, ralston NFE 20, CFG 2, {what}: "
        f"iter_s {[round(t, 4) for t in iters]}, median {dt:.4f} s, {audio_s / dt:.2f} audio-s/s")
    return {"audio_s_per_s": audio_s / dt, "median_s": dt, "launch_counts": counts}


COMMON_FAMILIES = (("gemm", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitK")), ("reduction", ("reduce_kernel",)),
                   ("elementwise", ("elementwise", "vectorized", "unrolled")))


def profile_by_family(what: str, run, families, *, top: int = 6, device_only: bool = False,
                      wall_plain_ms: float | None = None) -> tuple[dict, dict]:
    """Device time of one call of ``run`` (which ends synchronised) by kernel
    family (``torch.profiler``, kernels only) and the device's busy share of
    the wall time (single stream: kernels do not overlap); returns the device
    milliseconds and the launch counts by family. ``families`` come
    before the common ones; ``device_only`` records no host events (a call
    with hundreds of thousands of launches); ``wall_plain_ms`` is the same
    call's wall time without the profiler, to state the busy share against."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_all = time.perf_counter()
    activities = [ProfilerActivity.CUDA] if device_only else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities, acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    sums: dict[str, float] = {}
    counts: dict[str, int] = {}
    for e in kernels:
        fam = next((f for f, keys in (*families, *COMMON_FAMILIES) if any(k in e.key for k in keys)), "other")
        sums[fam] = sums.get(fam, 0.0) + e.self_device_time_total / 1e3
        counts[fam] = counts.get(fam, 0) + e.count
    busy = sum(sums.values())
    plain = "" if wall_plain_ms is None else (
        f"; without the profiler the call took {wall_plain_ms:.1f} ms: {100 * busy / wall_plain_ms:.1f}% busy, "
        f"{100 - 100 * busy / wall_plain_ms:.1f}% idle of that")
    log(f"profile of {what}: wall {wall_ms:.1f} ms (profiler on), {sum(counts.values())} device launches, kernels "
        f"{busy:.1f} ms = {100 * busy / wall_ms:.1f}% busy, {100 - 100 * busy / wall_ms:.1f}% idle{plain} "
        f"(profiling took {time.perf_counter() - t_all:.1f} s in all)")
    for fam, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.1f} ms ({100 * ms / busy:.1f}% of kernel time), {counts[fam]} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  kernel {e.key[:80]!r}: {e.self_device_time_total / 1e3:.1f} ms, {e.count} launches")
    return sums, counts


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
        # as the training attention hands them over: q and k made by the RoPE's cat, v and dO head-split views
        q, k = (torch.randn((b, h, n, d), generator=g).to(dev, torch.bfloat16) for _ in range(2))
        v, do = _head_split(g, dev, torch.bfloat16, b, h, n, d)[:2]
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
        qc, kc, vc = (t.contiguous() for t in (q, k, v))  # SDPA in its own layout
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (qc, kc, vc))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc))
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True))
        lib_both = time_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), do))
        plain_fwd = plain_bwd = None
        elems = b * h * n * d
        fb, fby = bound_ms(4.0 * b * h * n * n * d, 4 * elems * 2 + b * h * n * 4, PEAK_BF16_FLOPS)
        bb, bby = bound_ms(10.0 * b * h * n * n * d, 8 * elems * 2 + b * h * n * 4, PEAK_BF16_FLOPS)
        log(f"train attention b={b} n={n} times: forward {fwd_ms:.4f} ms (bound {fb:.4f} {fby}, SDPA {lib_fwd:.4f}), "
            f"backward {bwd_ms:.4f} ms (bound {bb:.4f} {bby}, SDPA backward {lib_bwd:.4f}, SDPA forward+backward "
            f"{lib_both:.4f}); one eager call each")
        if what.startswith("one"):  # the main-path shape: views, determinism, graph times, the kernels line
            views_equal = _train_views_check(ft, q, k, v, do, o, lse, (dq, dk, dv))
            again = ft.flash_attention_train_bwd(q, k, v, o, lse, do)
            deterministic = all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
            del again
            log(f"train attention at the training shape: head-split views vs the same values contiguous, o / lse / "
                f"dq / dk / dv bit-equal: {views_equal}; two backward calls bit-equal: {deterministic}")
            check(views_equal, "the training kernels on head-split views differ from the contiguous call")
            check(deterministic, "two backward calls differ")
            plain_fwd = time_ms(lambda: ft.flash_attention_train_fwd_plain(q, k, v), iters=5, warmup=1)
            plain_bwd = time_ms(lambda: ft.flash_attention_train_bwd_plain(q, k, v, o, lse, do), iters=5, warmup=1)
            graph, variants = _train_graph_times(ft, q, k, v, do, o, lse, (qc, kc, vc), (qs, ks, vs))
            # device time by kernel: the two backward passes apart, and SDPA's own kernels (the backend its
            # autograd picks, which a CUDA graph does not capture here) beside them
            profile_by_family("ten forward and ten backward calls at the training shape, then SDPA's ten of each",
                              lambda: ([ft.flash_attention_train_fwd(q, k, v) for _ in range(10)],
                                       [ft.flash_attention_train_bwd(q, k, v, o, lse, do) for _ in range(10)],
                                       [F.scaled_dot_product_attention(qc, kc, vc) for _ in range(10)],
                                       [torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
                                        for _ in range(10)], torch.cuda.synchronize()),
                              (("flash_attention_train", ("fwd_lse", "bwd_wgmma")),
                               ("sdpa", ("flash", "fmha", "sdpa", "cudnn", "attention"))), top=8, device_only=True)
            log(f"train attention device time per call in a CUDA graph of 10 calls: forward {graph['fwd']:.4f} ms, "
                f"backward {graph['bwd']:.4f} ms (dQ + dK/dV); SDPA forward {graph['sdpa_fwd']}, backward (its flash "
                f"backward op) {graph['sdpa_bwd']}, the two {graph['sdpa_both']}; bounds {fb:.4f} / "
                f"{bb:.4f} ms (two passes that recompute S and dP: {bb * 1.4:.4f} ms); plain forward {plain_fwd:.4f} "
                f"ms, plain backward {plain_bwd:.4f} ms (eager)")
            log("train attention without and with the key bias (graph, ms per call): "
                + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in variants.items()))
            rows = [
                {"name": "flash_attention_train_fwd", "route": "cuda",
                 "source": "f5tts_tpu_torch/csrc/flash_attention_train.cu",
                 "replaces": "f5tts_tpu/ops/pallas/flash_attention.py:387", "max_abs_err": max(err_o, err_lse),
                 "ms": fwd_ms, "plain_ms": plain_fwd, "bound_ms": fb, "bound_by": fby, "library_ms": lib_fwd,
                 "graph_ms": {"kernel": graph["fwd"], "sdpa": graph["sdpa_fwd"]},
                 "variants_ms": {k_: v_ for k_, v_ in variants.items() if k_.startswith("fwd")}},
                {"name": "flash_attention_train_bwd", "route": "cuda",
                 "source": "f5tts_tpu_torch/csrc/flash_attention_train.cu",
                 "replaces": "f5tts_tpu/ops/pallas/flash_attention.py:401", "max_abs_err": max(errs),
                 "ms": bwd_ms, "plain_ms": plain_bwd, "bound_ms": bb, "bound_by": bby, "library_ms": lib_bwd,
                 "graph_ms": {"kernel": graph["bwd"], "sdpa_backward": graph["sdpa_bwd"],
                              "sdpa_forward_backward": graph["sdpa_both"]},
                 "variants_ms": {k_: v_ for k_, v_ in variants.items() if k_.startswith("bwd")}},
            ]
        del q, k, v, do, o, lse, dq, dk, dv, qs, ks, vs, qc, kc, vc, out
        torch.cuda.empty_cache()
    return rows


def _train_views_check(ft, q, k, v, do, o, lse, grads) -> bool:
    """The same values as contiguous tensors give bit-equal o, lse, dq, dk, dv."""
    dense = [t.contiguous() for t in (q, k, v, do)]
    o_c, lse_c = ft.flash_attention_train_fwd(*dense[:3])
    same = torch.equal(o, o_c) and torch.equal(lse, lse_c)
    grads_c = ft.flash_attention_train_bwd(*dense[:3], o_c.contiguous(), lse_c, dense[3])
    same = same and all(torch.equal(x, y) for x, y in zip(grads, grads_c))
    del dense, o_c, lse_c, grads_c
    return same


def _train_graph_times(ft, q, k, v, do, o, lse, contiguous, leaves) -> tuple[dict, dict]:
    """Device time per call in a CUDA graph of 10 calls: the kernels as the
    training path calls them, SDPA beside them, and the key-bias paths of
    both under an all-True mask."""
    every = torch.ones(q.shape[0], q.shape[2], dtype=torch.bool, device=q.device)
    graph = {"fwd": time_graph_ms([lambda: ft.flash_attention_train_fwd(q, k, v)] * 10),
             "bwd": time_graph_ms([lambda: ft.flash_attention_train_bwd(q, k, v, o, lse, do)] * 10)}
    qc, kc, vc = contiguous
    graph["sdpa_fwd"] = time_graph_ms([lambda: F.scaled_dot_product_attention(qc, kc, vc)] * 10)
    try:  # SDPA's flash backward called as one op (autograd does not capture here): the library yardstick only
        fwd_op = torch.ops.aten._scaled_dot_product_flash_attention
        bwd_op = torch.ops.aten._scaled_dot_product_flash_attention_backward
        out, lse_s, cq, ck, mq, mk, seed, offset, _ = fwd_op(qc, kc, vc, 0.0, False, False)
        doc = do.contiguous()
        graph["sdpa_bwd"] = time_graph_ms(
            [lambda: bwd_op(doc, qc, kc, vc, out, lse_s, cq, ck, mq, mk, 0.0, False, seed, offset)] * 10)
        graph["sdpa_both"] = graph["sdpa_fwd"] + graph["sdpa_bwd"]
    except (RuntimeError, TypeError, AttributeError) as e:
        log(f"SDPA's flash backward op could not be timed in a CUDA graph ({e}); its eager times stand")
        graph["sdpa_both"] = graph["sdpa_bwd"] = None
    variants = {
        "fwd_no_bias": graph["fwd"],
        "fwd_bias_all_valid": time_graph_ms([lambda: ft.flash_attention_train_fwd(q, k, v, every)] * 10),
        "bwd_no_bias": graph["bwd"],
        "bwd_bias_all_valid": time_graph_ms([lambda: ft.flash_attention_train_bwd(q, k, v, o, lse, do, every)] * 10),
    }
    return graph, variants


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


TRAIN_SHAPES = ((37, 1024), (12, 3072), (37, 1024), (37, 1024), (37, 1024))  # (rows, frames) per step


def train_phase(dev, model, shapes, tok, card: str, launches: dict) -> None:
    from f5tts_tpu_torch.models.cfm import CFMConfig
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
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
                "conv_pos": 1, "flash_attention": 0, "rope_rows": 0}
    wrappers = {"flash_attention_train_fwd": flash_attention_train_fwd,
                "flash_attention_train_bwd": flash_attention_train_bwd, "conv_pos": conv_pos,
                "flash_attention": flash_attention, "rope_rows": rope_rows}
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
    profile_by_family("one train step", lambda: (trainer.step(state, batches[2]), torch.cuda.synchronize()), (
        ("flash_attention_train_fwd", ("fwd_lse",)), ("flash_attention_train_bwd", ("bwd_wgmma", "bwd_dkdv", "bwd_dq")),
        ("conv_pos", ("conv_pair", "conv_generic"))), top=8)
    del state, trainer
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Parler: autoregressive serving (T5 encoder, delay-pattern decoder, DAC)
# ---------------------------------------------------------------------------

PARLER_LOGIT_TOL = 5e-2  # step logits (|logit| < 2), bf16 + kernel vs fp32 + plain: bf16 rounding through 2 layers
# streamed vs batch waveform, bf16, same tokens: the DAC's windows differ in width from the full decode, so cuDNN
# rounds other sums; that is the size of bf16 against fp32 in the DAC (~2e-3 at a wave peak of ~0.05 with random
# weights). A flipped token would show as a difference of the order of the peak.
PARLER_STREAM_TOL = 1e-2


def parler_logit_parity(dev) -> None:
    """Step logits of a short greedy decode at a small geometry (GQA, padded
    prompt, ragged encoder mask): bf16 + kernel + fused q|k|v, teacher-forced
    with the fp32 + plain path's tokens, against that path's logits."""
    from f5tts_tpu_torch.models import parler as P
    from f5tts_tpu_torch.models.convert import init_parler_decoder_numpy, params_from_numpy

    geo = dict(vocab=64, codebooks=4, hidden=256, layers=2, heads=4, ffn=512, cross_dim=256, prompt_vocab=50,
               kv_heads=2, cross_kv_heads=2)
    tree = init_parler_decoder_numpy(P.ParlerDecoderConfig(**geo), seed=7)
    rng = np.random.default_rng(8)
    b, frames, enc_n, p = 3, 24, 12, 6
    enc = torch.as_tensor(rng.standard_normal((b, enc_n, 256)), dtype=torch.float32, device=dev)
    enc_mask = torch.as_tensor(np.arange(enc_n)[None] < np.array([[12], [7], [3]]), device=dev)
    prompt = torch.as_tensor(rng.integers(0, 50, (b, p)), device=dev)
    prompt_mask = torch.as_tensor(np.arange(p)[None] >= np.array([[0], [2], [5]]), device=dev)
    runs = {}
    forced = None
    for name, dtype, attn, fuse in (("plain", torch.float32, "plain", False), ("kernel", torch.bfloat16, "kernel", True)):
        cfg = P.ParlerDecoderConfig(**geo, decode_attn=attn, fuse_decode_qkv=fuse)
        ctx = P._decode_ctx(params_from_numpy(tree, dev, dtype), cfg, enc, enc_mask, frames, 0, prompt, prompt_mask,
                            None, None, -1, 0.0, 0, None, dtype)
        carry, logits, toks, greedy = ctx.carry0, [], [], []
        for j in range(1, ctx.steps + 1):
            logits.append(carry[0])
            greedy.append(torch.argmax(carry[0], -1))
            carry, tok = ctx.step(carry, j, forced=None if forced is None else forced[j - 1])
            toks.append(tok)
        runs[name] = (torch.stack(logits), torch.stack(greedy))
        forced = forced if forced is not None else toks
    err = float((runs["kernel"][0] - runs["plain"][0]).abs().max())
    peak = float(runs["plain"][0].abs().max())
    agree = float((runs["kernel"][1] == runs["plain"][1]).float().mean())
    log(f"parler parity (hidden 256, 2 layers, 4 heads of 64 over 2 KV heads, 4 codebooks, {frames} frames, padded "
        f"prompt, ragged encoder mask): bf16 + kernel + fused q|k|v vs fp32 + plain, teacher-forced step logits "
        f"max abs err {err:.3e} at peak |logit| {peak:.3f} (tol {PARLER_LOGIT_TOL}); greedy tokens agree at "
        f"{100 * agree:.1f}% of positions (not required)")
    check(np.isfinite(err) and err <= PARLER_LOGIT_TOL, f"parler step logits diverged: {err}")


def parler_phase(dev, card: str, launches: dict) -> None:
    from f5tts_tpu_torch.engine.ar_engine import ParlerEngineConfig, ParlerRow, ParlerTTSEngine
    from f5tts_tpu_torch.engine.batcher import ContinuousBatcher
    from f5tts_tpu_torch.models import parler as P
    from f5tts_tpu_torch.models.convert import init_dac_numpy, init_parler_decoder_numpy, init_t5_numpy
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.decode_attention import decode_attention
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train_bwd, flash_attention_train_fwd
    from f5tts_tpu_torch.train.tree import tree_leaves

    parler_logit_parity(dev)
    others = {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos,
              "flash_attention_train_fwd": flash_attention_train_fwd,
              "flash_attention_train_bwd": flash_attention_train_bwd}
    total_launches = [0]

    def counted(what: str, fn, want: int | None):
        """Run ``fn`` with every count set to 0 before it; the decode kernel's
        count must equal ``want`` (where given) and the F5 kernels' stay 0."""
        decode_attention.launches = 0
        for w in others.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = decode_attention.launches
        total_launches[0] += n
        stray = {name: w.launches for name, w in others.items() if w.launches}
        log(f"{what}: decode_attention launches {n}" + (f" (want {want})" if want is not None else ""))
        check(n > 0 and (want is None or n == want), f"{what}: decode_attention launches {n}, want {want}")
        check(not stray, f"{what}: F5 kernels launched on the Parler path: {stray}")
        return out

    # indic-parler-tts: flan-t5-large encoder, 24-layer decoder over 9 codebooks, 44.1 kHz DAC
    t5_cfg, dec_cfg, dac_cfg = P.T5Config(), P.ParlerDecoderConfig(), P.DacConfig()
    layers, K, hop = dec_cfg.layers, dec_cfg.codebooks, dac_cfg.hop
    t0 = time.perf_counter()
    trees = (init_t5_numpy(t5_cfg, seed=0), init_parler_decoder_numpy(dec_cfg, seed=1), init_dac_numpy(dac_cfg, seed=2))
    n_params = [sum(t.size for _, t in tree_leaves(tree)) for tree in trees]
    log(f"parler params (T5 {n_params[0]}, decoder {n_params[1]}, DAC {n_params[2]}; seeds 0, 1, 2) in "
        f"{time.perf_counter() - t0:.1f} s")

    def encode_fn(text):  # stand-in for the T5 sentencepiece tokenizer, which ships with the checkpoint
        return [ord(c) % t5_cfg.vocab for c in text]

    frames = 128
    engine = ParlerTTSEngine(*(x for pair in zip(trees, (t5_cfg, dec_cfg, dac_cfg)) for x in pair),
                             ParlerEngineConfig(max_frames=frames), encode_fn=encode_fn, device=dev)
    check(engine.dec_cfg.decode_attn == "kernel" and engine.dec_cfg.fuse_decode_qkv, "engine not on the kernel path")
    t5_calls = [0]
    encode = engine._encode

    def counting_encode(*a):
        t5_calls[0] += 1
        return encode(*a)

    engine._encode = counting_encode
    batcher = ContinuousBatcher(engine, max_batch=32, max_wait_ms=500.0).start()  # a window no host hiccup splits
    rows = [ParlerRow("A calm female speaker with clear diction in a quiet room.", "Hello there, this is the ported engine.", seed=11),
            ParlerRow("A fast male voice, slightly expressive, close microphone.", "नमस्ते, यह दूसरा अनुरोध है।", seed=12),
            ParlerRow("An old storyteller with a warm, slow delivery.", "ನಮಸ್ಕಾರ, ಇದು ಮೂರನೇ ವಿನಂತಿ.", seed=13)]

    def burst():
        t_req = time.perf_counter()
        futures = [batcher.submit(r) for r in rows]
        waves = [f.result(timeout=600)[0] for f in futures]
        return waves, time.perf_counter() - t_req

    want = 2 * layers * (frames + K - 1)
    (first, dt1) = counted("parler burst 1 (3 requests through ContinuousBatcher -> one bucket of 4)", burst, want)
    check(batcher.stats == {"batches": 1, "rows": 3, "max_batch_seen": 3}, f"requests did not co-batch: {batcher.stats}")
    for i, w in enumerate(first):
        log(f"  request {i}: {len(w)} samples = {len(w) // hop} frames x hop {hop} = {len(w) / dac_cfg.sampling_rate:.3f} s "
            f"at {dac_cfg.sampling_rate} Hz, peak {float(np.abs(w).max()) if len(w) else 0.0:.4f}")
        check(w.dtype == np.float32 and w.ndim == 1 and 0 < len(w) <= frames * hop and len(w) % hop == 0,
              f"request {i}: {len(w)} samples")
        check(bool(np.isfinite(w).all()) and float(np.abs(w).max()) > 0, f"request {i}: wave not finite/non-zero")
    hits, misses, calls = engine.desc_cache_hits, engine.desc_cache_misses, t5_calls[0]
    check(calls == 1 and misses == 4 and hits == 0, f"first burst: T5 calls {calls}, misses {misses}, hits {hits}")
    (second, dt2) = counted("parler burst 2 (same requests: description cache)", burst, want)
    same = max(float(np.abs(a - b).max()) if a.shape == b.shape else float("inf") for a, b in zip(first, second))
    log(f"bursts: {dt1:.3f} s cold, {dt2:.3f} s with cached descriptions; desc_cache_hits {engine.desc_cache_hits}, "
        f"misses {engine.desc_cache_misses}, T5 calls {t5_calls[0]}; max abs difference between the bursts' waves {same:.3e}")
    check(engine.desc_cache_hits == hits + 4 and engine.desc_cache_misses == misses and t5_calls[0] == calls,
          "second burst did not hit the description cache")
    check(same <= 1e-3, f"cached-description burst differs from the first: {same}")
    batcher.stop()

    # streaming: segments of one request equal the batch path's wave for the same seed
    desc, text = rows[0].description, rows[0].prompt
    engine._desc_cache.clear()  # both paths encode the description alone, so both decode from the same states
    full = counted("parler batch path, one row", lambda: engine.synthesize_batch(
        [desc], [text], row_seeds=[5], strict_lengths=True)[0], want)
    t_s = time.perf_counter()
    chunks = counted("parler streaming, one row", lambda: list(engine.synthesize_streaming(desc, text, seed=5)), None)
    stream = np.concatenate(chunks)
    check(stream.shape == full.shape and len(chunks) > 1, f"stream {stream.shape} in {len(chunks)} segments vs batch {full.shape}")
    diff = float(np.abs(stream - full).max())
    rel_rms = float(np.sqrt(np.mean((stream - full) ** 2)) / np.sqrt(np.mean(full**2)))
    log(f"streaming: {len(chunks)} segments of {[len(c) // hop for c in chunks]} frames in {time.perf_counter() - t_s:.3f} s, "
        f"{len(stream)} samples; max abs difference from the batch path {diff:.3e} (tol {PARLER_STREAM_TOL}), RMS of the "
        f"difference over the wave's RMS {rel_rms:.3e} (wave peak {float(np.abs(full).max()):.4f})")
    check(diff <= PARLER_STREAM_TOL, f"streamed wave differs from the batch path: {diff}")
    del engine, batcher
    torch.cuda.empty_cache()

    # the bench request: batch 16 x 430 frames, greedy, no EOS, bf16
    batch, frames = 16, 430
    engine = ParlerTTSEngine(*(x for pair in zip(trees, (t5_cfg, dec_cfg, dac_cfg)) for x in pair),
                             ParlerEngineConfig(max_frames=frames, desc_pad=64, prompt_pad=64, temperature=0.0,
                                                eos_token=-1), encode_fn=encode_fn, device=dev)
    descs = [f"A calm female speaker with clear diction, take {i}." for i in range(batch)]
    prompts = [f"This is utterance number {i} for the throughput benchmark." for i in range(batch)]
    want = 2 * layers * (frames + K - 1)

    def run():
        waves = engine.synthesize_batch(descs, prompts)
        check(len(waves) == batch and all(len(w) == frames * hop and np.isfinite(w).all() for w in waves),
              "bench waves not finite or of the wrong length")

    torch.cuda.reset_peak_memory_stats()
    counted("parler bench warm call", run, want)
    iters = []
    for i in range(3):
        t_it = time.perf_counter()
        counted(f"parler bench call {i + 1}", run, want)
        iters.append(time.perf_counter() - t_it)
    dt = statistics.median(iters)
    audio_s = batch * frames / (dac_cfg.sampling_rate / hop)
    log(f"parler bench on {card}: batch {batch} x {frames} frames, greedy, eos off, bf16, decode_attn=kernel, fused q|k|v: "
        f"iter_s {[round(t, 4) for t in iters]}, median {dt:.4f} s, {audio_s / dt:.2f} audio-s/s, "
        f"{batch * (frames + K - 1) / dt:.1f} decode steps/s ({(frames + K - 1) / dt:.1f} positions/s, "
        f"{1e3 * dt / (frames + K - 1):.3f} ms per position), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_by_family("one Parler bench call", lambda: counted("parler bench call under the profiler", run, want), (
        ("decode_attention", ("decode_attn",)), ("layer_norm", ("layer_norm",)),
        ("conv (DAC)", ("conv", "cudnn")), ("gather/copy", ("index", "gather", "copy", "cat", "Memcpy", "Memset"))),
        top=8, device_only=True, wall_plain_ms=dt * 1e3)
    launches["decode_attention"]["parler"] = total_launches[0]
    del engine
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels (and run the ablation), skip the engine, bench, int8, "
                         "training and Parler phases")
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

    from f5tts_tpu_torch.ops.kernels.ablate_attention import ablate_attention

    kernels = [attention_phase(dev), conv_phase(dev), *train_kernel_phase(dev), decode_attention_phase(dev),
               quant_matmul_phase(dev), ablate_attention_phase(dev)]
    launches = {k["name"]: {} for k in kernels}  # kernel -> path -> launches, each path's counts set to 0 before it
    launches["rope_rows"] = {}  # the serving attention's RoPE pre-pass, counted apart from its main kernel
    launches["ablate_attention"]["ablation"] = kernels[-1].pop("ablation_launches")
    if not args.kernels_only:
        from f5tts_tpu_torch.models.convert import init_dit_numpy, init_vocos_numpy
        from f5tts_tpu_torch.models.dit import DiTConfig
        from f5tts_tpu_torch.models.vocos import VocosConfig
        from f5tts_tpu_torch.text.tokenizer import Tokenizer

        tok = Tokenizer.from_file(os.path.join(HERE, "examples", "vocab.txt"))
        dit_cfg, voc_cfg = DiTConfig(text_num_embeds=tok.vocab_size), VocosConfig()  # F5-TTS Base + Vocos
        dit_np, voc_np = init_dit_numpy(dit_cfg, seed=0), init_vocos_numpy(voc_cfg, seed=1)
        engine_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, launches)
        bf16_bench = bench_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card)
        int8_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches, bf16_bench)
        del dit_np, voc_np
        train_phase(dev, dit_cfg, TRAIN_SHAPES, tok, card, launches)  # F5-TTS Base, dropout 0.1, kernels
        parler_phase(dev, card, launches)  # indic-parler-tts width and depth, random weights
        log(f"ablate_attention launches through the engine, int8, training and Parler phases: "
            f"{ablate_attention.launches} (want 0)")
        check(ablate_attention.launches == 0, "the ablation kernel ran on a serving or training path")
    for k in kernels:
        k["launches_by_path"] = launches[k["name"]]
        k["launches"] = sum(launches[k["name"]].values())
    kernels[0]["rope_rows_launches_by_path"] = launches["rope_rows"]
    kernels[0]["rope_rows_launches"] = sum(launches["rope_rows"].values())
    log(card_line())
    log(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "launches_by_path",
        *(key for key in ("int_mm_ms", "bf16_matmul_ms", "mma_sync_s8_top_s", "graph_ms", "variants_ms", "other_shapes",
                          "layouts_ms", "ablation_rows", "rope_rows_launches",
                          "rope_rows_launches_by_path") if key in k))}
        for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
