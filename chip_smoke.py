"""On-card smoke test of the PyTorch/CUDA port (``f5tts_tpu_torch``).

    python3 chip_smoke.py               # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --serving-only  # the build and phase 12 alone (no result lines)
    python3 chip_smoke.py --backbones-only  # the build, the F5 bench and phases 13-16 (no result lines)
    python3 chip_smoke.py --distill-only  # the build and phase 17 alone (no result lines)
    python3 chip_smoke.py --parallel-only  # the build and phase 18 alone (no result lines)
    python3 chip_smoke.py --ar-only  # the build and phase 19 alone (no result lines)
    python3 chip_smoke.py --leftovers-only  # the build, the F5 bench and phase 20 (no result lines)
    python3 chip_smoke.py --tools-only  # the build and phase 21 alone (no result lines)

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
   mel-frames/s, a profiler breakdown of one step; one step's gradients
   through the kernels (bf16) against the fp32 plain path on a small
   geometry; the sample hook fired once by ``Trainer.fit`` (NFE 16 in fp32
   from the EMA weights: exact launches, one ``.npy`` per prompt); two steps with
   ``optimizer="adafactor"`` (finite loss, the launches of a step, its
   optimizer state's bytes below half of AdamW's);
7. decode attention (with phase 2): the decode-step attention kernel at the
   shapes of one Parler decode position (16 heads of 64, bf16: batch 16
   against a 503-position self-attention cache with a causal bound in the
   middle and padded prompt keys, and against 64 encoder positions with a
   ragged mask and a fully masked row), grouped-query cases, batch 1 and 32,
   fp32, each against the fp32 plain version, with the split over a cluster
   that the wrapper picks for each shape; device time per call in a CUDA
   graph of 24 calls over cache sets that exceed the L2, beside the plain
   version, SDPA and the bound from the bytes of K and V;
8. Parler: ``ParlerTTSEngine`` at the width and depth of indic-parler-tts
   (flan-t5-large encoder, 24-layer decoder over 9 codebooks, 44.1 kHz DAC;
   random weights from seeds 0-2, bf16, a stand-in ``ord(c) % vocab``
   tokenizer): three requests through ``ContinuousBatcher`` that share one
   decode, the same burst again (description cache: the T5 must not run), one
   streamed request whose segments equal the batch path's wave, the decode
   step's CUDA graph against the eager step at b 1, b 4 and on a stream (its
   first audio too; times only), and the bench request (batch 16 x 430 frames, greedy, no EOS: audio-s/s and decode
   steps/s, median of 3 after a warm call). Every call's decode-attention
   launches must equal 2 x 24 x (frames + 8) and the F5 kernels' counts stay
   0; a profiler breakdown of one bench call with the busy/idle share; and at
   a small geometry the step logits of bf16 + kernel against fp32 + plain,
   teacher-forced;
9. quant_matmul (with phase 2): the fused quantize + int8 ``wgmma`` matmul
   at the shapes the int8 engine gives it at the bench geometry (16 x 1024
   rows of bf16 against the q/k/v/out, feed-forward in and feed-forward out
   weights of F5-TTS Base), a lone 1024-bucket request (M 2048), the smallest
   bucket (M 512), K 4096 and 5504 (the streamed path), a ragged fp32 shape,
   shapes that are no multiple of its tiles, each with and without the bias,
   a zero row and a row of 1e-7 under both floor conventions: every result
   bit-equal to the plain version, the fused bias bit-equal to the separate
   add; every plan the kernel is built for at the serving shapes and M 2048,
   checked and timed; device time per call in a CUDA graph over input sets
   larger than the L2 beside ``torch._int_mm`` on pre-quantized operands and
   the bf16 ``torch.matmul`` of the same shape (yardsticks only) and the
   bound; eager times beside the plain version and PyTorch's quantize +
   ``torch._int_mm`` + rescale; the rates of the ``mma.sync`` and ``wgmma``
   s8 instructions alone; then kernel 5's tensor-parallel modes (a given row
   abs-max, the raw int32 accumulators) on both paths at the row-parallel
   shapes of F5-TTS Base at TP 2 (M 4096, K 512 and 1024) and at M 16384,
   and its two companion kernels ``row_amax`` and ``rescale_rows``: all
   bit-equal to their plain versions, two K-halves summed and rescaled equal
   to the whole linear, device times in a CUDA graph beside the plain
   versions, ``torch.linalg.vector_norm(inf)`` (the abs-max's library call)
   and the bounds;
10. int8 engine (after phase 4): ``TTSEngine(EngineConfig(quantization="int8"))``
   at F5-TTS Base + Vocos: one request with exact launch counts (quant_matmul
   6 x 22, attention 22, its RoPE pre-pass 22, conv-pos 1 per DiT forward), one DiT forward and one
   whole solve against the bf16 engine from the same noise, a strict request
   (estimate, escalations), ``synthesize_batch`` of three chunks as one
   solve, ``synthesize_streaming`` against ``synthesize``'s wave, then the
   bench geometry at int8 beside the bf16 figure of the same run, with a
   profile whose library-GEMM launches must drop by exactly the 2640 that
   moved to quant_matmul, whose bf16 add launches (PyTorch's
   ``CUDAFunctor_add<c10::BFloat16>`` kernels, a family of their own in the
   profile) must drop by exactly the 2640 bias adds fused into it, and
   whose quant_matmul pre-pass runs once per feed-forward out linear (K
   2048, the streamed path);
11. attention-layout ablation (with phase 2): the kernel of the five layouts
   of ``scripts/ablate_attention.py`` at BH 256, N 1024, D 64, bf16, BQ 64 and
   128, zero bias and a -1e9 tail, against its fp32 plain version and the
   unpacked kernel; the four shapes it refuses; then the ablation itself
   (``f5tts_tpu_torch.scripts.ablate_attention.run``) at BQ 64 and 128: device
   time per call of each layout, its count of tensor-core products
   (m16n8k16 equivalents, the kernel's own),
   warps per SM, ``unpacked`` at the pair layouts' occupancy, the shipping
   kernel and SDPA on the same inputs. Its launches must stay 0 through
   phases 3-10 and 12;
12. serving (after phase 10): ``serve/service.py``'s ``ModelService`` loads
   F5-TTS Base + Vocos from ``.npz`` files written from the seeded weights,
   bf16, ``batcher="auto"`` (``StepBatcher``, segments of 2 Ralston
   intervals, the (1024, 8) group warmed), two voices (the demo clip and a
   synthetic one); requests go through a thread pool as the server's executor
   sends them: a lone request (its segments must chain), a burst of 8 ~8-s
   requests of the 1024 bucket (they must share groups) and a request
   submitted after the burst's first segment (it must join a running solve),
   a multi-chunk request with a speech edit that joins its group (edit and
   synthesis rows in one solve), a streamed request; every wave finite,
   non-zero and of the planned length. Launch counts (set to 0 after the
   load) must equal 22 attention + 22 RoPE pre-pass + 1 conv-pos per DiT
   forward, forwards counted from the batcher's segments (k x 2 each) and the
   window solves. One row through ``StepBatcher`` against the window solve
   from the same seed; host dispatch and device time of one (1024, 8)
   segment, with a profile; device memory after unload -> load back at its
   first level; the same burst on the window batcher at fetch pipelining
   depth 3 and 1: burst wall time, p50/max latency, the late request's
   latency;
13. E2-TTS (after phase 12): ``TTSEngine`` with ``forward_fn=unett_forward,
   embed_fn=unett_embed`` at E2-TTS Base width and depth (random weights from
   seed 0) + Vocos, bf16: three requests, one of which chunks, whose launch
   counts must equal 24 attention + 24 RoPE pre-pass + 1 conv-pos per UNetT
   forward; one row through ``StepBatcher`` (its segments reach the UNetT
   through the engine's hooks; exact counts, its wave against the window
   solve's); bf16 + kernels against fp32 + plain on a small input; the
   serving attention at the UNetT's shape (n = 1025: nothing is padded)
   against its plain version, timed beside SDPA; the bench geometry beside
   the F5 figure of the same run, with the share of attention, conv-pos and
   the rest of one solve's kernel time and the device's idle share;
14. MMDiT: one ``mmdit_forward`` at ``MMDiTConfig()`` (dim 1024, depth 22),
   bf16 with the conv-pos kernel, against fp32 + plain: exactly 1 conv-pos
   launch and no attention launch (its joint attention is the plain
   ``sdpa``, XLA in the JAX package); the conv-pos kernel with no mask
   against its plain version;
15. BigVGAN: ``TTSEngine(EngineConfig(vocoder_type="bigvgan"))`` at F5-TTS
   Base + ``BigVGANConfig()`` (full width) with the ``bigvgan`` mel flavor:
   one request of ``frames * 256`` samples; ``bigvgan_decode`` alone on a
   batch-8 x 1024-frame mel in bf16 and fp32 (times, relative L2, a profile);
16. torch checkpoints: seeded F5-TTS Base and Vocos written as ``.pt`` files
   in the reference's torch layout and as ``.npz`` trees; ``ModelService``
   and ``cli/infer.build_engine`` give the same wave from either, bit for
   bit;
17. distillation (after phase 6): ``train/distill.py:make_distill_step`` with
   the seeded F5-TTS Base as the teacher, bucket 1024, 128 cond frames,
   b 2, K 8, m 4, bf16: three steps whose launches by stage must be exact
   (rollout K and teacher solves 2Km serving forwards of 22 + 22 + 1; the
   student's gradient forward 44 + 44 training launches and one conv-pos
   launch through the masked differentiable route), the rows of every
   forward, a finite loss and gradient norm, every student leaf moved, the
   teacher bit-unchanged; wall time, device ms by stage (CUDA events), peak
   memory and a device-only profile with the idle share; one step with a
   single-branch teacher (b-row teacher forwards); the training kernels
   under that step's own key mask at its 16-row gradient shape, one row's
   keys all masked, against their fp32 plain versions; the student's
   gradient half through the kernels against the plain path on shared fp32
   states and targets at K 8 on the sway grid (fp32 and bf16; loss,
   gradients, updated params), on a small geometry; the
   distillation claim at ``tests/test_distill.py``'s micro geometry (40
   steps bring the student's K-step error to the fine guided solve below
   0.8x its error at init; head dim 16, so its attention is the plain
   version); the distilled student served by ``TTSEngine`` with
   ``student_sampler`` (exactly 8 x (22 + 22 + 1) launches, one solve); and
   ``scripts/distill_certify.run`` at a reduced tiny size (three rows of
   finite errors);
18. multi-device (``parallel/``, the engine's and the trainer's mesh; the
   card's machine has one H100 and NCCL refuses two ranks on one device):
   (a) the production backend, a one-rank NCCL group (store on localhost),
   mesh (1, 1): the Base engine's guided solve at the bench geometry is
   bit-equal to the mesh-free engine's from the same seeds, with exactly
   22 + 22 + 1 launches a forward; (b) tensor parallel 2 at full width as two
   processes on the one card over gloo (its ``all_reduce`` takes CUDA
   tensors through host memory): per forward model rank 0 launches
   22 + 22 + 1 at 8 heads and rank 1 22 + 0 + 1 (global head 0's RoPE lives
   on rank 0), the ranks' waves bit-equal, one fp32 Base forward against the
   mesh-free one (relative L2), the bf16 solve's mel against the mesh-free
   one; (c) in the same two processes, one fp32 Base train step at TP 2
   (AdamW, then Adafactor) and at DP 2 (AdamW) on a reduced 4 x 1024-frame
   batch, dropout on, the clip biting: loss, updated params and EMA against
   the mesh-free step, 44 + 44 training launches per step per rank; (d) the
   ring attention's per-shard body at p 4, n 4096 (b 2, 16 x 64, bf16) driven
   in one process over the rotated blocks, one row's last 1100 keys masked
   (a whole shard of them), against fp32 plain attention over the whole
   sequence, the 4 hops' device time beside the serving kernel's on the
   whole sequence; (e) in the two processes of (b), an int8 TP 2 solve at
   (b)'s geometry (the engine shards, then quantizes): the ranks' waves
   bit-equal, mel and wave bit-equal to the mesh-free int8 engine's from the
   same seeds, exact launches per forward per rank (22 x 6 quant_matmul,
   44 row_amax, 44 rescale_rows, 22 + 22/0 + 1 serving kernels); (f) the
   ring's backward at (d)'s shape in one process over the rotated blocks and
   a shared set of traveling dK/dV accumulators: dq, dk, dv against fp32
   autograd of plain attention over the whole sequence (relative L2), 4
   kernel-3a and 8 kernel-3b launches per rank, one rank's backward body in a
   CUDA graph beside kernel 3b over the whole sequence; (g) in the two
   processes, one fp32 ``MMDiTConfig()`` forward (2 x 1024 frames + 256 text
   tokens) at TP 2 against the mesh-free forward (relative L2), and one fp32
   MMDiT AdamW step at TP 2 on a reduced 2 x 1024-frame batch against the
   mesh-free step (loss, params, EMA), 2 conv-pos launches each (fp32: one
   a layer) and no attention kernel (the joint attention is plain).
19. the autoregressive leftovers (after the Parler phase, on its seeded
   full-width trees): (a) one ParlerTTSForConditionalGeneration-layout state
   dict written from those trees (the inverse key map
   ``parler_hf_state_dict``; the DAC in descript's positional layout with
   ``weight_g``/``weight_v`` pairs) to a temporary ``.pt``, read back by
   ``load_parler_checkpoint``: T5 and decoder trees bit-equal, the DAC within
   1e-6 relative; an engine on the loaded trees and one on the seeded trees
   each serve one greedy 3-row request (bf16): codes equal, exactly
   ``2 * layers * (frames + K - 1)`` decode-attention launches each, no other
   kernel, waves within a tolerance; (b) ``parler_loss`` and its backward at
   full decoder width (b 2, 256 positions with the delay pattern, 64
   encoder states) in fp32 and bf16 compute: bf16 loss near fp32's, every
   gradient finite, no kernel launched, step ms and peak memory; (c) the AR
   mel decoder at ``ARConfig()`` + ``VocosConfig()``: fp32 generation with
   the stop disabled against the teacher-forced pass over its frames, then
   ``ARTTSEngine.synthesize_batch`` at batch 8, ``text_pad`` 256, 1024
   frames, bf16 (lengths, audio-s/s over the median of 3 calls, ms and
   launches per position, a device-only profile); no kernel launched but
   the row norms (phase 22).
20. the module leftovers (after phase 19): (a) the fused q/k/v projection:
   kernel 1 on the head-split thirds of one ``(1024, 3072)`` product (bf16,
   16 x 1024 frames, row stride 3072) bit-equal to the call on contiguous
   copies; a bench-geometry solve from the fused tree against the unfused
   solve from the same noise (mel relative L2), then the bench beside the
   unfused bench of the same run: exactly 2 library GEMM launches fewer a
   block (880 a solve), kernels 1 and 2 and the pre-pass exactly as often,
   both audio-s/s; (b) the native audio library (built at first use from
   ``f5tts_tpu_torch/csrc/audioops.cpp``): the int16 encode bit-equal to the
   numpy form, the crossfade bit-equal outside its overlap (and in it for
   fades of up to 2 samples) and its overlap's difference from
   ``np.linspace`` printed, one ``synthesize_streaming`` request at Base
   whose chunk joins go through it (its call count); (c)
   ``python -m f5tts_tpu_torch.scripts.quality_harness --geometry base
   --dtype bf16 --prompts 4 --configs base,anchor64,ralston8,mid8,truth``
   in-process, its cache and output in a temporary directory: kernels 1 and
   2 exactly 22 + 22 + 1 per DiT forward, every row finite with its
   ``n_forwards``, the seconds it took.
21. the probe and profiling tools (after phase 20; ``f5tts_tpu_torch/scripts/``,
   each through the functions its ``main`` calls, every kernel's launches set
   to 0 before each and checked after): (a) ``e2e_real_ckpt`` at Base (a
   ~2.7-GB trainer-layout ``.pt`` in a temporary directory, the convert CLI
   as a subprocess, a bf16 engine at Euler NFE 4 and bucket 512, the fp32
   solve of the ``.npz`` tree equal to the in-memory EMA tree's within 1e-6
   relative and the online tree's off by more than 1e-4); (b)
   ``strict_live_probe`` over ``ModelService`` on a seeded Base tree written
   as ``.npz`` (the three rows; 22 + 22 + 1 launches per forward); (c)
   ``profile_sampler``'s six variants at b 8 x 1024, Ralston NFE 20, bf16,
   with exact launches per solve (0 attention kernels with attention knocked
   out or on the plain path, 0 conv-pos without conv-pos) and ``full``'s
   device ms by kernel family; (d) ``component_bench``; (e)
   ``parler_roofline`` at batch 16 (the JAX defaults 8, 16, 32 cut for time),
   one timed call each, 2 x 24 decode-attention launches a position; (f)
   ``parler_step_probe``'s six variants at b 16 and 16 positions, eager and
   in a CUDA graph, ``kernelattn`` launching 2 x 24 x 16 a run and ending
   within 5e-2 of ``unrolled``'s state.
22. row norms (with phase 2): kernel 7 (``csrc/row_norm.cu``) in its two
   modes at the serving forward's shapes, AdaLN's modulated layer norm of 16
   x 1024 rows of 1024 bf16 (scale and shift strided chunks of the (16, 6144)
   projection) and the UNetT's RMSNorm of 16 x 1025 rows, bf16 and fp32, and
   at odd row counts and other widths, against the fp32 plain version; device
   time per call in a CUDA graph over sets larger than the L2 beside the
   eager chain it replaces, ``F.layer_norm`` and ``F.rms_norm`` (yardsticks
   only) and the bound. The launch checks of the engine, int8, serving,
   E2-TTS (window and step batcher), BigVGAN, fused q/k/v bench and streaming
   paths, and every ``_launched`` check of phases 19-21, count it: 2 x depth
   + 1 launches a backbone forward under ``no_grad`` (45 in F5-TTS Base, 49
   in the UNetT Base), 4 x depth an MMDiT forward, 2 x depth + 1 a pass of
   the AR mel decoder (its prefill, each position, the teacher-forced pass),
   none where a gradient is carried.

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
ROW_NORM_REL = 2.0**-7  # row norms, bf16 kernel (one rounding) vs fp32 plain, max abs err over the peak |value|
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



def row_norm_phase(dev) -> dict:
    """Kernel 7, the row norms, at the serving forward's shapes: AdaLN's modulated layer norm of 16 x 1024 rows of
    1024 (F5-TTS Base, fused CFG at batch 8; scale and shift strided chunks of the (16, 6144) projection) and the
    UNetT's RMSNorm of 16 x 1025 rows; against the fp32 plain version, timed eager and in a CUDA graph over sets
    larger than the L2, beside the chain it replaces and ``F.layer_norm`` / ``F.rms_norm`` (yardsticks only)."""
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm, row_norm_plain

    b, n, c, sets = 16, 1024, 1024, 4  # 4 x (33.5 MB in + 33.5 MB out) > the 50 MB L2
    g = torch.Generator(device="cpu").manual_seed(7)
    xs = [torch.randn((b, n, c), generator=g).to(dev, torch.bfloat16) for _ in range(sets)]
    mods = [(torch.randn((b, 6 * c), generator=g) * 0.3).to(dev, torch.bfloat16) for _ in range(sets)]
    shift, scale = mods[0].chunk(6, dim=-1)[:2]
    xr = [torch.randn((b, n + 1, c), generator=g).to(dev, torch.bfloat16) for _ in range(sets)]
    gain = (1 + 0.3 * torch.randn((c,), generator=g)).to(dev, torch.bfloat16)

    def modulated(i=0):
        sh, sc = mods[i].chunk(6, dim=-1)[:2]
        return row_norm(xs[i], scale=sc, shift=sh, eps=1e-6)

    def rms(i=0):
        return row_norm(xr[i], g=gain, eps=1e-8)

    errs, rel = {}, {}  # max abs err; the same over the peak |value| of the plain version
    for name, out, ref in (
            ("modulated bf16", modulated(), row_norm_plain(xs[0].float(), scale=scale.float(), shift=shift.float(),
                                                           eps=1e-6)),
            ("rms bf16", rms(), row_norm_plain(xr[0].float(), g=gain.float(), eps=1e-8)),
            ("modulated fp32", row_norm(xs[0].float(), scale=scale.float(), shift=shift.float(), eps=1e-6),
             row_norm_plain(xs[0].float(), scale=scale.float(), shift=shift.float(), eps=1e-6)),
            ("rms fp32", row_norm(xr[0].float(), g=gain, eps=1e-8), row_norm_plain(xr[0].float(), g=gain, eps=1e-8))):
        torch.cuda.synchronize()
        errs[name] = float((out.float() - ref).abs().max())
        rel[name] = errs[name] / float(ref.abs().max())
    for nn_, cc in ((7, 1024), (333, 512), (1, 768)):  # odd row counts and other widths, 3 x nn_ rows
        xo = xs[0][:3, :nn_, :cc].contiguous()
        mo = mods[0][:3, : 2 * cc]
        before = row_norm.launches
        out = row_norm(xo, scale=mo[:, cc:], shift=mo[:, :cc], eps=1e-6)
        check(row_norm.launches == before + 1, "the row norm did not run as one launch")
        ref = row_norm_plain(xo.float(), scale=mo[:, cc:].float(), shift=mo[:, :cc].float(), eps=1e-6)
        key = f"modulated bf16 3 x {nn_} x {cc}"
        errs[key] = float((out.float() - ref).abs().max())
        rel[key] = errs[key] / float(ref.abs().max())
    log("row_norm: kernel vs fp32 plain, max abs err (over the peak |value|): "
        + ", ".join(f"{k} {errs[k]:.3e} ({rel[k]:.3e})" for k in errs)
        + f" (tol over the peak {ROW_NORM_REL:.3e} bf16, 1e-5 fp32)")
    check(all(np.isfinite(v) and v <= (1e-5 if "fp32" in k else ROW_NORM_REL) for k, v in rel.items()),
          f"row_norm errors over the peak {rel}")

    def chain():  # what the modulated call sites ran before the kernel
        return m.layer_norm(xs[0]) * (1 + scale[:, None]) + shift[:, None]

    def rms_chain():
        x32 = xr[0].float()
        y = x32 * torch.rsqrt(torch.clamp_min((x32 * x32).sum(-1, keepdim=True), 1e-8)) * (c ** 0.5)
        return (y * gain.float()).to(xr[0].dtype)

    def library():
        return F.layer_norm(xs[0], (c,), eps=1e-6)

    def rms_library():
        return F.rms_norm(xr[0], (c,), gain, 1e-8)

    ms = {"kernel": time_ms(modulated), "plain": time_ms(chain), "library": time_ms(library),
          "rms_kernel": time_ms(rms), "rms_plain": time_ms(rms_chain), "rms_library": time_ms(rms_library)}
    graph = {"kernel": time_graph_ms([lambda i=i: modulated(i) for i in range(sets)] * 5),
             "plain": time_graph_ms([chain] * 5), "library": time_graph_ms([library] * 5),
             "rms_kernel": time_graph_ms([lambda i=i: rms(i) for i in range(sets)] * 5),
             "rms_plain": time_graph_ms([rms_chain] * 5), "rms_library": time_graph_ms([rms_library] * 5)}
    bms, by = bound_ms(10.0 * b * n * c, 2 * b * n * c * 2 + 2 * b * c * 2, PEAK_BF16_FLOPS)
    rms_bms, _ = bound_ms(6.0 * b * (n + 1) * c, 2 * b * (n + 1) * c * 2 + c * 2, PEAK_BF16_FLOPS)
    log(f"row_norm times (ms; eager with host time / device time per call in a CUDA graph): modulated "
        f"(16 x 1024 x 1024 bf16) kernel {ms['kernel']:.4f} / {graph['kernel']:.4f}, the chain it replaces "
        f"{ms['plain']:.4f} / {graph['plain']:.4f}, F.layer_norm alone (yardstick) {ms['library']:.4f} / "
        f"{graph['library']:.4f}, bound {bms:.4f} ({by}; {100 * bms / graph['kernel']:.1f}% of it); RMS "
        f"(16 x 1025 x 1024) kernel {ms['rms_kernel']:.4f} / {graph['rms_kernel']:.4f}, chain {ms['rms_plain']:.4f} / "
        f"{graph['rms_plain']:.4f}, F.rms_norm (yardstick) {ms['rms_library']:.4f} / {graph['rms_library']:.4f}, "
        f"bound {rms_bms:.4f} ({100 * rms_bms / graph['rms_kernel']:.1f}% of it)")
    return {"name": "row_norm", "route": "cuda", "source": "f5tts_tpu_torch/csrc/row_norm.cu",
            "replaces": "none: XLA fused f5tts_tpu/models/modules.py:layer_norm + the AdaLN modulation, rms_norm",
            "max_abs_err": max(errs.values()), "max_rel_peak_err": max(rel.values()), "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bms,
            "bound_by": by, "library_ms": ms["library"], "graph_ms": graph,
            "other_shapes": {"rms_16x1025x1024": {k: v for k, v in ms.items() if k.startswith("rms")}
                             | {"bound_ms": rms_bms}}}


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
    from f5tts_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_plain, decode_split

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def split_of(b, h, n_kv, total):
        split, span = decode_split(b, n_kv, h // n_kv, total, sms)
        return (f"split {split} ({'one block, no cluster exchange' if split == 1 else f'a cluster of {split} blocks'}), "
                f"{span} positions a block")

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
        log(f"decode_attention {name}: {dtype} b={b} h={h} n_kv={n_kv} total={total} d={d} {opts}, "
            f"{split_of(b, h, n_kv, total)}: max abs err vs fp32 plain {e:.3e} (tol {tol})")
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
        log(f"decode_attention times, {name} (b {b}, h 16, total {total}, d 64, bf16, {split_of(b, h, n_kv, total)}; "
            f"device time per call in a CUDA graph of 24 calls over {len(sets)} cache sets in turn): kernel "
            f"{ms_kernel:.5f} ms (one set repeated: "
            f"{ms_warm:.5f}), plain {ms_plain:.5f} ms, library (SDPA, bias as attn_mask; its max abs err vs fp32 "
            f"plain {lib_err:.3e}) {ms_lib:.5f} ms, bound {bms:.5f} ms ({by}) = {100 * bms / ms_kernel:.1f}% of the "
            f"kernel's time; one eager call with its host launch: {ms_eager:.4f} ms")
        rows[name] = {"ms": ms_kernel, "warm_ms": ms_warm, "plain_ms": ms_plain, "library_ms": ms_lib,
                      "bound_ms": bms, "bound_by": by, "eager_call_ms": ms_eager,
                      "split": decode_split(b, n_kv, h // n_kv, total, sms)[0]}
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


def _quant_sets(dev, m, k, n, seed, at_least_bytes=120e6, most=32):
    """Input sets (x, w_q, s_w, w_qt, b) for timing, enough that a graph that
    walks them reads more than the 50 MB L2 between two visits of one set."""
    from f5tts_tpu_torch.ops.kernels.quant_matmul import kernel_layout

    per_set = m * k * 2 + k * n * 2 + m * n * 2
    sets = []
    for i in range(min(most, max(3, int(-(-at_least_bytes // per_set))))):
        x, w_q, s_w = _quant_inputs(dev, torch.bfloat16, m, k, n, seed + i)
        b = torch.randn((n,), generator=torch.Generator().manual_seed(seed + i)).to(dev, torch.bfloat16)
        sets.append((x, w_q, s_w, kernel_layout(w_q), b))
    return sets


def quant_matmul_phase(dev) -> dict:
    """The fused W8A8 matmul at the shapes the int8 engine gives it at the
    bench geometry (16 x 1024 rows; q/k/v/out, ff in, ff out of F5-TTS Base),
    at a lone 1024-bucket request (M 2048) and the smallest bucket (M 512),
    past the fused path's K (4096, 5504: the streamed path), with and
    without the bias, held bit-equal to its plain version: the integer
    product is exact and every fp32 step is one correctly rounded operation in
    a fixed order. Then every plan the kernel is built for at those shapes,
    device time per call in a CUDA graph over input sets larger than the L2,
    beside ``torch._int_mm`` on pre-quantized operands and the bf16
    ``torch.matmul`` (yardsticks only), and the rates of the two int8
    tensor-core instructions alone."""
    from f5tts_tpu_torch.ops.kernels.quant_matmul import (fits, kernel_layout, kernel_smem_bytes, launch_plan,
                                                          make_plan, mma_rate_probe, plan, quant_matmul,
                                                          quant_matmul_plain, smem_bytes, wgmma_rate_probe)

    bf, f32 = torch.bfloat16, torch.float32
    kernel_floor, linear_floor = dict(amax_floor=1e-6, scale_floor=0.0), dict(amax_floor=0.0, scale_floor=1e-8)
    for streamed in (False, True):
        for k in (80, 1024, 1152, 1168, 2048, 5504):
            want = smem_bytes(streamed, k) if fits(streamed, k) else 0
            check(kernel_smem_bytes(streamed, k) == want,
                  f"quant_matmul shared memory: the kernel and the plan disagree at {streamed, k}")

    def differing(x, w_q, s_w, b=None, **floors):
        out = quant_matmul(x, w_q, s_w, w_qt=kernel_layout(w_q), b=b, **floors)
        torch.cuda.synchronize()
        ref = quant_matmul_plain(x, w_q, s_w, b=b, **floors)
        check(out.shape == ref.shape and out.dtype == x.dtype, "quant_matmul output shape/dtype")
        check(bool(torch.isfinite(out.float()).all()), "quant_matmul output not finite")
        return int((out != ref).sum()), float((out.float() - ref.float()).abs().max())

    cases = (  # name, dtype, M, K, N, floors
        ("q/k/v/out", bf, 16384, 1024, 1024, linear_floor), ("ff in", bf, 16384, 1024, 2048, linear_floor),
        ("ff out", bf, 16384, 2048, 1024, linear_floor), ("ragged fp32", f32, 1000, 1024, 2048, kernel_floor),
        ("K, N not multiples of the tile", bf, 77, 80, 48, kernel_floor),
        ("fp32, K 4096 (streamed)", f32, 300, 4096, 64, linear_floor),
        ("M 2048 (a lone 1024-bucket request)", bf, 2048, 1024, 1024, linear_floor),
        ("M 512 (the smallest bucket)", bf, 512, 1024, 2048, linear_floor),
        ("K 4096 (streamed)", bf, 4096, 4096, 1024, linear_floor),
        ("K 5504, ragged M, N 208 (streamed)", f32, 1001, 5504, 208, kernel_floor))
    worst = 0.0
    for i, (name, dtype, m, k, n, floors) in enumerate(cases):
        x, w_q, s_w = _quant_inputs(dev, dtype, m, k, n, 300 + i)
        b = torch.randn((n,), generator=torch.Generator().manual_seed(400 + i)).to(dev, dtype)
        p = plan(m, k, n)
        for bias in (None, b):
            bad, err = differing(x, w_q, s_w, bias, **floors)
            worst = max(worst, err)
            log(f"quant_matmul {name}: {dtype} ({m}, {k}) x ({k}, {n}), floors {floors}, "
                f"{'with' if bias is not None else 'no'} bias, plan {'streamed' if p.streamed else 'fused'} "
                f"split {p.split} ({p.blocks} blocks): {bad} of {m * n} elements differ from the plain "
                f"version, max abs difference {err:.3e} (must be bit-equal)")
            check(bad == 0, f"quant_matmul {name}: {bad} elements differ from the plain version")
        w_qt = kernel_layout(w_q)
        fused = quant_matmul(x, w_q, s_w, w_qt=w_qt, b=b, **floors)
        check(torch.equal(fused, quant_matmul(x, w_q, s_w, w_qt=w_qt, **floors) + b),
              f"quant_matmul {name}: the fused bias differs from the separate add")
        del x, w_q, s_w, w_qt, b, fused
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
    torch.cuda.empty_cache()

    # the rates of the int8 tensor-core instructions alone (no memory traffic): mma.sync m16n8k32
    # (register operands; 8 and 32 warps per SM) and the wgmma m64n128k32 the kernel issues
    # (shared-memory operands; 3 warpgroups per SM)
    mma_rate = {}
    for warps_per_sm in (8, 32):
        blocks, iters = 132 * warps_per_sm // 8, 4096
        ms = time_ms(lambda: mma_rate_probe(blocks, iters, dev), iters=5, warmup=1)
        mma_rate[warps_per_sm] = blocks * 8 * 8 * iters * (16 * 8 * 32 * 2) / ms / 1e9
        log(f"mma.sync m16n8k32 s8 rate, {warps_per_sm} warps per SM, 8 independent accumulators per warp: "
            f"{mma_rate[warps_per_sm]:.1f} TOP/s ({100 * mma_rate[warps_per_sm] * 1e12 / PEAK_INT8_OPS:.1f}% of the "
            f"card's dense int8 peak)")
    blocks, iters = 132, 2048
    ms = time_ms(lambda: wgmma_rate_probe(blocks, iters, dev), iters=5, warmup=1)
    wgmma_rate = blocks * 3 * 8 * iters * (64 * 128 * 32 * 2) / ms / 1e9
    log(f"wgmma m64n128k32 s8 rate, 3 warpgroups per SM, shared-memory operands: {wgmma_rate:.1f} TOP/s "
        f"({100 * wgmma_rate * 1e12 / PEAK_INT8_OPS:.1f}% of the card's dense int8 peak)")

    log(f"time_ms of an empty call (what the event pair itself reads): {time_ms(lambda: None):.4f} ms")
    rows = {}
    for name, m, k, n in (("qkvo", 16384, 1024, 1024), ("ff_in", 16384, 1024, 2048), ("ff_out", 16384, 2048, 1024),
                          ("qkvo_m2048", 2048, 1024, 1024)):
        sets = _quant_sets(dev, m, k, n, 320)
        reps = max(1, -(-24 // len(sets)))
        x, w_q, s_w, w_qt, b = sets[0]
        chosen = plan(m, k, n)
        launches_before = quant_matmul.launches
        ms_eager = time_ms(lambda: quant_matmul(x, w_q, s_w, w_qt=w_qt, b=b, **linear_floor))
        check(quant_matmul.launches == launches_before + 23, "quant_matmul did not count its launches")
        graph = {"kernel": time_graph_ms([lambda s_=s_: quant_matmul(s_[0], s_[1], s_[2], w_qt=s_[3], b=s_[4],
                                                                     **linear_floor) for s_ in sets] * reps)}
        variants = {}
        for streamed in (False, True):
            if not fits(streamed, k):
                continue
            split = chosen.split if streamed == chosen.streamed else max(1, 132 // -(-m // 128))
            p = make_plan(m, k, n, streamed, split)
            key = f"{'streamed' if streamed else 'fused'} split {p.split}"
            out = launch_plan(x, w_qt, s_w, b, p, **linear_floor)
            torch.cuda.synchronize()
            check(torch.equal(out, quant_matmul_plain(x, w_q, s_w, b=b, **linear_floor)),
                  f"quant_matmul {name} plan {key} differs from the plain version")
            variants[key] = time_graph_ms([lambda s_=s_, p=p: launch_plan(s_[0], s_[3], s_[2], s_[4], p,
                                                                         **linear_floor) for s_ in sets] * reps)
        ms_plain = time_ms(lambda: quant_matmul_plain(x, w_q, s_w, b=b, **linear_floor), iters=5, warmup=1)
        w_bfs = [(s_[1].float() * s_[2]).to(bf) for s_ in sets]
        graph["bf16_matmul"] = time_graph_ms([lambda s_=s_, w_=w_: s_[0] @ w_ for s_, w_ in zip(sets, w_bfs)] * reps)
        ms_bf16 = time_ms(lambda: x @ w_bfs[0])

        def library(x_, w_q_, s_w_, b_):  # PyTorch's quantize ops, one library int8 GEMM (weights column-major, the
            # layout cuBLASLt's int8 kernels take), PyTorch's rescale + bias
            sx_ = (x_.float().abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
            xq_ = torch.round(x_.float() / sx_).to(torch.int8)
            return ((torch._int_mm(xq_, w_q_).float() * sx_) * s_w_).to(bf) + b_

        try:
            lib_err = float((library(x, w_qt.t(), s_w, b).float()
                             - quant_matmul_plain(x, w_q, s_w, b=b, **linear_floor).float()).abs().max())
            ms_lib = time_ms(lambda: library(x, w_qt.t(), s_w, b))
            xqs = [torch.round(s_[0].float() / (s_[0].float().abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8))
                   .to(torch.int8) for s_ in sets]
            graph["int_mm"] = time_graph_ms([lambda xq_=xq_, s_=s_: torch._int_mm(xq_, s_[3].t())
                                             for xq_, s_ in zip(xqs, sets)] * reps)
            del xqs
        except (RuntimeError, AttributeError) as e:  # the yardstick only: this build has no int8 GEMM call
            log(f"quant_matmul {name}: torch._int_mm is not available here ({type(e).__name__}: {e})")
            lib_err = ms_lib = None
            graph["int_mm"] = None
        nbytes = m * k * 2 + k * n + n * 4 + n * 2 + m * n * 2  # x, w_q, s_w, b, out
        bms, by = bound_ms(2.0 * m * k * n, nbytes, PEAK_INT8_OPS)
        log(f"quant_matmul times, {name} ({m}, {k}) x ({k}, {n}) bf16 with bias, {len(sets)} input sets: plan "
            f"{'streamed' if chosen.streamed else 'fused'} split {chosen.split} ({chosen.blocks} blocks); graph: kernel {graph['kernel']:.4f} ms "
            f"({2.0 * m * k * n / graph['kernel'] / 1e9:.1f} TOP/s), torch._int_mm on pre-quantized operands "
            f"{graph['int_mm']} ms, bf16 torch.matmul {graph['bf16_matmul']:.4f} ms; bound {bms:.4f} ms ({by}) = "
            f"{100 * bms / graph['kernel']:.1f}% of the kernel's time; eager: kernel {ms_eager:.4f} ms, plain "
            f"{ms_plain:.4f} ms, library (PyTorch quantize + torch._int_mm + rescale + bias; its max abs difference "
            f"from the plain version {lib_err}) {ms_lib} ms, bf16 torch.matmul {ms_bf16:.4f} ms")
        for key, ms_v in variants.items():
            log(f"  quant_matmul {name} plan {key}: graph {ms_v:.4f} ms ({100 * bms / ms_v:.1f}% of the bound)")
        rows[name] = {"ms": graph["kernel"], "eager_ms": ms_eager, "plain_ms": ms_plain, "library_ms": ms_lib,
                      "int_mm_ms": graph["int_mm"], "bf16_matmul_ms": graph["bf16_matmul"], "bound_ms": bms,
                      "bound_by": by, "variants_ms": variants}
        del sets, x, w_q, s_w, w_qt, b, w_bfs
        torch.cuda.empty_cache()
    return {"name": "quant_matmul", "route": "cuda", "source": "f5tts_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "f5tts_tpu/ops/pallas/quant_matmul.py:36", "max_abs_err": worst, **rows["qkvo"],
            "mma_sync_s8_top_s": mma_rate, "wgmma_s8_top_s": wgmma_rate,
            "other_shapes": {k: v for k, v in rows.items() if k != "qkvo"}}


QUANT_TP_SHAPES = (("to_out", 4096, 512, 1024), ("ff_out", 4096, 1024, 1024))  # F5-TTS Base at TP 2, 2 x 1024 rows


def quant_tp_phase(dev) -> tuple[dict, list[dict]]:
    """Kernel 5 on the tensor-parallel serving path, at the row-parallel
    linears' shapes of F5-TTS Base at TP 2 (``to_out`` K 512, ``ff.out`` K
    1024; M 4096 = the 2 x 1024-row solve of phase 18 with CFG): the given
    row abs-max and the raw int32 output on both paths (the plan takes the
    streamed one at M 4096; the fused one forced) and at M 16384 on the fused
    path, and the two companion kernels (``row_amax``, ``rescale_rows``), every
    result bit-equal to its plain version; the K-shards' summed accumulators
    rescaled equal the whole linear. Device time per call in a CUDA graph over
    input sets larger than the L2, beside the plain versions, one PyTorch
    call of the same function where there is one, and the bound. Returns the
    raw mode's times (for kernel 5's line) and the companions' lines."""
    from f5tts_tpu_torch.ops.kernels.quant_matmul import (kernel_layout, launch_plan, make_plan, plan, quant_matmul,
                                                          quant_matmul_plain, rescale_rows, rescale_rows_plain,
                                                          row_amax, row_amax_plain)

    floors = dict(amax_floor=0.0, scale_floor=1e-8)
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        for name, m, k, n in (*QUANT_TP_SHAPES, ("to_out, M 16384", 16384, 512, 1024)):
            x, w_q, s_w = _quant_inputs(dev, dtype, m, k, n, 330)
            w_qt = kernel_layout(w_q)
            amax = row_amax(x)
            check(torch.equal(amax, row_amax_plain(x)), f"row_amax {name} {dtype} differs from its plain version")
            big = amax * 1.25  # a K-shard's view: the whole row's abs-max is larger than its own
            for streamed in (False, True):
                p = make_plan(m, k, n, streamed, plan(m, k, n).split if streamed else 1)
                raw = launch_plan(x, w_qt, s_w, None, p, **floors, amax=big, raw=True)
                torch.cuda.synchronize()
                check(torch.equal(raw, quant_matmul_plain(x, w_q, s_w, amax=big, raw=True, **floors)),
                      f"quant_matmul raw {name} {dtype} {'streamed' if streamed else 'fused'} differs from plain")
            halves = [quant_matmul(x[:, i:i + k // 2].contiguous(), w_q[i:i + k // 2].contiguous(), s_w,
                                   w_qt=kernel_layout(w_q[i:i + k // 2]), amax=amax, raw=True, **floors)
                      for i in (0, k // 2)]
            b = torch.randn((n,), generator=torch.Generator().manual_seed(331)).to(dev, dtype)
            y = rescale_rows(halves[0] + halves[1], amax, s_w, b=b, dtype=dtype, **floors)
            torch.cuda.synchronize()
            check(torch.equal(y, rescale_rows_plain(halves[0] + halves[1], amax, s_w, b=b, dtype=dtype, **floors)),
                  f"rescale_rows {name} {dtype} differs from its plain version")
            check(torch.equal(y, quant_matmul(x, w_q, s_w, w_qt=w_qt, b=b, **floors)),
                  f"{name} {dtype}: two K-halves summed and rescaled differ from the whole linear")
            del x, w_q, s_w, w_qt, amax, big, raw, halves, b, y
    log(f"quant_matmul given abs-max + raw int32 (both paths), row_amax, rescale_rows at {QUANT_TP_SHAPES} and M "
        f"16384, bf16 and fp32: all bit-equal to their plain versions; two K-halves summed and rescaled equal the "
        f"whole linear ({time.perf_counter() - t0:.1f} s)")

    tp_modes, lines = {}, {"row_amax": {}, "rescale_rows": {}}
    for name, m, k, n in QUANT_TP_SHAPES:
        sets = _quant_sets(dev, m, k, n, 340)
        reps = max(1, -(-24 // len(sets)))
        amaxes = [row_amax(s_[0]) for s_ in sets]
        accs = [quant_matmul(s_[0], s_[1], s_[2], w_qt=s_[3], amax=a_, raw=True, **floors)
                for s_, a_ in zip(sets, amaxes)]
        raw_ms = time_graph_ms([lambda s_=s_, a_=a_: quant_matmul(s_[0], s_[1], s_[2], w_qt=s_[3], amax=a_, raw=True,
                                                                  **floors) for s_, a_ in zip(sets, amaxes)] * reps)
        whole_ms = time_graph_ms([lambda s_=s_: quant_matmul(s_[0], s_[1], s_[2], w_qt=s_[3], b=s_[4], **floors)
                                  for s_ in sets] * reps)
        bytes_raw = m * k * 2 + k * n + m * 4 + m * n * 4
        bms_raw, by_raw = bound_ms(2.0 * m * k * n, bytes_raw, PEAK_INT8_OPS)
        tp_modes[name] = {"raw_ms": raw_ms, "scaled_ms": whole_ms, "bound_ms": bms_raw, "bound_by": by_raw,
                          "plan": "streamed" if plan(m, k, n).streamed else "fused"}
        log(f"quant_matmul TP 2 {name} ({m}, {k}) x ({k}, {n}) bf16, plan {tp_modes[name]['plan']}: graph, given "
            f"abs-max + raw int32 out {raw_ms:.4f} ms against the rescaled bf16 out with bias {whole_ms:.4f} ms; bound "
            f"{bms_raw:.4f} ms ({by_raw})")
        x0 = sets[0][0]
        ms = time_graph_ms([lambda s_=s_: row_amax(s_[0]) for s_ in sets] * reps)
        lib = time_graph_ms([lambda s_=s_: torch.linalg.vector_norm(s_[0], float("inf"), dim=-1, dtype=torch.float32)
                             for s_ in sets] * reps)
        bms, by = bound_ms(m * k, m * k * 2 + m * 4, PEAK_BF16_FLOPS)
        lines["row_amax"][name] = {"ms": ms, "plain_ms": time_ms(lambda: row_amax_plain(x0)), "library_ms": lib,
                                   "bound_ms": bms, "bound_by": by}
        a0, acc0, s0 = amaxes[0], accs[0], sets[0]
        ms = time_graph_ms([lambda s_=s_, a_=a_, c_=c_: rescale_rows(c_, a_, s_[2], b=s_[4], dtype=torch.bfloat16,
                                                                     **floors)
                            for s_, a_, c_ in zip(sets, amaxes, accs)] * reps)
        bms, by = bound_ms(3 * m * n, m * n * 4 + m * 4 + n * 4 + n * 2 + m * n * 2, PEAK_BF16_FLOPS)
        lines["rescale_rows"][name] = {"ms": ms, "plain_ms": time_ms(lambda: rescale_rows_plain(
            acc0, a0, s0[2], b=s0[4], dtype=torch.bfloat16, **floors)), "library_ms": None, "bound_ms": bms,
            "bound_by": by}
        for kname in ("row_amax", "rescale_rows"):
            r = lines[kname][name]
            lib_txt = "none (no one PyTorch call)" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"{kname} TP 2 {name} (M {m}, {'K ' + str(k) if kname == 'row_amax' else 'N ' + str(n)}, bf16): graph "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (eager), library {lib_txt}, bound {r['bound_ms']:.4f} "
                f"ms ({r['bound_by']}) = {100 * r['bound_ms'] / r['ms']:.1f}% of the kernel's time")
        del sets, amaxes, accs
        torch.cuda.empty_cache()
    first = QUANT_TP_SHAPES[1][0]  # ff.out, the larger of the two: the line's numbers; the other under other_shapes
    out = []
    for kname, line, src in (("row_amax", "f5tts_tpu/ops/pallas/quant_matmul.py:25", "row_amax_kernel"),
                             ("rescale_rows", "f5tts_tpu/ops/pallas/quant_matmul.py:31", "rescale_rows_kernel")):
        out.append({"name": kname, "route": "cuda", "source": "f5tts_tpu_torch/csrc/quant_matmul.cu", "replaces": line,
                    "max_abs_err": 0.0, **lines[kname][first], "kernel": src,
                    "other_shapes": {k_: v_ for k_, v_ in lines[kname].items() if k_ != first}})
    return tp_modes, out


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
                f", {r['mma']} tensor-core products (m16n8k16 equivalents) per call "
                f"({r['mma'] / by_name['unpacked']['mma']:.2f}x unpacked), "
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
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm
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
    wrappers = {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos, "row_norm": row_norm}
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
    # per forward: each block's attention kernel and its RoPE pre-pass; the conv-pos pair is one launch; two row
    # norms a block and the final one
    want = {"flash_attention": n_blocks * n_forwards, "rope_rows": n_blocks * n_forwards, "conv_pos": n_forwards,
            "row_norm": (2 * n_blocks + 1) * n_forwards}
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
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm
    from f5tts_tpu_torch.ops.kernels.quant_matmul import quant_matmul

    wrappers = {"quant_matmul": quant_matmul, "flash_attention": flash_attention, "rope_rows": rope_rows,
                "conv_pos": conv_pos, "row_norm": row_norm}
    # per DiT forward: every block's six linears, its attention kernel and that kernel's RoPE pre-pass; one conv pair;
    # two row norms a block (bf16 activations, as in the bf16 engine) and the final one
    per_forward = {"quant_matmul": QUANTIZED_LINEARS * dit_cfg.depth, "flash_attention": dit_cfg.depth,
                   "rope_rows": dit_cfg.depth, "conv_pos": 1, "row_norm": 2 * dit_cfg.depth + 1}
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
    # the bias of those linears is added inside quant_matmul: the bf16 path's separate adds are gone; the
    # feed-forward out linear (K 2048) takes the streamed path, whose pre-pass is a launch of its own
    # (counted by the bf16 add kernel itself: the profile's count of small elementwise launches, aranges,
    # compares, copies, varies by a few from run to run)
    add_bf16, add_int8 = (bench["launch_counts"].get("bf16_add", 0) for bench in (bf16_bench, int8_bench))
    prepass, want_prepass = int8_bench["launch_counts"].get("quant_prepass", 0), dit_cfg.depth * 20
    log(f"bf16 add launches per solve (bias and residual adds): int8 {add_int8} against bf16 {add_bf16}: "
        f"{add_bf16 - add_int8} fewer (want exactly the {moved} bias adds of the six block linears, fused into "
        f"quant_matmul); quant_matmul pre-pass launches {prepass} (want {want_prepass}: feed-forward out, K 2048, "
        f"takes the streamed path)")
    check(add_bf16 - add_int8 == moved and prepass == want_prepass,
          "the int8 solve's bf16 add launches did not drop by exactly the fused bias adds, or the pre-pass count is off")


SERVING_SEGMENT_INTERVALS = 2  # ODE intervals per step-batcher segment (the serving default)
SERVING_MEM_TOL = 0.05  # device memory after unload -> load, relative to the first load


def _serving_texts(engine, ref, ref_text: str):
    """A text of about 8 s for ``ref`` whose single row lands in the
    1024-frame bucket, and a longer one that chunks into 2-3 rows of it."""
    words = ("the quick brown fox jumps over a lazy dog while the river runs past the old mill and "
             "children sing in the square as the evening light falls on the hills").split()

    def rows_of(text):
        return engine.prepare_request(text, ref, 24000, ref_text).rows

    text = ""
    for w in words * 4:
        longer = (text + " " + w).strip()
        rows = rows_of(longer + ".")
        if len(rows) > 1 or rows[0].duration > 960:  # room for the other voice's speech rate
            break
        text = longer
    one = text + "."
    many = " ".join([one.rstrip(".") + ","] * 2 + [one])
    for _ in range(3):
        if len(rows_of(many)) in (2, 3):
            break
        many = many.rsplit(",", 1)[0] + "."
    return one, many


def serving_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, launches: dict) -> None:
    """``serve/service.py``'s ``ModelService`` at F5-TTS Base + Vocos from
    ``.npz`` checkpoints, on ``StepBatcher`` (batcher auto, segments of 2
    intervals), driven through a thread pool as the server's executor
    drives it; then the same burst on the window batcher."""
    import shutil
    import tempfile

    from f5tts_tpu_torch.audio.io import write_wav
    from f5tts_tpu_torch.models.convert import save_params_npz
    from f5tts_tpu_torch.serve.service import ModelService
    from f5tts_tpu_torch.utils.config import Settings

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="f5_serving_")
    try:
        save_params_npz(os.path.join(tmp, "f5_base.npz"), dit_np)
        save_params_npz(os.path.join(tmp, "vocos.npz"), voc_np)
        voices = os.path.join(tmp, "voices")
        os.makedirs(voices)
        shutil.copy(os.path.join(HERE, "examples", "voices", "demo_voice.wav"), voices)
        with open(os.path.join(voices, "demo_voice.txt"), "w", encoding="utf-8") as f:
            f.write("A short reference clip of the demo voice.")
        write_wav(os.path.join(voices, "narrator.wav"), synthetic_ref(2.5, 130.0, 21))
        with open(os.path.join(voices, "narrator.txt"), "w", encoding="utf-8") as f:
            f.write("The narrator reads this sentence calmly.")
        settings = Settings(device="cuda", dtype="bfloat16", batcher="auto",
                            batcher_segment_intervals=SERVING_SEGMENT_INTERVALS, warmup_buckets="1024",
                            warmup_batches="8", tts_ckpt=os.path.join(tmp, "f5_base.npz"),
                            tts_vocab=os.path.join(HERE, "examples", "vocab.txt"),
                            vocoder_ckpt=os.path.join(tmp, "vocos.npz"), voices_dir=voices)
        service = ModelService(settings)
        # the base level: without earlier phases' cached blocks and cuBLAS workspaces, which unload also drops
        torch.cuda.synchronize()
        import gc

        gc.collect()
        clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear_workspaces is not None:
            clear_workspaces()
        torch.cuda.empty_cache()
        mem_base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        service.load()
        torch.cuda.synchronize()
        mem_loaded = torch.cuda.memory_allocated()
        log(f"serving on {card}: ModelService loaded F5-TTS Base + Vocos from .npz with StepBatcher (auto, k "
            f"{SERVING_SEGMENT_INTERVALS}) and warmed the (1024, 8) group in {time.perf_counter() - t0:.1f} s; "
            f"{mem_loaded / 2**30:.3f} GiB allocated")
        _serving_requests(service, card, launches, mem_base, mem_loaded)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"serving phase took {time.perf_counter() - t_phase:.1f} s on {card}")


def _serving_requests(service, card: str, launches: dict, mem_base: int, mem_loaded: int) -> None:
    import dataclasses
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from f5tts_tpu_torch.audio.io import read_wav
    from f5tts_tpu_torch.audio.preprocess import ensure_sentence_punctuation
    from f5tts_tpu_torch.engine.step_batcher import SolveGroup, StepBatcher, _Job
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm
    from f5tts_tpu_torch.serve.schemas import SpeechRequest

    engine, batcher = service.engine, service.batcher

    def say(msg: str) -> None:  # every number beside the card's name and power limit
        log(f"serving on {card}: {msg}")

    check(isinstance(batcher, StepBatcher) and batcher.adaptive, f"batcher=auto did not serve on StepBatcher: {batcher}")
    k = batcher.progs.k
    solves = _count_solves(engine)  # window solves of this engine: streaming and the equality check
    wrappers = {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos, "row_norm": row_norm}
    per_forward = {"flash_attention": engine.dit_cfg.depth, "rope_rows": engine.dit_cfg.depth, "conv_pos": 1,
                   "row_norm": 2 * engine.dit_cfg.depth + 1}
    for w in wrappers.values():
        w.launches = 0
    stats0 = dict(batcher.stats)
    pool = ThreadPoolExecutor(max_workers=12, thread_name_prefix="serving")
    voices = sorted(service.voices)
    ref, ref_sr, ref_text = service.voices[voices[0]]
    one, many = _serving_texts(engine, ref, ensure_sentence_punctuation(ref_text))

    def planned(text: str, voice: str, **kw) -> int:
        """Samples of the request's wave, planned by the engine being served."""
        e, (a, sr_, rt) = service.engine, service.voices[voice]
        return planned_length(e, e.prepare_request(text, a, sr_, ensure_sentence_punctuation(rt), **kw))

    def request(text: str, voice: str, seed: int, **kw):
        """One request as the speech route runs it; (wave, seconds from submit to the result)."""
        t_req = time.perf_counter()
        body = service.synthesize_sync(SpeechRequest(text=text, voice=voice, seed=seed, **kw))
        dt = time.perf_counter() - t_req
        wave, sr_ = read_wav(body)
        want = planned(text, voice, seed=seed)
        check(sr_ == 24000 and len(wave) == want, f"request {text[:30]!r}: {len(wave)} samples, want {want}")
        check(bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) > 0, f"request {text[:30]!r}: wave not finite")
        return wave, dt

    def delta(key):
        return batcher.stats.get(key, 0) - stats0.get(key, 0)

    # 1. a lone request: its solve chains its segments
    wave, dt = request(one, voices[0], 1)
    say(f"lone request {len(wave) / 24000:.2f} s of audio in {dt:.3f} s; chained segments "
        f"{delta('chained_segments')}, segments {delta('segments')}")
    check(delta("chained_segments") >= 1, f"the lone request chained no segments: {batcher.stats}")

    # 2. a burst of 8 ~8-s requests from both voices (one of them 1 segment long, so a slot frees
    #    early), 3. a request submitted after the burst's first segment
    def burst(svc, late_at: float | None):
        b = svc.batcher
        reqs = [(one, voices[i % 2], 10 + i, {"nfe_step": 4} if i == 7 else {}) for i in range(8)]
        t_b = time.perf_counter()
        futs = [pool.submit(request, text, v, seed, **kw) for text, v, seed, kw in reqs]
        if late_at is None:  # step: as soon as a running group of the bucket has a free slot
            deadline = time.perf_counter() + 20
            while time.perf_counter() < deadline and not any(
                    g.nb == 1024 and g.age_segments >= 1 and g.free_slots() and g.active() for g in list(b._groups)):
                time.sleep(0.001)
        else:
            time.sleep(max(late_at - (time.perf_counter() - t_b), 0))
        t_late = time.perf_counter() - t_b
        late = pool.submit(request, one, voices[1], 99)
        lat = [f.result()[1] for f in futs]
        late_lat = late.result()[1]
        return time.perf_counter() - t_b, lat, late_lat, t_late

    g0, j0 = delta("groups_started"), delta("mid_solve_joins")
    wall, lat, late_lat, t_late = burst(service, None)
    step_burst = (wall, lat, late_lat)
    say(f"burst of 8 + 1 late request on StepBatcher: groups started {delta('groups_started') - g0}, "
        f"mid-solve joins {delta('mid_solve_joins') - j0}, late request submitted {t_late:.3f} s after the burst")
    check(delta("groups_started") - g0 < 9, "the burst's rows shared no group")
    check(delta("mid_solve_joins") - j0 >= 1, f"the late request did not join a running solve: {batcher.stats}")

    # 4. a multi-chunk request, and a speech edit that joins its group mid-solve
    edit_audio = synthetic_ref(10.0, 150.0, 22)
    shared = threading.Event()

    def watch():
        while not shared.is_set() and watching[0]:
            for g in list(batcher._groups):
                rows = [s.job.row for s in list(g.slots) if s is not None]
                if any(r.edit_mask is not None for r in rows) and any(r.edit_mask is None for r in rows):
                    shared.set()
            time.sleep(0.0005)

    watching = [True]
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    multi = pool.submit(request, many, voices[0], 30)
    deadline = time.perf_counter() + 20
    while time.perf_counter() < deadline and not any(g.age_segments >= 1 and g.active() for g in list(batcher._groups)):
        time.sleep(0.001)
    edit = pool.submit(service.speech_edit_sync, edit_audio, 24000, "a new sentence replaces the middle of this clip.",
                       [(4.0, 6.0)], None, seed=31)
    wave_m, dt_m = multi.result()
    wave_e, sr_e = edit.result()
    watching[0] = False
    watcher.join()
    n_rows = len(engine.prepare_request(many, ref, ref_sr, ref_text).rows)
    say(f"multi-chunk request ({n_rows} rows) {len(wave_m) / 24000:.2f} s in {dt_m:.3f} s; speech edit of "
        f"one 2-s span of a 10-s clip: {len(wave_e) / sr_e:.2f} s, shared a solve group with synthesis rows: "
        f"{shared.is_set()}")
    check(n_rows > 1, "the multi-chunk request planned one row")
    check(sr_e == 24000 and bool(np.isfinite(wave_e).all()) and float(np.abs(wave_e).max()) > 0,
          "speech edit: wave not finite/non-zero")
    check(abs(len(wave_e) - len(edit_audio)) <= 2 * 256, f"speech edit returned {len(wave_e)} samples for {len(edit_audio)}")
    check(shared.is_set(), "the edit row never shared a solve group with synthesis rows")

    # 5. a streamed request
    sr_s, segments = service.stream_segments(SpeechRequest(text=many, voice=voices[1], seed=40))
    t_s = time.perf_counter()
    parts = list(segments())
    del segments  # it holds the engine, which unload below must be able to free
    stream = np.concatenate(parts)
    want = planned(many, voices[1], seed=40)
    say(f"streamed request, {len(parts)} segments of {[len(x_) for x_ in parts]} samples in "
        f"{time.perf_counter() - t_s:.3f} s, {len(stream)} samples (want {want})")
    check(sr_s == 24000 and len(stream) == want and len(parts) > 1 and bool(np.isfinite(stream).all()),
          "streamed request: wrong length or not finite")

    # equality: one row through StepBatcher and through the window solve, same seed
    a, s_, rt = service.voices[voices[0]]
    row = engine.prepare_request(one, a, s_, ensure_sentence_punctuation(rt), seed=50).rows[0]
    step_wave = batcher.submit(row).result(timeout=600)[0]
    window_wave = engine.synthesize_rows([row])[0][0]
    rel_rms = float(np.sqrt(np.mean((step_wave - window_wave) ** 2)) / np.sqrt(np.mean(window_wave**2)))
    say(f"one row through StepBatcher against the window solve, same seed: RMS of the difference over the "
        f"wave's RMS {rel_rms:.3e} (tol {STREAM_REL_RMS}), max abs {float(np.abs(step_wave - window_wave).max()):.3e}")
    check(step_wave.shape == window_wave.shape and rel_rms <= STREAM_REL_RMS, f"step row differs from window row: {rel_rms}")

    # launch counts: k x 2 forwards per dispatched segment (Ralston), plus each window solve's forwards
    torch.cuda.synchronize()
    got = {name: w.launches for name, w in wrappers.items()}
    seg_forwards = delta("segments") * k * 2
    forwards = seg_forwards + sum(f for f, _ in solves)
    want = {name: per_forward[name] * forwards for name in wrappers}
    say(f"{delta('segments')} segments ({delta('chained_segments')} chained) = {seg_forwards} DiT forwards, "
        f"window solves (forwards, rows) {list(solves)}; launches {got} (want {want}); batcher stats {batcher.stats}")
    check(got == want and forwards > 0, f"serving launch counts {got}, want {want}")
    for name in wrappers:
        launches[name]["serving"] = got[name]

    # one segment of a full (1024, 8) group: host dispatch time against device time
    g = SolveGroup(batcher.progs, 1024, 8)
    for i in range(8):
        g.admit(_Job(dataclasses.replace(row, seed=60 + i)))
    g.dispatch_segment()  # metadata upload and text embedding happen once per admission
    torch.cuda.synchronize()
    host, dev_ms = [], []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        g.dispatch_segment()
        host.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        e1.synchronize()
        dev_ms.append(e0.elapsed_time(e1))
    say(f"one segment of a (1024, 8) group ({k} Ralston intervals = {2 * k} fused 16-row forwards): "
        f"host dispatch {[round(x, 2) for x in host]} ms, device span {[round(x, 2) for x in dev_ms]} ms")
    profile_by_family(f"one step-batcher segment (1024 x 8 rows) on {card}", lambda: (g.dispatch_segment(), torch.cuda.synchronize()),
                      BENCH_FAMILIES, wall_plain_ms=statistics.median(dev_ms))
    del g
    engine = batcher = None  # the service's unload must be able to free the model

    # unload -> load: the device memory comes back to its level
    service.unload()
    mem_unloaded = torch.cuda.memory_allocated()
    service.load()
    torch.cuda.synchronize()
    mem_reloaded = torch.cuda.memory_allocated()
    model = mem_loaded - mem_base
    say(f"device memory before load {mem_base / 2**30:.3f} GiB, after load {mem_loaded / 2**30:.3f} GiB, "
        f"after unload {mem_unloaded / 2**30:.3f} GiB, after load again {mem_reloaded / 2**30:.3f} GiB")
    check(abs(mem_reloaded - mem_loaded) <= SERVING_MEM_TOL * mem_loaded, "device memory leaked across unload -> load")
    check(mem_unloaded - mem_base <= SERVING_MEM_TOL * model, "unload kept the model's device memory")

    # the same burst on the window batcher, fetch pipelining depth 3 then 1
    results = {"step": step_burst}
    service.swap(lambda: setattr(service.settings, "batcher", "window"))
    for depth in (3, 1):
        service.engine.cfg = dataclasses.replace(service.engine.cfg, fetch_pipeline_depth=depth)
        wall, lat, late_lat, _ = burst(service, t_late)
        results[f"window, fetch depth {depth}"] = (wall, lat, late_lat)
    for name, (wall, lat, late_lat) in results.items():
        say(f"burst on {name}: 8 requests + 1 late in {wall:.3f} s; request latency p50 "
            f"{statistics.median(lat):.3f} s, max {max(lat):.3f} s; late request (submitted after {t_late:.3f} s) "
            f"{late_lat:.3f} s")
    service.unload()
    pool.shutdown()


BENCH_FAMILIES = (("flash_attention", ("flash_wgmma", "flash_fwd")), ("rope_rows", ("rope_rows",)),
                  ("conv_pos", ("conv_pair", "conv_generic")), ("quant_matmul", ("quant_matmul_kernel",)),
                  ("quant_prepass", ("quantize_rows_kernel",)), ("bf16_add", ("CUDAFunctor_add<c10::BFloat16>",)))


def _bench_inputs(dev, batch: int = 8, n: int = 1024, ref_frames: int = 128, text_pad: int = 512):
    """The bench geometry's prompts: random cond mels, text ids, full durations, seeds 0..batch-1."""
    rng = np.random.default_rng(0)
    return (torch.as_tensor(rng.standard_normal((batch, n, 100)), dtype=torch.float32, device=dev),
            torch.full((batch,), ref_frames, dtype=torch.int32, device=dev),
            torch.as_tensor(rng.integers(0, 90, (batch, text_pad)), dtype=torch.int32, device=dev),
            torch.full((batch,), n, dtype=torch.int32, device=dev), np.arange(batch))


def bench_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, quantization: str = "none",
                backbone: str = "F5-TTS", fns: dict | None = None) -> dict:
    """One bucket program at the bench geometry, profiled once and timed three
    times. Returns the audio-s/s, the median seconds, and the profile's device
    milliseconds and launch counts by kernel family. ``fns`` are the engine's
    backbone hooks (``forward_fn``/``embed_fn``)."""
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.sampling.euler import DEFAULT_NFE, nfe_to_steps

    batch, n, ref_frames, text_pad = 8, 1024, 128, 512
    steps = nfe_to_steps(DEFAULT_NFE["ralston"], "ralston")
    engine = TTSEngine(dit_np, dit_cfg, voc_np, tok, EngineConfig(
        vocoder=voc_cfg, duration_buckets=(n,), batch_buckets=(batch,), text_pad=text_pad,
        quantization=quantization), device=dev, **(fns or {}))
    cond, cond_lens, text, duration, seeds = _bench_inputs(dev, batch, n, ref_frames, text_pad)

    def run():
        _, wave = engine.bucket_program(cond, cond_lens, text, duration, seeds, steps=steps, cfg_strength=2.0)
        return float(wave[:, :64].sum())  # host fetch: the solve has finished

    run()
    what = f"{backbone} " + ("bf16" if quantization == "none" else quantization)
    sums, counts = profile_by_family(f"one bench solve ({what})", run, BENCH_FAMILIES)
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
    return {"audio_s_per_s": audio_s / dt, "median_s": dt, "launch_counts": counts, "device_ms": sums}


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
    from f5tts_tpu_torch.train.trainer import TrainConfig, Trainer, optimizer_state_bytes
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
    _sample_hook_check(trainer, state, model, batches[0], wrappers, per_step, launches)
    adamw_bytes = optimizer_state_bytes(state["opt_state"])
    del state, trainer
    torch.cuda.empty_cache()

    # two Base steps with Adafactor: its optimizer state beside AdamW's
    trainer = Trainer(CFMConfig(model=model), TrainConfig(warmup_updates=2, optimizer="adafactor"),
                      compute_dtype=torch.bfloat16, device=dev)
    state, _ = trainer.init_or_resume()
    af_bytes = optimizer_state_bytes(state["opt_state"])
    for i in range(2):
        before = {name: w.launches for name, w in wrappers.items()}
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        metrics = trainer.step(state, batches[0])
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        dt = time.perf_counter() - t_step
        counts = {name: w.launches - before[name] for name, w in wrappers.items()}
        log(f"adafactor step {i + 1} ({batches[0]['mel'].shape[0]} x {batches[0]['mel'].shape[1]}): loss {loss:.4f}, "
            f"grad norm {gnorm:.4f}, {dt:.3f} s; launches {counts}")
        check(np.isfinite(loss) and np.isfinite(gnorm), f"adafactor step {i + 1}: loss {loss}, grad norm {gnorm}")
        check(counts == per_step, f"adafactor step {i + 1}: launches {counts}, want {per_step}")
    log(f"optimizer state at F5-TTS Base: adafactor {af_bytes / 2**20:.1f} MiB (factored second moments, bf16 "
        f"momentum) against adamw {adamw_bytes / 2**20:.1f} MiB = {af_bytes / adamw_bytes:.3f}x")
    check(af_bytes < 0.5 * adamw_bytes, f"adafactor state {af_bytes} not below half of adamw's {adamw_bytes}")
    del state, trainer
    torch.cuda.empty_cache()


def _sample_hook_check(trainer, state, model, batch, wrappers: dict, per_step: dict, launches: dict) -> None:
    """``Trainer(sample_hook=...)`` fires the sample hook once (``sample_every``
    1, one update) at NFE 16: Euler, 16 fused CFG-pair fp32 forwards of the
    EMA weights, exact launches, one ``.npy`` per prompt."""
    import shutil
    import tempfile

    from f5tts_tpu_torch.models.cfm import CFMConfig
    from f5tts_tpu_torch.train.sample_hook import make_sample_hook, prompts_from_batch

    out_dir = tempfile.mkdtemp(prefix="f5_samples_")
    prompts = prompts_from_batch(batch)
    inner = make_sample_hook(CFMConfig(model=model), out_dir, prompts, nfe_step=16)
    fired = []

    def hook(st, step_no):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        metrics = inner(st, step_no)
        fired.append((step_no, metrics, time.perf_counter() - t0, {k: w.launches for k, w in wrappers.items()}))

    trainer.sample_hook, trainer.sample_every = hook, 1
    try:
        trainer.fit(state, [batch], total_updates=1)
    finally:
        trainer.sample_hook = trainer.sample_every = None
    files = sorted(os.listdir(out_dir))
    shutil.rmtree(out_dir, ignore_errors=True)
    check(len(fired) == 1, f"the sample hook fired {len(fired)} times, want 1")
    step_no, metrics, secs, counts = fired[0]
    forwards = 16  # Euler NFE 16: one fused 2b forward a step
    # fp32 (the hook's default, as the CLI runs it): the attention's fp32 kernel applies RoPE itself (no
    # pre-pass), and the conv-pos pair is two launches of the CUDA-core layer
    want = {**{k: 0 for k in per_step}, "flash_attention": model.depth * forwards, "conv_pos": 2 * forwards}
    log(f"sample hook at step {step_no} ({len(prompts)} prompts, NFE 16, fp32, EMA weights): {secs:.2f} s, launches "
        f"{counts} (want {want}); files {files}; metrics {metrics}")
    check(counts == want, f"sample hook launches {counts}, want {want}")
    check(files == [f"step{step_no}_p{i}.npy" for i in range(len(prompts))], f"sample hook files {files}")
    check(all(np.isfinite(v) and v > 0 for v in metrics.values()), f"sample hook metrics {metrics}")
    for k in ("flash_attention", "rope_rows", "conv_pos"):
        launches[k]["sample_hook"] = counts[k]


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
        ctx = P.parler_prefill(params_from_numpy(tree, dev, dtype), cfg, enc, enc_mask, frames, 0, prompt, prompt_mask,
                               None, None, -1, 0.0, 0, None, dtype)
        carry, logits, toks, greedy = ctx.carry0, [], [], []
        for j in range(1, ctx.steps + 1):
            logits.append(carry[0].clone())  # a replayed step's logits are a buffer the next replay overwrites
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


def parler_full_trees():
    """indic-parler-tts (flan-t5-large encoder, 24-layer decoder over 9
    codebooks, 44.1 kHz DAC) at full width and depth: the configs and the
    seeded numpy trees (seeds 0, 1, 2) that phases Parler and 19 share."""
    from f5tts_tpu_torch.models import parler as P
    from f5tts_tpu_torch.models.convert import init_dac_numpy, init_parler_decoder_numpy, init_t5_numpy
    from f5tts_tpu_torch.train.tree import tree_leaves

    cfgs = P.T5Config(), P.ParlerDecoderConfig(), P.DacConfig()
    t0 = time.perf_counter()
    trees = (init_t5_numpy(cfgs[0], seed=0), init_parler_decoder_numpy(cfgs[1], seed=1), init_dac_numpy(cfgs[2], seed=2))
    n_params = [sum(t.size for _, t in tree_leaves(tree)) for tree in trees]
    log(f"parler params (T5 {n_params[0]}, decoder {n_params[1]}, DAC {n_params[2]}; seeds 0, 1, 2) in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfgs, trees


def parler_graph_on_served_paths(engine, desc: str, text: str, reps: int = 3) -> None:
    """The decode step's CUDA graph (captured once a call, after the first
    eager position) on the served paths: ``synthesize_batch`` at b 1 and b 4
    and a stream's first audio and whole, each against the same call with
    the capture turned off. Alternating, medians of ``reps``; a time only,
    no check."""
    from f5tts_tpu_torch.models import parler as P

    prefill = P.parler_prefill

    def eager_prefill(*a, **k):
        ctx = prefill(*a, **k)
        ctx.graphable = False
        return ctx

    def batch(n):
        def run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.synthesize_batch([desc] * n, [text] * n, row_seeds=list(range(5, 5 + n)))
            return time.perf_counter() - t, None
        return run

    def stream():
        torch.cuda.synchronize()
        t = time.perf_counter()
        chunks = engine.synthesize_streaming(desc, text, seed=5)
        next(chunks)
        first = time.perf_counter() - t
        for _ in chunks:
            pass
        return time.perf_counter() - t, first

    paths = {"b 1": batch(1), "b 4": batch(4), "stream": stream}
    times = {(path, mode): [] for path in paths for mode in ("eager", "graph")}
    try:
        for _ in range(reps):
            for path, fn in paths.items():
                for mode in ("eager", "graph"):
                    P.parler_prefill = eager_prefill if mode == "eager" else prefill
                    times[path, mode].append(fn())
    finally:
        P.parler_prefill = prefill
    parts = []
    for path in paths:
        e, g = (statistics.median(t for t, _ in times[path, mode]) for mode in ("eager", "graph"))
        part = f"{path}: eager {e:.3f} s, graph {g:.3f} s ({e / g:.2f}x)"
        if path == "stream":
            fe, fg = (statistics.median(f for _, f in times[path, mode]) for mode in ("eager", "graph"))
            part += f", first audio eager {fe:.3f} s, graph {fg:.3f} s ({fe / fg:.2f}x)"
        parts.append(part)
    log(f"parler decode graph on the served paths ({engine.cfg.max_frames} frames a row, medians of {reps}, "
        f"alternating): " + "; ".join(parts))


def parler_phase(dev, card: str, launches: dict, cfgs, trees) -> None:
    from f5tts_tpu_torch.engine.ar_engine import ParlerEngineConfig, ParlerRow, ParlerTTSEngine
    from f5tts_tpu_torch.engine.batcher import ContinuousBatcher
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.decode_attention import decode_attention
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train_bwd, flash_attention_train_fwd

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

    t5_cfg, dec_cfg, dac_cfg = cfgs
    layers, K, hop = dec_cfg.layers, dec_cfg.codebooks, dac_cfg.hop

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
    parler_graph_on_served_paths(engine, desc, text)
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


# ---------------------------------------------------------------------------
# phase 19: the autoregressive leftovers (Parler checkpoints, parler_loss, the AR mel decoder)
# ---------------------------------------------------------------------------

PARLER_CKPT_DAC_REL = 1e-6  # DAC leaves read from weight_g/weight_v pairs: the fold g * v / ||v|| rounds
PARLER_CKPT_WAVE_TOL = 1e-2  # waves, loaded vs seeded engine, bf16: a DAC weight may round to another bf16 value
PARLER_LOSS_BF16_REL = 1e-2  # parler_loss at bf16 compute vs fp32, relative: bf16 hidden states through 24 layers
AR_TEACHER_TOL = 1e-3  # ar_generate (stop never fires) vs the teacher-forced pass over its frames, fp32, max abs


def parler_hf_state_dict(t5: dict, dec: dict, dac: dict, t5_cfg, dec_cfg) -> dict:
    """The ParlerTTSForConditionalGeneration state dict of numpy trees: the
    inverse of ``models/parler.py:load_parler_checkpoint``'s key map. T5 under
    ``text_encoder.``, the decoder under ``decoder.model.decoder.`` with its
    heads at ``decoder.lm_heads.``, ``embed_prompts.weight``,
    ``enc_to_dec_proj`` where the tree has one, and the DAC under
    ``audio_encoder.model.`` in descript's positional layout, every conv as a
    ``weight_g`` / ``weight_v`` pair (``g = ||v||`` over all axes but the
    first, ``v`` the weight), snake alphas ``(1, ch, 1)``."""
    sd: dict = {}

    def put(key, a):
        sd[key] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    def lin(prefix, p, l=None):
        put(f"{prefix}.weight", (p["w"] if l is None else p["w"][l]).T)
        if "b" in p:
            put(f"{prefix}.bias", p["b"] if l is None else p["b"][l])

    e, tb = "text_encoder.encoder", t5["blocks"]
    put(f"{e}.embed_tokens.weight", t5["embed"])
    put(f"{e}.block.0.layer.0.SelfAttention.relative_attention_bias.weight", t5["rel_bias"])
    for i in range(t5_cfg.layers):
        b0, b1 = f"{e}.block.{i}.layer.0", f"{e}.block.{i}.layer.1"
        put(f"{b0}.layer_norm.weight", tb["ln1"]["g"][i])
        for n in ("q", "k", "v", "o"):
            lin(f"{b0}.SelfAttention.{n}", tb[n], i)
        put(f"{b1}.layer_norm.weight", tb["ln2"]["g"][i])
        for n in ("wi_0", "wi_1", "wo"):
            lin(f"{b1}.DenseReluDense.{n}", tb[n], i)
    put(f"{e}.final_layer_norm.weight", t5["final_ln"]["g"])

    d, db = "decoder.model.decoder", dec["blocks"]
    for k in range(dec_cfg.codebooks):
        put(f"{d}.embed_tokens.{k}.weight", dec["embed_tokens"][k])
        put(f"decoder.lm_heads.{k}.weight", dec["lm_heads"][k].T)
    for i in range(dec_cfg.layers):
        L = f"{d}.layers.{i}"
        for name, key in (("self_attn_layer_norm", "ln_sa"), ("encoder_attn_layer_norm", "ln_ca"),
                          ("final_layer_norm", "ln_ff")):
            put(f"{L}.{name}.weight", db[key]["w"][i])
            put(f"{L}.{name}.bias", db[key]["b"][i])
        for name, key in (("self_attn", "sa"), ("encoder_attn", "ca")):
            for proj, n in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o")):
                lin(f"{L}.{name}.{proj}", db[key][n], i)
        lin(f"{L}.fc1", db["fc1"], i)
        lin(f"{L}.fc2", db["fc2"], i)
    put(f"{d}.layer_norm.weight", dec["final_ln"]["w"])
    put(f"{d}.layer_norm.bias", dec["final_ln"]["b"])
    put("embed_prompts.weight", dec["embed_prompts"])
    if "enc_proj" in dec:
        lin("enc_to_dec_proj", dec["enc_proj"])

    a = "audio_encoder.model"

    def weight_norm(prefix, w, b):  # w in torch's layout
        w = np.ascontiguousarray(w, dtype=np.float32)
        put(f"{prefix}.weight_g", np.sqrt(np.sum(w * w, axis=tuple(range(1, w.ndim)), keepdims=True)))
        put(f"{prefix}.weight_v", w)
        put(f"{prefix}.bias", b)

    def conv(prefix, p):  # (k, in, out) -> Conv1d (out, in, k)
        weight_norm(prefix, p["w"].transpose(2, 1, 0), p["b"])

    def alpha(prefix, x):
        put(f"{prefix}.alpha", x.reshape(1, -1, 1))

    q = dac["quant"]
    for i in range(len(q["codebook"])):
        put(f"{a}.quantizer.quantizers.{i}.codebook.weight", q["codebook"][i])
        weight_norm(f"{a}.quantizer.quantizers.{i}.out_proj", q["proj_w"][i].T[..., None], q["proj_b"][i])
    conv(f"{a}.decoder.model.0", dac["conv1"])
    for i, blk in enumerate(dac["blocks"]):
        B = f"{a}.decoder.model.{1 + i}"
        alpha(f"{B}.block.0", blk["alpha"])
        # (k, in, out) flipped along time -> ConvTranspose1d (in, out, k)
        weight_norm(f"{B}.block.1", blk["convt"]["w"][::-1].transpose(1, 2, 0), blk["convt"]["b"])
        for j, ru in enumerate(blk["res"]):
            R = f"{B}.block.{2 + j}"
            alpha(f"{R}.block.0", ru["alpha1"])
            conv(f"{R}.block.1", ru["conv1"])
            alpha(f"{R}.block.2", ru["alpha2"])
            conv(f"{R}.block.3", ru["conv2"])
    nb = len(dac["blocks"])
    alpha(f"{a}.decoder.model.{1 + nb}", dac["alpha_out"])
    conv(f"{a}.decoder.model.{2 + nb}", dac["conv2"])
    return sd


def _tree_diff(got, want, rel: bool = False) -> float:
    """Largest difference between two numpy trees of one structure (per leaf
    over the leaf's peak when ``rel``); inf where the structures differ."""
    from f5tts_tpu_torch.train.tree import tree_leaves

    a, b = sorted(tree_leaves(got), key=lambda kv: kv[0]), sorted(tree_leaves(want), key=lambda kv: kv[0])
    if [k for k, _ in a] != [k for k, _ in b] or any(x.shape != y.shape for (_, x), (_, y) in zip(a, b)):
        return float("inf")
    worst = 0.0
    for (_, x), (_, y) in zip(a, b):
        d = float(np.abs(x.astype(np.float64) - y).max()) if x.size else 0.0
        worst = max(worst, d / max(float(np.abs(y).max()), 1e-30) if rel else d)
    return worst


def _all_wrappers() -> dict:
    from f5tts_tpu_torch.ops.kernels.ablate_attention import ablate_attention
    from f5tts_tpu_torch.ops.kernels.decode_attention import decode_attention
    from f5tts_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm

    return {**_distill_wrappers(), "decode_attention": decode_attention, "quant_matmul": quant_matmul,
            "ablate_attention": ablate_attention, "row_norm": row_norm}


def _launched(what: str, run, want):
    """Run ``run`` with every kernel's count set to 0 before it; every count
    read after it must equal ``want``'s (0 where ``want`` has no entry).
    ``want`` may be a function of the counts read (a run whose solves are not
    known before it); the counts it returns are checked the same way."""
    wrappers = _all_wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    for w in wrappers.values():
        w.launches = 0
    out = run()
    torch.cuda.synchronize()
    got = {name: w.launches for name, w in wrappers.items()}
    for name, w in wrappers.items():  # the running totals go on (the ablation kernel's is checked at the end)
        w.launches = before[name] + got[name]
    if callable(want):
        want = want(got)
    log(f"{what}: launches {({k: v for k, v in got.items() if v}) or 'none'} (want {want or 'none'})")
    check(got == {name: want.get(name, 0) for name in wrappers}, f"{what}: launches {got}, want {want}")
    return out


def parler_ckpt_check(dev, card: str, launches: dict, cfgs, trees) -> None:
    """(a) One ParlerTTS-layout state dict written from the seeded trees, read
    back by ``load_parler_checkpoint`` and served beside the seeded trees."""
    import shutil
    import tempfile

    from f5tts_tpu_torch.engine.ar_engine import ParlerEngineConfig, ParlerTTSEngine
    from f5tts_tpu_torch.models import parler as P

    t5_cfg, dec_cfg, dac_cfg = cfgs
    t0 = time.perf_counter()
    sd = parler_hf_state_dict(*trees, t5_cfg, dec_cfg)
    n_params, n_keys = sum(t.numel() for t in sd.values()), len(sd)
    tmp = tempfile.mkdtemp(prefix="parler_ckpt_")
    try:
        path = os.path.join(tmp, "model.pt")
        torch.save(sd, path)
        del sd
        t_write, size = time.perf_counter() - t0, os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = P.load_parler_checkpoint(path, t5_cfg, dec_cfg, dac_cfg)
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diffs = [_tree_diff(loaded[0], trees[0]), _tree_diff(loaded[1], trees[1]), _tree_diff(loaded[2], trees[2], rel=True)]
    log(f"(a) parler checkpoint (ParlerTTSForConditionalGeneration layout, {n_keys} fp32 tensors, {n_params} numbers, "
        f"the DAC as weight_g/weight_v pairs): {size / 2**30:.3f} GiB written in {t_write:.1f} s, "
        f"load_parler_checkpoint {t_load:.1f} s; T5 max abs diff {diffs[0]:.3e}, decoder {diffs[1]:.3e} (want 0), "
        f"DAC max relative diff {diffs[2]:.3e} (tol {PARLER_CKPT_DAC_REL})")
    check(diffs[0] == 0.0 and diffs[1] == 0.0, f"loaded T5 / decoder trees differ from the seeded ones: {diffs[:2]}")
    check(diffs[2] <= PARLER_CKPT_DAC_REL, f"loaded DAC differs from the seeded one: {diffs[2]}")

    def encode_fn(text):  # stand-in for the T5 sentencepiece tokenizer
        return [ord(c) % t5_cfg.vocab for c in text]

    frames, K = 128, dec_cfg.codebooks
    ecfg = ParlerEngineConfig(max_frames=frames, temperature=0.0, eos_token=-1)
    descs = ["A calm female speaker with clear diction.", "A fast male voice, close microphone.",
             "An old storyteller, warm and slow."]
    prompts = ["Hello from the checkpoint.", "नमस्ते, यह दूसरा अनुरोध है।", "ನಮಸ್ಕಾರ, ಇದು ಮೂರನೇ ವಿನಂತಿ."]
    want = {"decode_attention": 2 * dec_cfg.layers * (frames + K - 1)}
    outs = {}
    orig = P.dac_decode_codes
    for name, tr in (("seeded", trees), ("loaded", loaded)):
        engine = ParlerTTSEngine(tr[0], t5_cfg, tr[1], dec_cfg, tr[2], dac_cfg, ecfg, encode_fn=encode_fn, device=dev)
        codes = []

        def capture(params, c, *a, **k):  # the codes the engine hands its DAC
            codes.append(c.clone())
            return orig(params, c, *a, **k)

        P.dac_decode_codes = capture
        try:
            t0 = time.perf_counter()
            waves = _launched(f"(a) {name} engine, one greedy request of {len(descs)} rows x {frames} frames, bf16",
                              lambda: engine.synthesize_batch(descs, prompts), want)
            dt = time.perf_counter() - t0
        finally:
            P.dac_decode_codes = orig
        outs[name] = (codes[0], waves, dt)
        del engine
        torch.cuda.empty_cache()
    (c_s, w_s, dt_s), (c_l, w_l, dt_l) = outs["seeded"], outs["loaded"]
    same = bool(torch.equal(c_s, c_l))
    wave_diff = max(float(np.abs(a - b).max()) if a.shape == b.shape else float("inf") for a, b in zip(w_s, w_l))
    log(f"(a) on {card}: codes {tuple(c_s.shape)} equal: {same}; max abs wave difference {wave_diff:.3e} (tol "
        f"{PARLER_CKPT_WAVE_TOL}, wave peak {max(float(np.abs(w).max()) for w in w_s):.4f}); request {dt_s:.2f} s "
        f"seeded, {dt_l:.2f} s loaded")
    check(same, "codes from the loaded checkpoint differ from the seeded engine's")
    check(all(len(w) == frames * dac_cfg.hop and np.isfinite(w).all() for w in w_l), "loaded engine's waves")
    check(wave_diff <= PARLER_CKPT_WAVE_TOL, f"waves of the loaded checkpoint differ: {wave_diff}")
    launches["decode_attention"]["parler_ckpt"] = 2 * want["decode_attention"]


def parler_loss_check(dev, card: str, cfgs, trees) -> None:
    """(b) ``parler_loss`` and its backward at full decoder width, fp32 and bf16
    compute over the same fp32 parameters."""
    from f5tts_tpu_torch.models import parler as P
    from f5tts_tpu_torch.models.convert import params_from_numpy
    from f5tts_tpu_torch.train.tree import tree_leaves

    dec_cfg = cfgs[1]
    K, pad = dec_cfg.codebooks, dec_cfg.vocab
    b, frames, enc_n, p = 2, 256 - K + 1, 64, 16
    rng = np.random.default_rng(19)
    codes = rng.integers(0, dec_cfg.vocab, (b, K, frames))
    delayed = P.build_delay_pattern(codes, pad, frames + K - 1)
    full = np.concatenate([np.full((b, K, 1), pad), delayed], axis=2)  # a BOS column: 257 positions, 256 inputs
    code_mask = np.ones(full.shape, bool)
    code_mask[1, :, 200:] = False
    enc = torch.as_tensor(rng.standard_normal((b, enc_n, dec_cfg.cross_dim)), dtype=torch.float32, device=dev)
    enc_mask = torch.as_tensor(np.arange(enc_n)[None] < np.array([[enc_n], [40]]), device=dev)
    prompt = torch.as_tensor(rng.integers(0, dec_cfg.prompt_vocab, (b, p)), device=dev)
    prompt_mask = torch.as_tensor(np.arange(p)[None] >= np.array([[0], [6]]), device=dev)
    full_t, mask_t = torch.as_tensor(full, device=dev), torch.as_tensor(code_mask, device=dev)
    params = params_from_numpy(trees[1], dev)
    leaves = [t for _, t in tree_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    res = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        def step():
            for t in leaves:
                t.grad = None
            loss = P.parler_loss(params, dec_cfg, full_t, mask_t, enc, enc_mask, prompt, prompt_mask,
                                 compute_dtype=dtype)
            loss.backward()
            return loss

        _launched(f"(b) parler_loss {name} warm step", step, {})
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = _launched(f"(b) parler_loss {name} step", step, {})
            times.append(time.perf_counter() - t0)
        named = {"lm_heads": params["lm_heads"].grad, "embed_tokens": params["embed_tokens"].grad,
                 "blocks.sa.q": params["blocks"]["sa"]["q"]["w"].grad}
        grads = [t.grad for t in leaves]
        finite = all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
        loss = float(loss.detach())
        res[name] = (loss, [g.clone() for g in grads] if finite else None)
        log(f"(b) parler_loss {name} on {card}: b {b} x {full.shape[2] - 1} positions (the delay pattern over {frames} "
            f"frames), {p} prompt tokens, {enc_n} encoder states: loss {loss:.6f}; step (forward + backward) "
            f"{[round(1e3 * t, 2) for t in times]} ms, median {1e3 * statistics.median(times):.2f} ms; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; every leaf's gradient finite: {finite}; "
            f"|grad| sums " + ", ".join(f"{k} {float(g.abs().sum()):.4e}" for k, g in named.items()))
        check(np.isfinite(loss) and finite, f"parler_loss {name}: loss or a gradient not finite")
        check(all(float(g.abs().sum()) > 0 for g in named.values()), f"parler_loss {name}: a zero gradient")
    l32, l16 = res["fp32"][0], res["bf16"][0]
    rel = abs(l16 - l32) / abs(l32)
    g_rel = max(float(torch.linalg.vector_norm(g16 - g32) / torch.linalg.vector_norm(g32).clamp_min(1e-30))
                for g16, g32 in zip(res["bf16"][1], res["fp32"][1]))
    log(f"(b) bf16 loss {l16:.6f} vs fp32 {l32:.6f}: relative {rel:.3e} (tol {PARLER_LOSS_BF16_REL}); the largest "
        f"relative L2 of a bf16 gradient leaf against fp32 {g_rel:.3e} (not required)")
    check(rel <= PARLER_LOSS_BF16_REL, f"bf16 parler_loss differs from fp32: {rel}")
    del params, leaves, res
    torch.cuda.empty_cache()


def ar_branch_check(dev, card: str) -> None:
    """(c) The AR mel decoder at ``ARConfig()`` + ``VocosConfig()``: the
    teacher-forcing property in fp32, then ``ARTTSEngine`` at batch 8."""
    from f5tts_tpu_torch.engine.ar_engine import AREngineConfig, ARTTSEngine
    from f5tts_tpu_torch.models import ar as A
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.models.convert import ar_params_from_numpy, init_ar_numpy, init_vocos_numpy
    from f5tts_tpu_torch.models.vocos import VocosConfig
    from f5tts_tpu_torch.ops.rope import rotary_freqs
    from f5tts_tpu_torch.text.tokenizer import Tokenizer
    from f5tts_tpu_torch.train.tree import tree_leaves

    tok = Tokenizer.from_file(os.path.join(HERE, "examples", "vocab.txt"))
    cfg, voc_cfg = A.ARConfig(text_num_embeds=tok.vocab_size), VocosConfig()
    ar_np, voc_np = init_ar_numpy(cfg, seed=3), init_vocos_numpy(voc_cfg, seed=1)
    n_params = sum(x.size for _, x in tree_leaves(ar_np))

    # fp32: generation with a stop that never fires against the teacher-forced pass over its own frames
    params = ar_params_from_numpy(ar_np, dev)
    texts = ["Hello there, this is the autoregressive branch.", "A second, shorter row."]
    text = torch.as_tensor(tok.encode(texts, pad_to=64), device=dev)
    n_gen = 64

    def teacher():
        gen, lengths = A.ar_generate(params, cfg, text, n_gen, stop_threshold=2.0)
        with torch.no_grad():
            h = A._embed_sequence(params, cfg, text, gen[:, : n_gen - 1])
            freqs = torch.as_tensor(rotary_freqs(h.shape[1], cfg.dim_head), device=dev)
            valid = torch.cat([text != -1, torch.ones((len(texts), n_gen), dtype=torch.bool, device=dev)], dim=1)
            for l in range(cfg.depth):
                h = A._block_apply(A._layer(params["blocks"], l), h, cfg.heads, freqs, valid)
            nt = text.shape[1]
            pred = m.linear(params["mel_out"], m.rms_norm(params["norm_out"], h)[:, nt: nt + n_gen])
        return gen, lengths, pred

    per_pass = 2 * cfg.depth + 1  # row-norm launches a decoder pass: two a block and the final norm
    gen, lengths, pred = _launched(f"(c) AR fp32 generation ({len(texts)} x {n_gen} frames, the stop never fires) "
                                   "and the teacher-forced pass", teacher,
                                   {"row_norm": per_pass * (n_gen + 2)})  # prefill, a pass a frame, the teacher
    err = float((gen - pred).abs().max())
    log(f"(c) AR teacher forcing on {card}: ARConfig() ({n_params} params), fp32, generated frames against the "
        f"teacher-forced predictions over them: max abs {err:.3e} at peak |mel| {float(gen.abs().max()):.3f} (tol "
        f"{AR_TEACHER_TOL}); lengths {lengths.tolist()}")
    check(lengths.tolist() == [n_gen] * len(texts), f"AR lengths {lengths.tolist()} with the stop disabled")
    check(err <= AR_TEACHER_TOL, f"AR generation differs from teacher forcing: {err}")
    del params
    torch.cuda.empty_cache()

    batch, max_frames, short = 8, 1024, 128
    sents = [f"This is sentence number {i} of the autoregressive request, spoken at an even pace." for i in range(batch)]
    engines = {n: ARTTSEngine(ar_np, cfg, voc_np, tok, AREngineConfig(vocoder=voc_cfg, text_pad=256, max_frames=n),
                              device=dev) for n in (short, max_frames)}
    hop, sr = engines[max_frames].cfg.hop_length, engines[max_frames].cfg.sample_rate

    def run(n):
        waves = engines[n].synthesize_batch(sents)
        check(len(waves) == batch and all(len(w) % hop == 0 and np.isfinite(w).all() for w in waves),
              "AR engine waves not finite or not whole frames")
        lengths = [len(w) // hop + 1 for w in waves]
        check(all(1 <= x <= n for x in lengths), f"AR lengths out of range: {lengths}")
        return lengths

    _launched(f"(c) ARTTSEngine warm call at {short} positions", lambda: run(short),
              {"row_norm": per_pass * (short + 1)})  # the prefill and a pass a position
    torch.cuda.reset_peak_memory_stats()
    iters, lens = [], None
    for i in range(3):
        t0 = time.perf_counter()
        lens = _launched(f"(c) ARTTSEngine call {i + 1}", lambda: run(max_frames),
                         {"row_norm": per_pass * (max_frames + 1)})
        iters.append(time.perf_counter() - t0)
    dt = statistics.median(iters)
    audio_s, budget_s = sum(lens) * hop / sr, batch * max_frames * hop / sr
    log(f"(c) ARTTSEngine.synthesize_batch on {card}: batch {batch}, text_pad 256, max_frames {max_frames}, bf16: lengths "
        f"{lens} ({audio_s:.2f} s of audio; the random stop head decides them); iter_s {[round(t, 4) for t in iters]}, "
        f"median {dt:.4f} s: {audio_s / dt:.2f} audio-s/s ({budget_s / dt:.2f} for rows that used all {max_frames} "
        f"frames: the decode runs every position whatever the stop), {1e3 * dt / max_frames:.3f} ms per position; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    run(short)
    dt_short = time.perf_counter() - t0
    _, counts = profile_by_family(
        f"one ARTTSEngine call at {short} positions (batch {batch}, bf16)",
        lambda: _launched(f"(c) ARTTSEngine call at {short} positions under the profiler", lambda: run(short),
                          {"row_norm": per_pass * (short + 1)}),
        (("softmax", ("softmax",)), ("gather/copy", ("index", "gather", "copy", "cat", "Memcpy", "Memset"))),
        top=8, device_only=True, wall_plain_ms=dt_short * 1e3)
    log(f"(c) {sum(counts.values()) / short:.1f} device launches per position ({sum(counts.values())} in a call of "
        f"{short} positions, the prefill and the vocoder included)")
    del engines
    torch.cuda.empty_cache()


def ar_phase(dev, card: str, launches: dict, cfgs, trees) -> None:
    """Phase 19: (a) the Parler checkpoint, (b) ``parler_loss``, (c) the AR mel decoder."""
    t_phase = time.perf_counter()
    parler_ckpt_check(dev, card, launches, cfgs, trees)
    parler_loss_check(dev, card, cfgs, trees)
    ar_branch_check(dev, card)
    log(f"autoregressive leftovers phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the other backbones, BigVGAN and torch checkpoints
# ---------------------------------------------------------------------------

BACKBONE_REQUESTS = [
    ("Hello there, this is a short test of the E2 backbone.", 2.5, 140.0, "A short reference clip."),
    ("नमस्ते, यह एक लंबा परीक्षण वाक्य है जो कई हिस्सों में बाँटा जाएगा। " * 4
     + "The same request mixes scripts, so the chunker packs words into several rows of one bucket.",
     3.0, 110.0, "यह संदर्भ वाक्य है।"),
    ("ನಮಸ್ಕಾರ, ಇದು ಮೂರನೇ ವಿನಂತಿ.", 4.0, 180.0, "Reference speech for the third voice."),
]
MMDIT_REL_L2 = 5e-2  # one bf16 + kernel MMDiT forward (22 blocks) against fp32 + plain, relative L2 on valid rows
BIGVGAN_REL_L2 = 5e-2  # bigvgan_decode in bf16 against fp32, relative L2 of the wave
BIGVGAN_FAMILIES = (("depthwise_conv", ("depthwise", "conv_depthwise")),
                    ("conv", ("conv", "Conv", "cudnn", "implicit", "fprop", "dgrad", "winograd")),
                    ("pad", ("reflection_pad", "replication_pad")))


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((got.float() - ref.float()).flatten())
                 / torch.linalg.vector_norm(ref.float().flatten()))


def _request_waves(engine, requests, what: str) -> list:
    """``synthesize`` each ``(text, ref seconds, f0, ref text)`` with seed i;
    every wave finite, non-zero and of the planned length."""
    waves = []
    for i, (text, secs, f0, ref_text) in enumerate(requests):
        ref = synthetic_ref(secs, f0, i)
        plan = engine.prepare_request(text, ref, 24000, ref_text, seed=i)
        t_req = time.perf_counter()
        wave, sr, mel = engine.synthesize(text, ref, 24000, ref_text, seed=i)
        torch.cuda.synchronize()
        want = planned_length(engine, plan)
        log(f"{what} request {i}: {len(plan.rows)} rows, {len(wave) / sr:.3f} s of audio in "
            f"{time.perf_counter() - t_req:.3f} s")
        check(sr == 24000 and wave.ndim == 1 and len(wave) == want, f"{what} request {i}: {len(wave)} samples, want {want}")
        check(bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) > 0 and bool(np.isfinite(mel).all()),
              f"{what} request {i}: wave or mel not finite/non-zero")
        waves.append(wave)
    return waves


def e2tts_phase(dev, voc_cfg, voc_np, tok, card: str, launches: dict, f5_bench: dict) -> None:
    """E2-TTS Base (UNetT, random weights from seed 0) + Vocos through
    ``TTSEngine``'s backbone hooks: requests with exact launch counts, the
    bench geometry beside the F5 figure with a profile, one step-batcher row,
    and bf16 + kernels against fp32 + plain on a small input."""
    import dataclasses

    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.engine.step_batcher import StepBatcher
    from f5tts_tpu_torch.models.convert import init_unett_numpy, unett_params_from_numpy
    from f5tts_tpu_torch.models.unett import UNetTConfig, unett_embed, unett_forward
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm
    from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm

    t_phase = time.perf_counter()
    ucfg = UNetTConfig(text_num_embeds=tok.vocab_size)  # E2-TTS Base: dim 1024, depth 24, 16 x 64 heads
    u_np = init_unett_numpy(ucfg, seed=0)
    n_params = sum(a.size for a in _leaves(u_np))
    fns = {"forward_fn": unett_forward, "embed_fn": unett_embed}
    engine = TTSEngine(u_np, ucfg, voc_np, tok, EngineConfig(vocoder=voc_cfg), device=dev, **fns)
    solves = _count_solves(engine)
    wrappers = {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos, "row_norm": row_norm}
    for w in wrappers.values():
        w.launches = 0
    _request_waves(engine, BACKBONE_REQUESTS, "E2-TTS")
    got = {name: w.launches for name, w in wrappers.items()}
    forwards = sum(f for f, _ in solves)
    # exactly the UNetT's 24 + 24 + 1 + 49 per forward: a DiT forward (22 + 22 + 1 + 45) anywhere would break the count
    want = {"flash_attention": ucfg.depth * forwards, "rope_rows": ucfg.depth * forwards, "conv_pos": forwards,
            "row_norm": (2 * ucfg.depth + 1) * forwards}
    log(f"E2-TTS Base ({n_params / 1e6:.1f} M params): {len(solves)} solves (forwards, rows) {solves}; launches "
        f"{got} (want {want}: {ucfg.depth} + {ucfg.depth} + 1 + {2 * ucfg.depth + 1} per UNetT forward)")
    check(any(b > 1 for _, b in solves), "E2-TTS: no solve batched several rows")
    check(got == want and forwards > 0, f"E2-TTS launch counts {got}, want {want}")
    for name in wrappers:
        launches[name]["e2tts"] = got[name]

    # one row through the step batcher: its segments reach the UNetT through the engine's hooks
    k = SERVING_SEGMENT_INTERVALS
    text, secs, f0, ref_text = BACKBONE_REQUESTS[0]
    row = engine.prepare_request(text, synthetic_ref(secs, f0, 0), 24000, ref_text, seed=7).rows[0]
    window_wave = engine.synthesize_rows([row])[0][0]
    for w in wrappers.values():
        w.launches = 0
    batcher = StepBatcher(engine, k).start()
    try:
        step_wave = batcher.submit(row).result(timeout=600)[0]
        segments = batcher.stats["segments"]
    finally:
        batcher.stop()
    torch.cuda.synchronize()
    got = {name: w.launches for name, w in wrappers.items()}
    seg_forwards = segments * k * 2
    want = {"flash_attention": ucfg.depth * seg_forwards, "rope_rows": ucfg.depth * seg_forwards,
            "conv_pos": seg_forwards, "row_norm": (2 * ucfg.depth + 1) * seg_forwards}
    rel_rms = float(np.sqrt(np.mean((step_wave - window_wave) ** 2)) / np.sqrt(np.mean(window_wave**2)))
    log(f"E2-TTS step batcher: {segments} segments of {k} intervals = {seg_forwards} UNetT forwards, launches {got} "
        f"(want {want}); wave against the window solve: relative RMS {rel_rms:.3e} (tol {STREAM_REL_RMS})")
    check(got == want and seg_forwards > 0, f"E2-TTS step-batcher launches {got}, want {want}")
    check(step_wave.shape == window_wave.shape and rel_rms <= STREAM_REL_RMS, f"E2-TTS step row differs: {rel_rms}")
    for name in wrappers:
        launches[name]["e2tts"] += got[name]
    _unett_attention_check(dev, ucfg)

    # bf16 + kernels against fp32 + plain on a small input (the engine phase's check)
    rng = np.random.default_rng(3)
    pb, pn, pref = 2, 256, 64
    cond = torch.as_tensor(rng.standard_normal((pb, pn, 100)), dtype=torch.float32, device=dev)
    cl = torch.full((pb,), pref, dtype=torch.int32, device=dev)
    text_ids = torch.as_tensor(rng.integers(0, 90, (pb, 48)), dtype=torch.int32, device=dev)
    dur = torch.tensor([pn, pn - 40], dtype=torch.int32, device=dev)
    y0 = torch.as_tensor(rng.standard_normal((pb, pn, 100)), dtype=torch.float32, device=dev)
    sampler = SamplerConfig(steps=4, method="ralston", cfg_strength=2.0)
    with torch.no_grad():
        serving = sample_cfm(engine.dit_params, engine.dit_cfg, cond=cond, cond_lens=cl, text=text_ids, duration=dur,
                             sampler=sampler, y0=y0, compute_dtype=torch.bfloat16, **fns).float()
        p32 = unett_params_from_numpy(u_np, dev, torch.float32)
        ref = sample_cfm(p32, dataclasses.replace(ucfg, attn_impl="plain", conv_pos_impl="plain"), cond=cond,
                         cond_lens=cl, text=text_ids, duration=dur, sampler=sampler, y0=y0,
                         compute_dtype=torch.float32, **fns)
    gen = torch.zeros((pb, pn), dtype=torch.bool, device=dev)
    for r in range(pb):
        gen[r, pref : int(dur[r])] = True
    rmse = float(torch.sqrt(((serving - ref) ** 2 * gen[..., None]).sum() / (gen.sum() * 100)))
    log(f"E2-TTS parity: bf16 + kernels vs fp32 plain, mel RMSE over generated frames {rmse:.4f} (tol 0.5)")
    check(np.isfinite(rmse) and rmse < 0.5, f"E2-TTS serving path diverged from the plain path: {rmse}")
    del p32, engine
    torch.cuda.empty_cache()

    # the bench geometry, beside the F5 figure of this run
    e2 = bench_phase(dev, ucfg, voc_cfg, u_np, voc_np, tok, card, backbone="E2-TTS", fns=fns)
    for name, bench in (("E2-TTS", e2), ("F5-TTS", f5_bench)):
        ms = bench["device_ms"]
        busy = sum(ms.values())
        attn = ms.get("flash_attention", 0.0) + ms.get("rope_rows", 0.0)
        conv = ms.get("conv_pos", 0.0)
        log(f"{name} Base bench solve on {card}: {bench['audio_s_per_s']:.2f} audio-s/s, median {bench['median_s']:.4f} s; "
            f"kernels {busy:.1f} ms: attention {100 * attn / busy:.1f}%, conv-pos {100 * conv / busy:.1f}%, the rest "
            f"{100 * (busy - attn - conv) / busy:.1f}%; device idle {100 - 100 * busy / (1e3 * bench['median_s']):.1f}% "
            f"of the unprofiled median")
    log(f"E2-TTS phase took {time.perf_counter() - t_phase:.1f} s")


def _unett_attention_check(dev, ucfg) -> None:
    """The serving attention kernel at the UNetT's shape (the bench's 16 rows
    x 16 heads at n = 1024 + 1 time token, bf16, head-0 RoPE, a ragged key
    mask) against its fp32 plain version; device time per call in a CUDA graph
    beside SDPA's and the bound (none of these launches is counted)."""
    from f5tts_tpu_torch.ops.kernels.flash_attention import cos_sin_of, flash_attention, flash_attention_plain
    from f5tts_tpu_torch.ops.rope import apply_rotary_per_head, rotary_freqs

    b, h, n, d = 16, ucfg.heads, 1025, ucfg.dim_head
    g = torch.Generator(device="cpu").manual_seed(1025)
    q, k, v = _head_split(g, dev, torch.bfloat16, b, h, n, d)
    lens = torch.randint(n // 2, n + 1, (b,), generator=g).to(dev)
    lens[0] = n
    mask = torch.arange(n, device=dev)[None, :] < lens[:, None]
    freqs = torch.as_tensor(rotary_freqs(n, d), device=dev)
    trig = cos_sin_of(freqs)
    out = flash_attention(q, k, v, mask, rope_freqs=freqs, rope_cos_sin=trig)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), mask, freqs)
    err = float(((out.float() - ref).abs() * mask[:, None, :, None]).max())
    del ref
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    qr = torch.cat([apply_rotary_per_head(qc[:, :1], freqs), qc[:, 1:]], 1)
    kr = torch.cat([apply_rotary_per_head(kc[:, :1], freqs), kc[:, 1:]], 1)
    bias = torch.where(mask, 0.0, -1e30)[:, None, None, :].to(torch.bfloat16)
    ms = time_graph_ms([lambda: flash_attention(q, k, v, mask, rope_freqs=freqs, rope_cos_sin=trig)] * 20)
    ms_lib = time_graph_ms([lambda: F.scaled_dot_product_attention(qr, kr, vc, attn_mask=bias)] * 20)
    bms, by = bound_ms(4.0 * b * h * n * n * d, 4 * b * h * n * d * 2 + b * n + 2 * n * d * 4, PEAK_BF16_FLOPS)
    log(f"attention at the UNetT shape ({b} x {h} heads, n {n}, d {d}, bf16, head-0 RoPE, ragged keys): max abs err "
        f"on valid rows {err:.3e} (tol {ATTN_TOL}); graph {ms:.4f} ms a call, SDPA {ms_lib:.4f} ms, bound {bms:.4f} ms "
        f"({by})")
    check(np.isfinite(err) and err <= ATTN_TOL, f"flash_attention at the UNetT shape: error {err} > {ATTN_TOL}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def mmdit_phase(dev, tok, launches: dict) -> None:
    """One MMDiT forward at ``MMDiTConfig()`` (dim 1024, depth 22), bf16 with the
    conv-pos kernel, against fp32 + plain; exactly 1 conv-pos launch and no
    flash launch (its joint attention is the plain ``sdpa``, XLA in the JAX
    package)."""
    import dataclasses

    from f5tts_tpu_torch.models.convert import init_mmdit_numpy, mmdit_params_from_numpy
    from f5tts_tpu_torch.models.mmdit import MMDiTConfig, mmdit_forward
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos, conv_pos_plain
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm

    t_phase = time.perf_counter()
    cfg = MMDiTConfig(text_num_embeds=tok.vocab_size)
    m_np = init_mmdit_numpy(cfg, seed=0)
    b, n, nt = 2, 1024, 256
    rng = np.random.default_rng(5)
    x, cond = (torch.as_tensor(rng.standard_normal((b, n, 100)), dtype=torch.float32, device=dev) for _ in range(2))
    text = torch.as_tensor(rng.integers(0, tok.vocab_size, (b, nt)), dtype=torch.int32, device=dev)
    text[1, 200:] = -1
    time_ = torch.tensor([0.3, 0.8], device=dev)
    drop = torch.tensor([False, True], device=dev)
    mask = torch.arange(n, device=dev)[None, :] < torch.tensor([[n], [800]], device=dev)
    wrappers = {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos, "row_norm": row_norm}
    p16 = mmdit_params_from_numpy(m_np, dev, torch.bfloat16)
    with torch.no_grad():
        mmdit_forward(p16, cfg, x, cond, text, time_, drop, drop, mask, compute_dtype=torch.bfloat16)  # warm
        for w in wrappers.values():
            w.launches = 0
        out = mmdit_forward(p16, cfg, x, cond, text, time_, drop, drop, mask, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        got = {name: w.launches for name, w in wrappers.items()}
        ms = time_ms(lambda: mmdit_forward(p16, cfg, x, cond, text, time_, drop, drop, mask,
                                           compute_dtype=torch.bfloat16), iters=3, warmup=1)
        p32 = mmdit_params_from_numpy(m_np, dev, torch.float32)
        ref = mmdit_forward(p32, dataclasses.replace(cfg, conv_pos_impl="plain"), x, cond, text, time_, drop, drop,
                            mask)
    err = _rel_l2(out[mask], ref[mask])
    log(f"MMDiT (dim {cfg.dim}, depth {cfg.depth}, {sum(a.size for a in _leaves(m_np)) / 1e6:.1f} M params) one forward "
        f"of {b} x {n} frames + {nt} text tokens: launches {got} (want conv_pos 1, flash 0, row_norm {4 * cfg.depth}); "
        f"bf16 + kernel vs fp32 plain, relative L2 on valid rows {err:.3e} (tol {MMDIT_REL_L2}); {ms:.2f} ms a "
        f"forward (bf16)")
    # row norms: four a joint block (the two streams' AdaLN and MLP norms), three in the last, whose text stream
    # ends at its attention, and the output norm
    check(got == {"flash_attention": 0, "rope_rows": 0, "conv_pos": 1, "row_norm": 4 * cfg.depth},
          f"MMDiT launch counts {got}")
    check(bool(torch.isfinite(out).all()) and np.isfinite(err) and err <= MMDIT_REL_L2, f"MMDiT bf16 vs fp32: {err}")
    for name in ("conv_pos", "row_norm"):
        launches[name]["mmdit"] = got[name]
    del p16, p32

    # the conv-pos kernel as the MMDiT calls it (no mask) against its plain version; not counted
    w = m_np["audio_embed"]["conv_pos"]
    w1, b1, w2, b2 = (torch.as_tensor(a, device=dev, dtype=torch.bfloat16) for a in (
        w["conv1"]["w"], w["conv1"]["b"], w["conv2"]["w"], w["conv2"]["b"]))
    xc = (torch.randn((b, n, cfg.dim), generator=torch.Generator().manual_seed(14)) * 0.5).to(dev, torch.bfloat16)
    yc = conv_pos(xc, w1, b1, w2, b2)
    rc = conv_pos_plain(xc.float(), w1.float(), b1.float(), w2.float(), b2.float())
    cerr = float((yc.float() - rc).abs().max())
    cms = time_ms(lambda: conv_pos(xc, w1, b1, w2, b2))
    log(f"conv-pos kernel with no mask at the MMDiT shape ({b} x {n} x {cfg.dim}, bf16): max abs err {cerr:.3e} "
        f"(tol {CONV_TOL}), {cms:.4f} ms a call")
    check(np.isfinite(cerr) and cerr <= CONV_TOL, f"conv_pos without a mask: error {cerr} > {CONV_TOL}")
    torch.cuda.empty_cache()
    log(f"MMDiT phase took {time.perf_counter() - t_phase:.1f} s")


def bigvgan_phase(dev, dit_cfg, dit_np, tok, card: str, launches: dict) -> None:
    """``TTSEngine(vocoder_type="bigvgan")`` at F5-TTS Base + BigVGAN at full
    width with the ``bigvgan`` mel flavor: one request; then
    ``bigvgan_decode`` alone on a batch-8 x 1024-frame mel, bf16 and fp32."""
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.models.bigvgan import BigVGANConfig, bigvgan_decode
    from f5tts_tpu_torch.models.convert import bigvgan_params_from_numpy, init_bigvgan_numpy
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm
    from f5tts_tpu_torch.ops.mel import MelConfig

    t_phase = time.perf_counter()
    bcfg = BigVGANConfig()  # upsample_initial_channel 1536, rates 4,4,2,2,2,2
    b_np = init_bigvgan_numpy(bcfg, seed=2)
    engine = TTSEngine(dit_np, dit_cfg, b_np, tok, EngineConfig(mel=MelConfig(flavor="bigvgan"), vocoder_type="bigvgan",
                                                               bigvgan=bcfg), device=dev)
    solves = _count_solves(engine)
    wrappers = {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos, "row_norm": row_norm}
    for w in wrappers.values():
        w.launches = 0
    text, secs, f0, ref_text = BACKBONE_REQUESTS[0]
    plan = engine.prepare_request(text, synthetic_ref(secs, f0, 0), 24000, ref_text, seed=0)
    (wave,) = _request_waves(engine, BACKBONE_REQUESTS[:1], "BigVGAN")
    frames = sum(min(r.duration, 1024) - r.ref_frames for r in plan.rows)
    got = {name: w.launches for name, w in wrappers.items()}
    forwards = sum(f for f, _ in solves)
    want = {"flash_attention": dit_cfg.depth * forwards, "rope_rows": dit_cfg.depth * forwards, "conv_pos": forwards,
            "row_norm": (2 * dit_cfg.depth + 1) * forwards}
    log(f"BigVGAN engine ({sum(a.size for a in _leaves(b_np)) / 1e6:.1f} M vocoder params): {len(plan.rows)} row, "
        f"{frames} generated frames -> {len(wave)} samples (want {frames * 256}); launches {got} (want {want})")
    check(len(plan.rows) == 1 and len(wave) == frames * 256, "BigVGAN request: wrong wave length")
    check(got == want, f"BigVGAN engine launch counts {got}, want {want}")
    for name in wrappers:
        launches[name]["bigvgan"] = got[name]
    del engine
    torch.cuda.empty_cache()

    rng = np.random.default_rng(6)
    mel = torch.as_tensor(rng.standard_normal((8, 1024, 100)) * 2 - 5, dtype=torch.float32, device=dev)
    out = {}
    with torch.no_grad():
        for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            p = bigvgan_params_from_numpy(b_np, dev, dtype)
            out[name] = bigvgan_decode(p, mel, bcfg, compute_dtype=dtype)
            out[f"{name}_ms"] = time_ms(lambda p=p, dtype=dtype: bigvgan_decode(p, mel, bcfg, compute_dtype=dtype),
                                        iters=3, warmup=1)
            if dtype == torch.bfloat16:
                profile_by_family(f"one bigvgan_decode (bf16, 8 x 1024 frames) on {card}",
                                  lambda p=p: (bigvgan_decode(p, mel, bcfg, compute_dtype=torch.bfloat16),
                                               torch.cuda.synchronize()), BIGVGAN_FAMILIES)
            del p
    err = _rel_l2(out["bf16"], out["fp32"])
    secs = 8 * 1024 * 256 / 24000
    log(f"bigvgan_decode on {card}, batch 8 x 1024 frames ({secs:.2f} s of audio): fp32 {out['fp32_ms']:.2f} ms, "
        f"bf16 {out['bf16_ms']:.2f} ms ({secs / (out['bf16_ms'] / 1e3):.1f} audio-s/s); bf16 vs fp32 relative L2 "
        f"{err:.3e} (tol {BIGVGAN_REL_L2})")
    check(out["bf16"].shape == (8, 1024 * 256) and bool(torch.isfinite(out["bf16"]).all()), "bigvgan_decode bf16")
    check(np.isfinite(err) and err <= BIGVGAN_REL_L2, f"bigvgan_decode bf16 vs fp32: {err}")
    del out
    torch.cuda.empty_cache()
    log(f"BigVGAN phase took {time.perf_counter() - t_phase:.1f} s")


def torch_ckpt_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok) -> None:
    """Seeded F5-TTS Base and Vocos written as ``.pt`` files in the
    reference's torch layout (``export_*_state_dict``) and as ``.npz`` trees:
    ``ModelService`` and ``cli/infer.build_engine`` give the same wave from
    either, bit for bit."""
    import shutil
    import tempfile

    from f5tts_tpu_torch.cli import infer as cli
    from f5tts_tpu_torch.models.convert import export_f5_state_dict, export_vocos_state_dict, save_params_npz
    from f5tts_tpu_torch.serve.schemas import SpeechRequest
    from f5tts_tpu_torch.serve.service import ModelService
    from f5tts_tpu_torch.utils.config import Settings

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="f5_ckpt_")
    vocab = os.path.join(HERE, "examples", "vocab.txt")
    try:
        paths = {"pt": (os.path.join(tmp, "model.pt"), os.path.join(tmp, "vocos.pt")),
                 "npz": (os.path.join(tmp, "model.npz"), os.path.join(tmp, "vocos.npz"))}
        ema = {f"ema_model.{k}": torch.from_numpy(v) for k, v in export_f5_state_dict(dit_np, dit_cfg).items()}
        torch.save({"ema_model_state_dict": {**ema, "initted": torch.ones(1), "step": torch.ones(1)}}, paths["pt"][0])
        torch.save({k: torch.from_numpy(v) for k, v in export_vocos_state_dict(voc_np, voc_cfg).items()}, paths["pt"][1])
        del ema
        save_params_npz(paths["npz"][0], dit_np)
        save_params_npz(paths["npz"][1], voc_np)
        log(f"torch checkpoints: F5-TTS Base .pt {os.path.getsize(paths['pt'][0]) / 2**20:.0f} MiB, Vocos .pt "
            f"{os.path.getsize(paths['pt'][1]) / 2**20:.0f} MiB written in {time.perf_counter() - t_phase:.1f} s")
        served, built = {}, {}
        text = "A checkpoint read from the reference's torch layout."
        for kind, (model, vocoder) in paths.items():
            t0 = time.perf_counter()
            service = ModelService(Settings(device=dev.type, dtype="bfloat16", warmup=False, tts_ckpt=model,
                                            tts_vocab=vocab, vocoder_ckpt=vocoder))
            service.load()
            served[kind] = service.synthesize_sync(SpeechRequest(text=text, seed=11))
            service.unload()
            args = cli.build_argparser().parse_args(["-p", model, "--vocoder-ckpt", vocoder, "-v", vocab,
                                                     "--device", dev.type])
            engine = cli.build_engine(args)
            built[kind] = engine.synthesize(text, synthetic_ref(2.5, 140.0, 0), 24000, "A short reference clip.",
                                            seed=11)[0]
            del engine
            torch.cuda.empty_cache()
            log(f"torch checkpoints: {kind} through ModelService and cli/infer.build_engine in "
                f"{time.perf_counter() - t0:.1f} s ({len(served[kind])} WAV bytes, {len(built[kind])} samples)")
        check(served["pt"] == served["npz"], "ModelService: the .pt load's wave differs from the .npz load's")
        check(built["pt"].shape == built["npz"].shape and np.array_equal(built["pt"], built["npz"])
              and float(np.abs(built["pt"]).max()) > 0, "build_engine: the .pt load's wave differs from the .npz load's")
        log("torch checkpoints: the .pt loads give the .npz loads' waves bit for bit (service and CLI)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"torch checkpoint phase took {time.perf_counter() - t_phase:.1f} s")


def backbone_phases(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, launches: dict, f5_bench: dict) -> None:
    """Phases 13-16."""
    e2tts_phase(dev, voc_cfg, voc_np, tok, card, launches, f5_bench)
    mmdit_phase(dev, tok, launches)
    bigvgan_phase(dev, dit_cfg, dit_np, tok, card, launches)
    torch_ckpt_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok)


# ---------------------------------------------------------------------------
# step distillation (phase 17)
# ---------------------------------------------------------------------------

DISTILL_BUCKET, DISTILL_COND, DISTILL_BATCH, DISTILL_K, DISTILL_M = 1024, 128, 2, 8, 4
DISTILL_CLAIM = 0.8  # the student's K-step error to the fine guided solve, against its error at init (test_distill.py)
# bf16 kernels against fp32 plain on the same fp32 states and targets: at init the student is the teacher, so the
# residual pred - target is ~5% of the velocity and bf16's rounding of pred is a large share of it (the plain path in
# bf16 reads loss 1.0%, gradients 8.8% on the CPU at the parity geometry). The kernels' loss and updated params are
# held to TRAIN_GRAD_RTOL, their gradients to this factor times the bf16 plain path's reading in the same run (never
# tighter than TRAIN_GRAD_RTOL)
DISTILL_BF16_OVER_PLAIN = 1.5
DISTILL_STAGES = ("rollout", "teacher", "student", "update")
DISTILL_WRAPPERS = ("flash_attention", "rope_rows", "conv_pos", "flash_attention_train_fwd",
                    "flash_attention_train_bwd")
DISTILL_MICRO = dict(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2, mel_dim=8, text_num_embeds=16, text_dim=16,
                     conv_layers=1, max_pos=64)  # tests/test_distill.py's geometry


def _distill_wrappers() -> dict:
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train_bwd, flash_attention_train_fwd

    return {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos,
            "flash_attention_train_fwd": flash_attention_train_fwd,
            "flash_attention_train_bwd": flash_attention_train_bwd}


class _StageMeter:
    """The distill step's ``stage`` hook: a CUDA event and each wrapper's
    launch count at the end of every stage, and the rows of every DiT
    forward the step makes."""

    def __init__(self, wrappers: dict):
        self.wrappers = wrappers
        self.reset()

    def reset(self):
        self.events, self.counts, self.rows = [], [], []
        self.mark("start")

    def mark(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))
        self.counts.append((name, {k: w.launches for k, w in self.wrappers.items()}))

    def split(self) -> tuple[dict, dict]:
        """``(ms by stage, launches by stage)``; call after a synchronize."""
        ms = {b[0]: a[1].elapsed_time(b[1]) for a, b in zip(self.events, self.events[1:])}
        counts = {b[0]: {k: b[1][k] - a[1][k] for k in b[1]} for a, b in zip(self.counts, self.counts[1:])}
        return ms, counts


def _counting_forward(meter: _StageMeter, forward):
    def fwd(*a, **kw):
        meter.rows.append(a[2].shape[0])
        if kw.get("training"):
            meter.train_mask = a[8]  # the key mask of the student's gradient forward
        return forward(*a, **kw)

    return fwd


def distill_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, launches: dict) -> None:
    """Phase 17: ``make_distill_step`` at F5-TTS Base (the seeded teacher of the
    other phases) with exact launches per stage, the split and profile of a
    step, a single-branch teacher step, bf16 + kernels against fp32 + plain,
    the distillation claim at the JAX test's micro geometry, the student
    served through the engine, and ``distill_certify.run`` at a reduced tiny
    size."""
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.models.convert import dit_params_from_numpy
    from f5tts_tpu_torch.models.dit import dit_forward
    from f5tts_tpu_torch.scripts import distill_certify
    from f5tts_tpu_torch.train import distill as tdist
    from f5tts_tpu_torch.train.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    wrappers = _distill_wrappers()
    meter = _StageMeter(wrappers)
    tdist.dit_forward = _counting_forward(meter, dit_forward)  # records each forward's rows; the kernels are untouched
    try:
        student = _distill_base_steps(dev, dit_cfg, dit_np, tok, card, launches, meter, wrappers, tdist)
        _distill_masked_attention_check(dev, meter.train_mask, card)
        _distill_parity(dev, tok, tdist, tree_leaves)
    finally:
        tdist.dit_forward = dit_forward

    # the distillation claim on the card, at the JAX test's micro geometry
    from f5tts_tpu_torch.models.convert import init_dit_numpy
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm, sample_noise_from_seeds

    micro = DiTConfig(**DISTILL_MICRO, attn_impl="plain")  # head dim 16: the attention kernels take 32, 64 and 128
    n, ref = 32, 8

    def micro_prompts(rng, batch=2):
        cond = np.zeros((batch, n, 8), np.float32)
        cond[:, :ref] = rng.standard_normal((batch, ref, 8)) * 0.5
        return {"cond": cond, "cond_lens": np.full((batch,), ref, np.int32),
                "text": rng.integers(0, 16, (batch, 6)).astype(np.int32),
                "duration": rng.integers(24, n + 1, (batch,)).astype(np.int32),
                "seeds": rng.integers(0, 1 << 30, (batch,)).astype(np.int32)}

    t0 = time.perf_counter()
    dcfg = tdist.DistillConfig(student_steps=4, substeps=4, learning_rate=3e-4, lr_decay_steps=40, seed=3)
    m_teacher = dit_params_from_numpy(init_dit_numpy(micro, seed=0), dev, torch.float32)
    conv_before = wrappers["conv_pos"].launches
    m_student = tdist.distill(m_teacher, micro, dcfg, micro_prompts, steps=40, logger=None, device=dev)
    conv_micro = wrappers["conv_pos"].launches - conv_before
    ev = micro_prompts(np.random.default_rng(999))
    kw = {k: torch.as_tensor(ev[k], device=dev) for k in ("cond", "cond_lens", "text", "duration")}
    y0 = sample_noise_from_seeds(ev["seeds"], n, 8, kw["duration"])
    fine = sample_cfm(m_teacher, micro, sampler=SamplerConfig(steps=64, cfg_strength=2.0), y0=y0, **kw)
    gen = torch.zeros((2, n), dtype=torch.bool, device=dev)
    for r in range(2):
        gen[r, ref : int(ev["duration"][r])] = True

    def err_to_fine(params):
        got = sample_cfm(params, micro, sampler=tdist.student_sampler(dcfg), y0=y0, **kw)
        return float(torch.sqrt(((fine - got) ** 2)[gen].mean()))

    e_student, e_init = err_to_fine(m_student), err_to_fine(m_teacher)
    log(f"distillation claim at the micro geometry (dim 32, depth 1, head dim 16: plain attention, the conv-pos "
        f"kernels ran {conv_micro} times): 40 steps of K=4 m=4 in {time.perf_counter() - t0:.1f} s; student error "
        f"to the 64-step guided solve {e_student:.5f} against {e_init:.5f} at init = {e_student / e_init:.3f}x "
        f"(want < {DISTILL_CLAIM})")
    check(np.isfinite(e_student) and e_student < DISTILL_CLAIM * e_init, f"micro distillation: {e_student} vs {e_init}")
    check(conv_micro > 0, "the micro distillation ran no conv-pos kernel")

    # the distilled Base student served through the engine: K Euler forwards, no CFG pair
    s_np = tree_map(lambda t: t.detach().float().cpu().numpy(), student)
    del student
    torch.cuda.empty_cache()
    engine = TTSEngine(s_np, dit_cfg, voc_np, tok, EngineConfig(
        vocoder=voc_cfg, sampler=tdist.student_sampler(tdist.DistillConfig(student_steps=DISTILL_K))), device=dev)
    solves = []
    program = engine.bucket_program

    def counted(*a, **kw_):
        solves.append((kw_["steps"], kw_["cfg_strength"], a[0].shape[0]))
        return program(*a, **kw_)

    engine.bucket_program = counted
    for w in wrappers.values():
        w.launches = 0
    text, secs, f0, ref_text = BACKBONE_REQUESTS[0]
    _request_waves(engine, [(text, secs, f0, ref_text)], "distilled student")
    got = {k: wrappers[k].launches for k in ("flash_attention", "rope_rows", "conv_pos")}
    forwards = sum(steps for steps, _, _ in solves)
    want = {"flash_attention": dit_cfg.depth * forwards, "rope_rows": dit_cfg.depth * forwards, "conv_pos": forwards}
    log(f"distilled student served: solves (steps, cfg, rows) {solves}; launches {got} (want {want}: "
        f"{DISTILL_K} x ({dit_cfg.depth} + {dit_cfg.depth} + 1) a solve)")
    check(len(solves) == 1 and solves[0][:2] == (DISTILL_K, 0.0), f"student solves {solves}")
    check(got == want and forwards == DISTILL_K, f"student serving launches {got}, want {want}")
    del engine, s_np
    torch.cuda.empty_cache()

    # the certification script at a reduced tiny size
    t0 = time.perf_counter()
    res = distill_certify.run(geometry="tiny", toy_train_steps=100, student_steps=8, substeps=4, distill_steps=40,
                              distill_batch=4, prompts=4, device=dev, log=None)
    rows = [(r["name"], r["forwards"], round(r["mel_l2"], 5), round(r["x_recipe_err"], 3)) for r in res["rows"]]
    log(f"distill_certify.run (tiny, toy-train 100, K 8, m 4, 40 distill steps, 4 prompts) in "
        f"{time.perf_counter() - t0:.1f} s: recipe error to truth {res['recipe_err']:.5f}; rows "
        f"(name, forwards, mel-L2, x recipe) {rows}")
    check(len(res["rows"]) == 3 and all(np.isfinite(r["mel_l2"]) and np.isfinite(r["mcd_db"]) for r in res["rows"]),
          f"distill_certify rows {res['rows']}")
    log(f"distillation phase took {time.perf_counter() - t_phase:.1f} s on {card}")


def _distill_base_steps(dev, dit_cfg, dit_np, tok, card, launches, meter, wrappers, tdist):
    """Three steps of the CFG-pair teacher and one of a single-branch teacher
    at F5-TTS Base, bucket 1024, bf16; returns the student."""
    import dataclasses

    from f5tts_tpu_torch.models.convert import dit_params_from_numpy
    from f5tts_tpu_torch.scripts.distill_certify import make_prompt_fn
    from f5tts_tpu_torch.train.tree import tree_leaves

    b, K, m, depth = DISTILL_BATCH, DISTILL_K, DISTILL_M, dit_cfg.depth
    kc = max(c for c in range(1, K + 1) if K % c == 0 and c * b <= 16)  # distill_certify's auto chunk
    dcfg = tdist.DistillConfig(student_steps=K, substeps=m, loss_chunk=0 if kc >= K else kc)
    optimizer, step = tdist.make_distill_step(dit_cfg, dcfg, torch.bfloat16)
    t0 = time.perf_counter()
    teacher = dit_params_from_numpy(dit_np, dev, torch.float32)
    frozen = {k: t.clone() for k, t in tree_leaves(teacher)}
    student = tdist.copy_params(teacher, dev)
    opt_state = optimizer.init(student)
    watch = {k: t.detach().clone() for k, t in tree_leaves(student)}
    log(f"distill state at Base (teacher, student, AdamW) in {time.perf_counter() - t0:.1f} s; loss chunk "
        f"{dcfg.loss_chunk or K} of K = {K} ({(dcfg.loss_chunk or K) * b} gradient rows)")
    prompt_fn = make_prompt_fn(dit_cfg, b, DISTILL_BUCKET, DISTILL_COND)
    rng = np.random.default_rng(0)
    batches = [prompt_fn(rng) for _ in range(3)]
    serving_fwd = K + 2 * K * m
    want_stage = {
        "rollout": {"flash_attention": depth * K, "rope_rows": depth * K, "conv_pos": K},
        "teacher": {"flash_attention": depth * 2 * K * m, "rope_rows": depth * 2 * K * m, "conv_pos": 2 * K * m},
        "student": {"flash_attention_train_fwd": 2 * depth, "flash_attention_train_bwd": 2 * depth, "conv_pos": 1},
        "update": {},
    }
    want_rows = [b] * K + [2 * b] * (2 * K * m) + [(dcfg.loss_chunk or K) * b] * (K // (dcfg.loss_chunk or K))
    for w in wrappers.values():
        w.launches = 0
    times, splits = [], []
    for i, batch in enumerate(batches):
        meter.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_step = time.perf_counter()
        metrics = step(student, opt_state, teacher, batch, stage=meter.mark)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t_step
        ms, counts = meter.split()
        counts = {st: {k: v for k, v in c.items() if v} for st, c in counts.items()}
        times.append(dt)
        splits.append(ms)
        log(f"distill step {i + 1} (Base, b {b}, bucket {DISTILL_BUCKET}, K {K}, m {m}, bf16): loss {loss:.5f}, grad "
            f"norm {gnorm:.4f}, {dt:.3f} s; ms by stage {{{', '.join(f'{k}: {v:.1f}' for k, v in ms.items())}}}; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches by stage {counts}")
        check(np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0, f"distill step {i + 1}: {loss}, {gnorm}")
        check(all(counts[st] == {k: v for k, v in want_stage[st].items() if v} for st in DISTILL_STAGES),
              f"distill step {i + 1}: launches by stage {counts}, want {want_stage}")
        check(meter.rows == want_rows, f"distill step {i + 1}: rows of each forward {meter.rows}, want {want_rows}")
    for name, w in wrappers.items():
        launches[name]["distill"] = w.launches
    total = {k: wrappers[k].launches // len(batches) for k in wrappers}
    log(f"distill launches per step {total} = serving kernels on {serving_fwd} forwards (K + 2Km; "
        f"{depth} + {depth} + 1 each), the training kernels and one masked differentiable conv-pos on the gradient "
        f"forward")
    moved = sum(not torch.equal(watch[k], t.detach()) for k, t in tree_leaves(student))
    unchanged = all(torch.equal(frozen[k], t) for k, t in tree_leaves(teacher))
    log(f"student: {moved} of {len(watch)} leaves moved over {len(batches)} steps; teacher bit-unchanged: {unchanged}")
    check(moved == len(watch), "some student leaves did not move")
    check(unchanged, "the teacher's tensors changed")
    del watch, frozen
    steady = times[1:]
    med = statistics.median(steady)
    split_med = {st: statistics.median(s[st] for s in splits[1:]) for st in DISTILL_STAGES}
    log(f"distill step at Base on {card}: wall {[round(t, 4) for t in times]} s (first warms up), median of the "
        f"later {med:.4f} s; device ms by stage (CUDA events, median): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split_med.items()))
    profile_by_family("one distill step (Base, K 8, m 4, b 2, bf16)",
                      lambda: (step(student, opt_state, teacher, batches[0]), torch.cuda.synchronize()),
                      (*BENCH_FAMILIES[:3], ("flash_attention_train_fwd", ("fwd_lse",)),
                       ("flash_attention_train_bwd", ("bwd_wgmma",))), top=8, device_only=True, wall_plain_ms=med * 1e3)

    # one step with a single-branch teacher (a distilled student as the teacher): b-row teacher forwards
    s_cfg = dataclasses.replace(dcfg, teacher_single_branch=True)
    _, s_step = tdist.make_distill_step(dit_cfg, s_cfg, torch.bfloat16)
    meter.reset()
    torch.cuda.synchronize()
    t_step = time.perf_counter()
    metrics = s_step(student, opt_state, teacher, batches[1], stage=meter.mark)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_step
    ms, counts = meter.split()
    want_single = [b] * K + [b] * (2 * K * m) + want_rows[K + 2 * K * m:]
    log(f"distill step with a single-branch teacher: loss {loss:.5f}, {dt:.3f} s; ms by stage "
        f"{{{', '.join(f'{k}: {v:.1f}' for k, v in ms.items())}}}; teacher forwards of {b} rows")
    check(np.isfinite(loss) and meter.rows == want_single, f"single-branch step: loss {loss}, rows {meter.rows}")
    check(counts["teacher"]["flash_attention"] == depth * 2 * K * m, f"single-branch teacher launches {counts}")
    del teacher, opt_state
    torch.cuda.empty_cache()
    return student


def _distill_masked_attention_check(dev, key_mask, card: str) -> None:
    """The training attention kernels under the key mask of the Base distill
    step's gradient forward (16 rows of the prompts' ragged durations, K-fold),
    its last row's keys all masked, at 16 heads of 64, bf16: o, lse, dq, dk,
    dv against the fp32 plain versions with the unmasked rows' tolerances,
    the ragged rows and the dead row each on its own scale."""
    from f5tts_tpu_torch.ops.kernels import flash_attention_train as ft

    h, d = 16, 64
    mask = key_mask.clone()
    mask[-1] = False
    b, n = mask.shape
    g = torch.Generator(device="cpu").manual_seed(17)
    q, k = (torch.randn((b, h, n, d), generator=g).to(dev, torch.bfloat16) for _ in range(2))
    v, do = _head_split(g, dev, torch.bfloat16, b, h, n, d)[:2]
    o, lse = ft.flash_attention_train_fwd(q, k, v, mask)
    grads = ft.flash_attention_train_bwd(q, k, v, o, lse, do, mask)
    f32 = [t.float() for t in (q, k, v, do)]
    ref_o, ref_lse = ft.flash_attention_train_fwd_plain(*f32[:3], mask)
    refs = ft.flash_attention_train_bwd_plain(*f32[:3], ref_o, ref_lse, f32[3], mask)
    torch.cuda.synchronize()
    lens = [int(x) for x in mask.sum(-1)]
    for what, rows in (("ragged rows", slice(0, b - 1)), ("all-masked row", slice(b - 1, b))):
        err_o = float((o[rows].float() - ref_o[rows]).abs().max())
        err_lse = float((lse[rows] - ref_lse[rows]).abs().max())
        rels = [_rel_err(got[rows], ref[rows]) for got, ref in zip(grads, refs)]
        log(f"train attention under the distill step's key mask ({b} x {h} x {n} x {d} bf16, valid keys per row "
            f"{lens}), {what}: o err {err_o:.3e} (tol {ATTN_TOL}), lse err {err_lse:.3e} (tol {LSE_TOL}), dq/dk/dv "
            f"relative {rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e} (tol {GRAD_TOL})")
        check(np.isfinite(err_o) and err_o <= ATTN_TOL, f"masked train forward o error ({what}) {err_o}")
        check(np.isfinite(err_lse) and err_lse <= LSE_TOL, f"masked train forward lse error ({what}) {err_lse}")
        check(all(np.isfinite(rels)) and max(rels) <= GRAD_TOL, f"masked train backward error ({what}) {rels}")
    del ref_o, ref_lse, refs, f32
    fwd_ms = time_ms(lambda: ft.flash_attention_train_fwd(q, k, v, mask))
    bwd_ms = time_ms(lambda: ft.flash_attention_train_bwd(q, k, v, o, lse, do, mask))
    fwd0 = time_ms(lambda: ft.flash_attention_train_fwd(q, k, v))
    bwd0 = time_ms(lambda: ft.flash_attention_train_bwd(q, k, v, o, lse, do))
    log(f"train attention at the distill gradient shape on {card}: masked forward {fwd_ms:.4f} ms, backward "
        f"{bwd_ms:.4f} ms; with no mask {fwd0:.4f} / {bwd0:.4f} ms (eager, one call each)")
    del q, k, v, do, o, lse, grads
    torch.cuda.empty_cache()


def _distill_parity(dev, tok, tdist, tree_leaves) -> None:
    """The student's gradient half of a distill step through the kernels
    against the plain path, at K 8, m 4 on the sway grid and a small
    geometry: both differentiate the loss on the same states and targets
    (one fp32 plain rollout and teacher solve), from the same params. Held:
    fp32 kernels against fp32 plain, and bf16 kernels against fp32 plain
    beside the bf16 plain path's reading (bf16's own rounding). Printed: the
    whole bf16 step, its own rollout and teacher included, against the fp32
    step."""
    import dataclasses

    from f5tts_tpu_torch.models.convert import dit_params_from_numpy, init_dit_numpy
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.scripts.distill_certify import make_prompt_fn

    small = DiTConfig(dim=256, depth=2, heads=4, dim_head=64, text_num_embeds=tok.vocab_size, text_dim=128,
                      conv_layers=1)
    plain = dataclasses.replace(small, attn_impl="plain", conv_pos_impl="plain")
    teacher = dit_params_from_numpy(init_dit_numpy(small, seed=3), dev, torch.float32)
    batch = make_prompt_fn(small, 2, 256, 64)(np.random.default_rng(4))
    dcfg = tdist.DistillConfig(student_steps=DISTILL_K, substeps=DISTILL_M)
    ctx = tdist.make_distill_step(plain, dcfg, torch.float32)[1].targets(tdist.copy_params(teacher, dev), teacher,
                                                                          batch)

    def half_step(cfg, dtype):
        optimizer, step = tdist.make_distill_step(cfg, dcfg, dtype)
        student = tdist.copy_params(teacher, dev)
        loss, grads = step.gradients(student, ctx)
        grads = {k: g.float().clone() for (k, _), g in zip(tree_leaves(student), grads)}
        optimizer.update(student, list(grads.values()), optimizer.init(student))
        return float(loss), grads, {k: t.detach().float() for k, t in tree_leaves(student)}

    def full_step(cfg, dtype):
        optimizer, step = tdist.make_distill_step(cfg, dcfg, dtype)
        student = tdist.copy_params(teacher, dev)
        m = step(student, optimizer.init(student), teacher, batch)
        return float(m["loss"]), {k: t.detach().float() for k, t in tree_leaves(student)}

    def rel(a, b):
        num = sum(float(torch.sum((a[k] - b[k]) ** 2)) for k in b)
        return (num / sum(float(torch.sum(b[k] ** 2)) for k in b)) ** 0.5

    def errs(got, ref):
        (l1, g1, p1), (l0, g0, p0) = got, ref
        check(set(g1) == set(g0) == set(p0), "distill parity: the gradient leaves differ")
        return abs(l1 - l0) / abs(l0), rel(g1, g0), rel(p1, p0)

    where = "dim 256, depth 2, 4 x 64 heads, 2 x 256 frames, K 8, m 4, sway grid, shared fp32 targets"
    ref = half_step(plain, torch.float32)
    e32 = errs(half_step(small, torch.float32), ref)
    e_plain = errs(half_step(plain, torch.bfloat16), ref)
    e_bf16 = errs(half_step(small, torch.bfloat16), ref)
    bound = max(TRAIN_GRAD_RTOL, DISTILL_BF16_OVER_PLAIN * e_plain[1])
    for what, e, tol in (("fp32 kernels vs fp32 plain", e32, f"tol {TRAIN_GRAD_RTOL} each"),
                         ("bf16 plain vs fp32 plain (bf16's own rounding)", e_plain, "the reading the next is held to"),
                         ("bf16 kernels vs fp32 plain", e_bf16,
                          f"tol {TRAIN_GRAD_RTOL} on the loss and params, {bound:.3e} on the gradients")):
        log(f"distill gradient parity, {what} ({where}): loss relative {e[0]:.3e}, gradients relative L2 "
            f"{e[1]:.3e}, updated params relative L2 {e[2]:.3e} ({tol})")
    check(max(e32) <= TRAIN_GRAD_RTOL, f"distill parity (fp32 kernels): {e32}")
    check(max(e_bf16[0], e_bf16[2]) <= TRAIN_GRAD_RTOL and e_bf16[1] <= bound,
          f"distill parity (bf16 kernels): {e_bf16}")
    (l1, p1), (l0, p0) = full_step(small, torch.bfloat16), full_step(plain, torch.float32)
    log(f"distill step, bf16 kernels vs fp32 plain, each with its own rollout and teacher solves (printed only): "
        f"loss {l1:.6f} vs {l0:.6f} (relative {abs(l1 - l0) / abs(l0):.3e}), updated params relative L2 "
        f"{rel(p1, p0):.3e}")


# ---------------------------------------------------------------------------
# multi-device (phase 18)
# ---------------------------------------------------------------------------

PAR_SOLVE_BATCH, PAR_SOLVE_NFE = 2, 20  # (b): the TP solve's rows (its all_reduces cross host memory over gloo)
PAR_TP_MEL_REL = 5e-2  # (b): bf16 TP solve vs mesh-free bf16 solve, relative L2 of the mel (other bf16 solves: 5e-2)
PAR_FWD_REL = 1e-4  # (b): fp32 TP forward vs mesh-free fp32 forward, relative L2
PAR_TRAIN_BATCH = (4, 1024)  # (c): rows x frames of the reduced train batch
PAR_TRAIN_LR, PAR_TRAIN_CLIP = 1e-4, 1e-2
PAR_LOSS_RTOL = 1e-5  # (c): loss of a sharded step vs the mesh-free step, fp32
PAR_PARAM_ATOL = 1e-2 * PAR_TRAIN_LR  # (c): AdamW's g / (|g| + eps) magnifies gradient rounding near eps
PAR_RING = (2, 16, 4096, 64, 4)  # (d), (f): b, h, n, d, p
PAR_RING_GRAD_REL = 3e-2  # (f): bf16 ring backward (p, dS and each hop's dq/dk/dv rounded to bf16) vs fp32 autograd
PAR_MMDIT_REL = 1e-4  # (g): fp32 MMDiT forward at TP 2 vs mesh-free, relative L2 (the DiT's PAR_FWD_REL)
PAR_MMDIT_TRAIN_BATCH = (2, 1024)  # (g): rows x frames of the MMDiT step's reduced batch


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _par_solve_inputs(dev, batch: int, n: int = 1024, ref_frames: int = 128, text_pad: int = 512):
    rng = np.random.default_rng(0)
    return (torch.as_tensor(rng.standard_normal((batch, n, 100)), dtype=torch.float32, device=dev),
            torch.full((batch,), ref_frames, dtype=torch.int32, device=dev),
            torch.as_tensor(rng.integers(0, 90, (batch, text_pad)), dtype=torch.int32, device=dev),
            torch.full((batch,), n, dtype=torch.int32, device=dev), np.arange(batch))


def _par_engine(dit_cfg, voc_cfg, dit_np, voc_np, tok, dev, batch: int, mesh=None, dtype: str = "bfloat16",
                quantization: str = "none"):
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine

    return TTSEngine(dit_np, dit_cfg, voc_np, tok, EngineConfig(
        vocoder=voc_cfg, duration_buckets=(1024,), batch_buckets=(batch,), text_pad=512, compute_dtype=dtype,
        quantization=quantization), device=dev, mesh=mesh)


def _par_solve(engine, inputs, nfe: int):
    from f5tts_tpu_torch.sampling.euler import nfe_to_steps

    mel, wave = engine.bucket_program(*inputs, steps=nfe_to_steps(nfe, "ralston"), cfg_strength=2.0)
    torch.cuda.synchronize()
    return mel.float(), wave.float()


def _par_forwards(nfe: int) -> int:
    """Fused CFG-pair DiT forwards of a Ralston solve at ``nfe`` (two a step)."""
    from f5tts_tpu_torch.sampling.euler import nfe_to_steps

    return 2 * nfe_to_steps(nfe, "ralston")


def _serving_wrappers() -> dict:
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows

    return {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos}


def _int8_tp_wrappers() -> dict:
    from f5tts_tpu_torch.ops.kernels.quant_matmul import quant_matmul, rescale_rows, row_amax

    return {**_serving_wrappers(), "quant_matmul": quant_matmul, "row_amax": row_amax, "rescale_rows": rescale_rows}


def _int8_tp_want(rank: int, forwards: int, model_parallel: int) -> dict:
    """Launches of an int8 solve per rank: per DiT forward 22 x 6 quant_matmul
    (one a linear), 22 x 2 row_amax and rescale_rows (the row-parallel
    to_out and ff.out, under TP only), 22 attention, 22 RoPE pre-passes on
    model rank 0, 1 conv-pos pair."""
    tp = model_parallel > 1
    return {"flash_attention": 22 * forwards, "rope_rows": (22 if rank == 0 else 0) * forwards,
            "conv_pos": forwards, "quant_matmul": 22 * QUANTIZED_LINEARS * forwards,
            "row_amax": (44 if tp else 0) * forwards, "rescale_rows": (44 if tp else 0) * forwards}


def _par_mmdit_inputs(dev, vocab: int):
    """(g)'s forward inputs: 2 x 1024 frames + 256 text tokens (one row's
    text padded from 200), one row's frames valid to 800, one row's drops."""
    rng = np.random.default_rng(5)
    x, cond = (torch.as_tensor(rng.standard_normal((2, 1024, 100)), dtype=torch.float32, device=dev) for _ in range(2))
    text = torch.as_tensor(rng.integers(0, vocab, (2, 256)), dtype=torch.int32, device=dev)
    text[1, 200:] = -1
    drop = torch.tensor([False, True], device=dev)
    mask = torch.arange(1024, device=dev)[None, :] < torch.tensor([[1024], [800]], device=dev)
    return x, cond, text, torch.tensor([0.3, 0.8], device=dev), drop, drop, mask


def _train_wrappers() -> dict:
    from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train_bwd, flash_attention_train_fwd

    return {"flash_attention_train_fwd": flash_attention_train_fwd,
            "flash_attention_train_bwd": flash_attention_train_bwd}


def _par_train_cfgs(dit_cfg, optimizer: str):
    from f5tts_tpu_torch.models.cfm import CFMConfig
    from f5tts_tpu_torch.train.ema import EMAConfig
    from f5tts_tpu_torch.train.trainer import TrainConfig

    # update_after_step -1: the EMA moves on the first step (decay 0.37)
    return CFMConfig(model=dit_cfg), TrainConfig(
        learning_rate=PAR_TRAIN_LR, warmup_updates=0, total_updates=100, grad_clip=PAR_TRAIN_CLIP,
        ema=EMAConfig(update_after_step=-1, update_every=1), optimizer=optimizer)


def _par_worker(rank: int, world: int, out_dir: str) -> None:
    """(b) and (c) on one rank of two processes sharing the card over gloo
    (spawned by ``dryrun.spawn``, which starts the gloo group)."""
    sys.path.insert(0, HERE)
    from f5tts_tpu_torch.models.convert import dit_params_from_numpy, init_dit_numpy, init_vocos_numpy
    from f5tts_tpu_torch.models.dit import DiTConfig, dit_forward
    from f5tts_tpu_torch.models.vocos import VocosConfig
    from f5tts_tpu_torch.parallel.mesh import build_mesh
    from f5tts_tpu_torch.parallel.sharding import shard_params, unshard_params
    from f5tts_tpu_torch.text.tokenizer import Tokenizer
    from f5tts_tpu_torch.train.data import synthetic_packed_batch
    from f5tts_tpu_torch.train.trainer import Trainer, init_train_state
    from f5tts_tpu_torch.train.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)  # both ranks on the one card
    torch.cuda.set_device(dev)
    tp_mesh, dp_mesh = build_mesh(2, device=dev), build_mesh(1, device=dev)  # (1, 2) and (2, 1)
    tok = Tokenizer.from_file(os.path.join(HERE, "examples", "vocab.txt"))
    dit_cfg, voc_cfg = DiTConfig(text_num_embeds=tok.vocab_size), VocosConfig()
    dit_np, voc_np = init_dit_numpy(dit_cfg, seed=0), init_vocos_numpy(voc_cfg, seed=1)
    out = {}

    # (b) the bf16 TP solve with its launch counts, and one fp32 forward
    engine = _par_engine(dit_cfg, voc_cfg, dit_np, voc_np, tok, dev, PAR_SOLVE_BATCH, mesh=tp_mesh)
    inputs = _par_solve_inputs(dev, PAR_SOLVE_BATCH)
    _par_solve(engine, inputs, 2)  # warm up (cuBLAS, the kernels' first calls)
    wrappers = _serving_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    mel, wave = _par_solve(engine, inputs, PAR_SOLVE_NFE)
    out["solve_s"] = time.perf_counter() - t0
    out["solve_launches"] = {k: w.launches for k, w in wrappers.items()}
    out["mel"], out["wave"] = mel.cpu().numpy(), wave.cpu().numpy()
    del engine
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((2, 1024, 100)), dtype=torch.float32, device=dev)
    text = torch.as_tensor(rng.integers(0, 90, (2, 256)), dtype=torch.int32, device=dev)
    t, f = torch.tensor([0.3, 0.8], device=dev), torch.zeros((2,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        p32 = shard_params(dit_params_from_numpy(dit_np, dev, torch.float32), tp_mesh)
        out["fwd32"] = dit_forward(p32, dit_cfg, x, x, text, t, f, f, tp=tp_mesh["model"]).cpu().numpy()
    del p32
    torch.cuda.empty_cache()

    # (e) the int8 TP solve (sharded, then quantized) with its launch counts
    engine = _par_engine(dit_cfg, voc_cfg, dit_np, voc_np, tok, dev, PAR_SOLVE_BATCH, mesh=tp_mesh,
                         quantization="int8")
    _par_solve(engine, inputs, 2)  # warm up
    wrappers = _int8_tp_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    mel, wave = _par_solve(engine, inputs, PAR_SOLVE_NFE)
    out["int8"] = {"s": time.perf_counter() - t0, "launches": {k: w.launches for k, w in wrappers.items()},
                   "mel": mel.cpu().numpy(), "wave": wave.cpu().numpy()}
    del engine, mel, wave
    torch.cuda.empty_cache()

    # (c) one fp32 Base step per case; rank 0 holds each against the mesh-free step
    rows, frames = PAR_TRAIN_BATCH
    batch = synthetic_packed_batch(dit_cfg, frames, rows, seed=7)
    twrap = _train_wrappers()
    refs = {}
    for case, mesh, opt in (("tp_adamw", tp_mesh, "adamw"), ("dp_adamw", dp_mesh, "adamw"),
                            ("tp_adafactor", tp_mesh, "adafactor")):
        model_cfg, train_cfg = _par_train_cfgs(dit_cfg, opt)
        trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, mesh=mesh)
        state = trainer.shard(init_train_state(model_cfg, train_cfg, dev, dit_np))
        for w in twrap.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(state, batch).items()}
        torch.cuda.synchronize()
        res = {"s": time.perf_counter() - t0, "launches": {k: w.launches for k, w in twrap.items()},
               "metrics": metrics}
        whole = {k: unshard_params(state[k], mesh) for k in ("params", "ema")}
        del state, trainer
        if rank == 0:
            if opt not in refs:  # the mesh-free step on the same global batch
                ref_trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device=dev)
                ref_state = init_train_state(model_cfg, train_cfg, dev, dit_np)
                ref_metrics = {k: float(v) for k, v in ref_trainer.step(ref_state, batch).items()}
                refs[opt] = (ref_metrics, {k: ref_state[k] for k in ("params", "ema")})
                del ref_state, ref_trainer
            ref_metrics, ref_whole = refs[opt]
            res["ref_metrics"] = ref_metrics
            worst = {}
            for part in ("params", "ema"):
                for (name, a), (_, b) in zip(tree_leaves(whole[part]), tree_leaves(ref_whole[part])):
                    d = float((a.detach() - b.detach()).abs().max())
                    key = "key_bias" if name.endswith("to_k/b") else part
                    worst[key] = max(worst.get(key, 0.0), d)
            res["max_abs_diff"] = worst
        out[case] = res
        del whole
        torch.cuda.empty_cache()
    del refs

    # (g) the MMDiT at full width under TP 2: one fp32 forward, one fp32 step on a reduced batch
    out["mmdit"] = _par_mmdit_worker(rank, dev, tp_mesh, tok)
    with open(os.path.join(out_dir, f"par_{rank}.pkl"), "wb") as fh:
        import pickle

        pickle.dump(out, fh)


def _par_mmdit_worker(rank: int, dev, tp_mesh, tok) -> dict:
    """(g) on one rank of the spawn: the forward's output, launches, and the
    step's metrics; rank 0 also runs the mesh-free step and compares."""
    from f5tts_tpu_torch.models.convert import init_mmdit_numpy, mmdit_params_from_numpy
    from f5tts_tpu_torch.models.mmdit import MMDiTConfig, mmdit_forward
    from f5tts_tpu_torch.parallel.sharding import shard_params, unshard_params
    from f5tts_tpu_torch.train.data import synthetic_packed_batch
    from f5tts_tpu_torch.train.trainer import Trainer, init_train_state
    from f5tts_tpu_torch.train.tree import tree_leaves

    mcfg = MMDiTConfig(text_num_embeds=tok.vocab_size)
    m_np = init_mmdit_numpy(mcfg, seed=0)
    wrappers = {**_serving_wrappers(), **_train_wrappers()}
    res = {}
    with torch.no_grad():
        params = shard_params(mmdit_params_from_numpy(m_np, dev, torch.float32), tp_mesh)
        for w in wrappers.values():
            w.launches = 0
        y = mmdit_forward(params, mcfg, *_par_mmdit_inputs(dev, tok.vocab_size), tp=tp_mesh["model"])
        torch.cuda.synchronize()
        res["fwd_launches"] = {k: w.launches for k, w in wrappers.items()}
        res["fwd"] = y.cpu().numpy()
    del params, y
    torch.cuda.empty_cache()
    rows, frames = PAR_MMDIT_TRAIN_BATCH
    batch = synthetic_packed_batch(mcfg, frames, rows, seed=9)
    model_cfg, train_cfg = _par_train_cfgs(mcfg, "adamw")
    trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, mesh=tp_mesh)
    state = trainer.shard(init_train_state(model_cfg, train_cfg, dev, m_np))
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res["metrics"] = {k: float(v) for k, v in trainer.step(state, batch).items()}
    torch.cuda.synchronize()
    res["s"], res["launches"] = time.perf_counter() - t0, {k: w.launches for k, w in wrappers.items()}
    whole = {k: unshard_params(state[k], tp_mesh) for k in ("params", "ema")}
    del state, trainer
    torch.cuda.empty_cache()
    if rank == 0:
        ref_trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device=dev)
        ref_state = init_train_state(model_cfg, train_cfg, dev, m_np)
        res["ref_metrics"] = {k: float(v) for k, v in ref_trainer.step(ref_state, batch).items()}
        worst = {}
        for part in ("params", "ema"):
            for (_, a), (_, b) in zip(tree_leaves(whole[part]), tree_leaves(ref_state[part])):
                worst[part] = max(worst.get(part, 0.0), float((a.detach() - b.detach()).abs().max()))
        res["max_abs_diff"] = worst
        del ref_state, ref_trainer
    del whole
    torch.cuda.empty_cache()
    return res


def _par_local_checks(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, launches: dict) -> dict:
    """(a) on this process: a one-rank NCCL group; returns the mesh-free
    references (b) compares with."""
    import torch.distributed as dist

    from f5tts_tpu_torch.models.convert import dit_params_from_numpy
    from f5tts_tpu_torch.models.dit import dit_forward
    from f5tts_tpu_torch.parallel.launcher import global_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = global_mesh(1, device=dev)
        log(f"(a) one-rank NCCL group: backend {dist.get_backend()}, mesh {mesh.shape} on {mesh.device}")
        inputs = _par_solve_inputs(dev, 8)
        free = _par_engine(dit_cfg, voc_cfg, dit_np, voc_np, tok, dev, 8)
        ref_mel, ref_wave = _par_solve(free, inputs, 20)
        del free
        meshed = _par_engine(dit_cfg, voc_cfg, dit_np, voc_np, tok, dev, 8, mesh=mesh)
        wrappers = _serving_wrappers()
        for w in wrappers.values():
            w.launches = 0
        mel, wave = _par_solve(meshed, inputs, 20)
        got = {k: w.launches for k, w in wrappers.items()}
        for k, c in got.items():
            launches[k]["parallel_nccl"] = c
        forwards = _par_forwards(20)
        want = {"flash_attention": 22 * forwards, "rope_rows": 22 * forwards, "conv_pos": forwards}
        same = torch.equal(mel, ref_mel) and torch.equal(wave, ref_wave)
        log(f"(a) bench geometry (8 x 1024, 128 ref, text_pad 512, ralston NFE 20, CFG 2, bf16) on mesh (1, 1) "
            f"against the mesh-free engine: mel and wave bit-equal {same}; launches {got} (want {want})")
        check(same, "(a) the one-rank NCCL mesh's solve differs from the mesh-free engine's")
        check(got == want, f"(a) launches {got}, want {want}")
        del meshed
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # the mesh-free references of (b), (e) and (g): the bf16 and the int8 solve at (b)'s geometry, one fp32 DiT
    # and one fp32 MMDiT forward
    free = _par_engine(dit_cfg, voc_cfg, dit_np, voc_np, tok, dev, PAR_SOLVE_BATCH)
    ref_mel, _ = _par_solve(free, _par_solve_inputs(dev, PAR_SOLVE_BATCH), PAR_SOLVE_NFE)
    del free
    free = _par_engine(dit_cfg, voc_cfg, dit_np, voc_np, tok, dev, PAR_SOLVE_BATCH, quantization="int8")
    _par_solve(free, _par_solve_inputs(dev, PAR_SOLVE_BATCH), 2)  # warm up
    wrappers = _int8_tp_wrappers()
    for w in wrappers.values():
        w.launches = 0
    ref_mel8, ref_wave8 = _par_solve(free, _par_solve_inputs(dev, PAR_SOLVE_BATCH), PAR_SOLVE_NFE)
    got = {k: w.launches for k, w in wrappers.items()}
    want = _int8_tp_want(0, _par_forwards(PAR_SOLVE_NFE), 1)
    log(f"(e) mesh-free int8 reference solve ({PAR_SOLVE_BATCH} x 1024, ralston NFE {PAR_SOLVE_NFE}, CFG 2, bf16): "
        f"launches {got} (want {want})")
    check(got == want, f"(e) mesh-free int8 launches {got}, want {want}")
    for k, c in got.items():
        launches.setdefault(k, {})["parallel_int8_mesh_free"] = c
    del free
    from f5tts_tpu_torch.models.convert import init_mmdit_numpy, mmdit_params_from_numpy
    from f5tts_tpu_torch.models.mmdit import MMDiTConfig, mmdit_forward

    mcfg = MMDiTConfig(text_num_embeds=tok.vocab_size)
    with torch.no_grad():
        pm = mmdit_params_from_numpy(init_mmdit_numpy(mcfg, seed=0), dev, torch.float32)
        mm32 = mmdit_forward(pm, mcfg, *_par_mmdit_inputs(dev, tok.vocab_size)).cpu().numpy()
    del pm
    torch.cuda.empty_cache()
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((2, 1024, 100)), dtype=torch.float32, device=dev)
    text = torch.as_tensor(rng.integers(0, 90, (2, 256)), dtype=torch.int32, device=dev)
    t, f = torch.tensor([0.3, 0.8], device=dev), torch.zeros((2,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        p32 = dit_params_from_numpy(dit_np, dev, torch.float32)
        fwd32 = dit_forward(p32, dit_cfg, x, x, text, t, f, f)
    del p32
    torch.cuda.empty_cache()
    return {"mel": ref_mel, "fwd32": fwd32.cpu().numpy(), "mel8": ref_mel8.cpu().numpy(),
            "wave8": ref_wave8.cpu().numpy(), "mmdit32": mm32}


def _par_ring_check(dev, card: str, launches: dict) -> None:
    """(d) the ring's per-shard body at p 4 over the rotated blocks, in one process."""
    from f5tts_tpu_torch.ops.attention import sdpa
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention
    from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train_fwd
    from f5tts_tpu_torch.parallel.ring_attention import LocalTransport, ring_body, seq_blocks

    b, h, n, d, p = PAR_RING
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn((b, h, n, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    mask[1, n - 1100:] = False  # row 1: the last shard's keys all masked, and 76 of the one before
    qb, kb, vb, mb = seq_blocks(q, p, 2), seq_blocks(k, p, 2), seq_blocks(v, p, 2), seq_blocks(mask, p, 1)
    blocks = list(zip(kb, vb, mb))

    def ring(r):
        return ring_body(qb[r], kb[r], vb[r], mb[r], p, LocalTransport(blocks, r))

    flash_attention_train_fwd.launches = 0
    o = torch.cat([ring(r) for r in range(p)], 2)
    torch.cuda.synchronize()
    hops = flash_attention_train_fwd.launches
    launches["flash_attention_train_fwd"]["parallel_ring"] = hops
    ref = sdpa(q.float(), k.float(), v.float(), mask)
    err = float((o.float() - ref).abs().max())
    log(f"(d) ring body p {p}, n {n}, b {b}, {h} x {d} bf16, row 1's last 1100 keys masked: {hops} hop launches "
        f"(want {p * p}); max abs error against fp32 plain attention over the whole sequence {err:.3e} "
        f"(tol {ATTN_TOL})")
    check(hops == p * p, f"(d) {hops} hop launches, want {p * p}")
    check(np.isfinite(err) and err < ATTN_TOL, f"(d) ring body error {err}")

    masks = [m.contiguous() for m in mb]  # as the transport hands the blocks over

    def hops_only(r=0):
        return [flash_attention_train_fwd(qb[r], kb[(r - i) % p], vb[(r - i) % p], masks[(r - i) % p])
                for i in range(p)]

    def whole():
        return flash_attention(q, k, v, mask)

    eager = [time_ms(fn) for fn in (lambda: ring(0), hops_only, whole)]
    graph = [time_graph_ms([fn]) for fn in (lambda: ring(0), hops_only, whole)]
    flops = 4 * b * h * n * n * d
    log(f"(d) device time on {card}, in a CUDA graph (eager with host gaps, CUDA events): one rank's body (4 hops + "
        f"lse merges) {graph[0]:.4f} ms ({eager[0]:.4f}), its 4 hop kernels alone {graph[1]:.4f} ms ({eager[1]:.4f}), "
        f"the serving kernel (no RoPE) over the whole sequence {graph[2]:.4f} ms ({eager[2]:.4f}); 4 ranks' hops do "
        f"the whole sequence's {flops / 1e9:.1f} GFLOP, one rank a quarter (bound, operations: "
        f"{bound_ms(flops / p, 0, PEAK_BF16_FLOPS)[0]:.4f} ms a rank, {bound_ms(flops, 0, PEAK_BF16_FLOPS)[0]:.4f} ms "
        f"the whole)")


def _par_ring_backward_check(dev, card: str, launches: dict) -> None:
    """(f) the ring's backward at p 4 in one process over the rotated blocks:
    every rank's forward (kernel 3a per hop), then its backward (kernel 3b per
    hop) with one shared set of traveling dK/dV accumulators; dq, dk, dv
    against fp32 autograd of plain attention over the whole sequence."""
    from f5tts_tpu_torch.ops.attention import sdpa
    from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train_bwd, flash_attention_train_fwd
    from f5tts_tpu_torch.parallel.ring_attention import LocalTransport, ring_body_bwd, ring_forward, seq_blocks

    b, h, n, d, p = PAR_RING
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v, do = (torch.randn((b, h, n, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
    masked = n // p + 76  # row 1: the last shard's keys all masked, and 76 of the one before (1100 at n 4096)
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    mask[1, n - masked:] = False
    qb, kb, vb, dob = (seq_blocks(t, p, 2) for t in (q, k, v, do))
    mb = seq_blocks(mask, p, 1)
    blocks, shared = list(zip(kb, vb, mb)), {}
    fwd, bwd = flash_attention_train_fwd, flash_attention_train_bwd
    grads, per_rank, fwd_out = [], [], []
    for r in range(p):
        fwd.launches = bwd.launches = 0
        o, lse = ring_forward(qb[r], kb[r], vb[r], mb[r], p, LocalTransport(blocks, r))
        grads.append(ring_body_bwd(qb[r], kb[r], vb[r], mb[r], o, lse, dob[r], p,
                                   LocalTransport(blocks, r, shared)))
        torch.cuda.synchronize()
        per_rank.append((fwd.launches, bwd.launches))
        fwd_out.append((o, lse))
    launches["flash_attention_train_fwd"]["parallel_ring_bwd"] = sum(a for a, _ in per_rank)
    launches["flash_attention_train_bwd"]["parallel_ring_bwd"] = sum(c for _, c in per_rank)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    (sdpa(*leaves, mask) * do.float()).sum().backward()
    errs = {}
    for i, (name, leaf) in enumerate(zip(("dq", "dk", "dv"), leaves)):
        got = torch.cat([gr[i] for gr in grads], 2)
        errs[name] = _rel_l2(got, leaf.grad)
    dead = float(torch.cat([gr[1] for gr in grads], 2)[1, :, n - masked:].abs().max())
    log(f"(f) ring backward p {p}, n {n}, b {b}, {h} x {d} bf16, row 1's last {masked} keys masked, in one process "
        f"over the rotated blocks: launches per rank (3a, 3b) {per_rank} (want (4, 8) each); relative L2 against fp32 "
        f"autograd of plain attention over the whole sequence: dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, dv "
        f"{errs['dv']:.3e} (tol {PAR_RING_GRAD_REL}); masked keys' dk max |.| {dead:.1e} (want 0)")
    check(all(c == (p, 2 * p) for c in per_rank), f"(f) launches per rank {per_rank}, want (4, 8)")
    check(all(np.isfinite(e) and e < PAR_RING_GRAD_REL for e in errs.values()), f"(f) ring backward off: {errs}")
    check(dead == 0.0, f"(f) masked keys got a dk of {dead}")
    del leaves, grads

    o0, lse0 = fwd_out[0]
    o_all, lse_all = fwd(q, k, v, mask)

    def body(r=0):
        return ring_body_bwd(qb[r], kb[r], vb[r], mb[r], o0, lse0, dob[r], p, LocalTransport(blocks, r, {}))

    masks = [m_.contiguous() for m_ in mb]

    def hops_only(r=0):
        return [bwd(qb[r], kb[(r - i) % p], vb[(r - i) % p], o0, lse0, dob[r], masks[(r - i) % p]) for i in range(p)]

    def whole():
        return bwd(q, k, v, o_all, lse_all, do, mask)

    graph = [time_graph_ms([fn]) for fn in (body, hops_only, whole)]
    flops = 10 * b * h * n * n * d  # five products of n x n x d per head: QK^T again, dP, dV, dQ, dK
    log(f"(f) device time on {card}, in a CUDA graph: one rank's backward body (4 hops of kernel 3b + fp32 "
        f"accumulation) {graph[0]:.4f} ms, its 4 hop calls alone {graph[1]:.4f} ms, kernel 3b over the whole "
        f"sequence {graph[2]:.4f} ms; bound (operations, {flops / 1e9:.1f} GFLOP the whole): "
        f"{bound_ms(flops / p, 0, PEAK_BF16_FLOPS)[0]:.4f} ms a rank, {bound_ms(flops, 0, PEAK_BF16_FLOPS)[0]:.4f} "
        f"ms the whole")
    del fwd_out, o_all, lse_all
    torch.cuda.empty_cache()


def parallel_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, launches: dict) -> None:
    """Phase 18: (a) a one-rank NCCL group; (b) and (c) two processes on the
    one card over gloo, named as such; (d) the ring body in one process."""
    import pickle
    import tempfile

    from f5tts_tpu_torch.parallel.dryrun import spawn

    t_phase = time.perf_counter()
    refs = _par_local_checks(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches)

    log("(b)/(c): two processes on the one card over gloo (NCCL refuses two ranks on one device; gloo's all_reduce "
        "takes CUDA tensors through host memory)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        spawn(_par_worker, 2, (out_dir,), timeout=600)
        outs = []
        for r in range(2):
            with open(os.path.join(out_dir, f"par_{r}.pkl"), "rb") as fh:
                outs.append(pickle.load(fh))
    log(f"(b)/(c) spawn took {time.perf_counter() - t0:.1f} s")
    forwards = _par_forwards(PAR_SOLVE_NFE)
    for r, o in enumerate(outs):
        want = {"flash_attention": 22 * forwards, "rope_rows": (22 if r == 0 else 0) * forwards, "conv_pos": forwards}
        log(f"(b) rank {r}: TP 2 solve ({PAR_SOLVE_BATCH} x 1024, ralston NFE {PAR_SOLVE_NFE}, CFG 2, bf16, 8 heads a "
            f"rank) {o['solve_s']:.3f} s wall (a correctness run over gloo, not a speed); launches "
            f"{o['solve_launches']} (want {want})")
        check(o["solve_launches"] == want, f"(b) rank {r} launches {o['solve_launches']}, want {want}")
        for k, c in o["solve_launches"].items():
            launches[k][f"parallel_tp_rank{r}"] = c
    same = np.array_equal(outs[0]["wave"], outs[1]["wave"]) and np.array_equal(outs[0]["mel"], outs[1]["mel"])
    log(f"(b) the two ranks' waves and mels bit-equal: {same}")
    check(same, "(b) the ranks' waves differ")
    ref_mel = refs["mel"].cpu().numpy()
    mel_rel = float(np.linalg.norm(outs[0]["mel"] - ref_mel) / np.linalg.norm(ref_mel))
    fwd_ref = refs["fwd32"]
    fwd_rel = float(np.linalg.norm(outs[0]["fwd32"] - fwd_ref) / np.linalg.norm(fwd_ref))
    log(f"(b) fp32 Base forward (2 x 1024) TP 2 vs mesh-free: relative L2 {fwd_rel:.3e} (tol {PAR_FWD_REL}); "
        f"bf16 solve's mel vs mesh-free bf16: relative L2 {mel_rel:.3e} (tol {PAR_TP_MEL_REL})")
    check(fwd_rel < PAR_FWD_REL, f"(b) fp32 TP forward off by {fwd_rel}")
    check(mel_rel < PAR_TP_MEL_REL, f"(b) bf16 TP solve off by {mel_rel}")

    want_train = {"flash_attention_train_fwd": 44, "flash_attention_train_bwd": 44}
    for case in ("tp_adamw", "dp_adamw", "tp_adafactor"):
        for r, o in enumerate(outs):
            c = o[case]
            log(f"(c) {case} rank {r}: step {c['s']:.3f} s (gloo), loss {c['metrics']['loss']:.6f}, grad norm "
                f"{c['metrics']['grad_norm']:.4f}, launches {c['launches']} (want {want_train})")
            check(c["launches"] == want_train, f"(c) {case} rank {r} launches {c['launches']}")
            for k, n_l in c["launches"].items():
                launches[k][f"parallel_{case}_rank{r}"] = n_l
        c = outs[0][case]
        ref = c["ref_metrics"]
        loss_rel = abs(c["metrics"]["loss"] - ref["loss"]) / abs(ref["loss"])
        worst = c["max_abs_diff"]
        key_tol = 4 * PAR_TRAIN_LR if case == "tp_adafactor" else PAR_PARAM_ATOL
        log(f"(c) {case} vs the mesh-free fp32 step ({PAR_TRAIN_BATCH[0]} x {PAR_TRAIN_BATCH[1]} frames, reduced "
            f"batch): loss {c['metrics']['loss']:.6f} vs {ref['loss']:.6f} (rel {loss_rel:.2e}, tol {PAR_LOSS_RTOL}), "
            f"grad norm {ref['grad_norm']:.4f} > clip {PAR_TRAIN_CLIP} (clipped); max abs diff params "
            f"{worst['params']:.3e}, EMA {worst['ema']:.3e} (tol {PAR_PARAM_ATOL:.1e}), key bias "
            f"{worst.get('key_bias', 0.0):.3e} (tol {key_tol:.1e})")
        check(ref["grad_norm"] > PAR_TRAIN_CLIP, f"(c) {case}: the clip did not bite")
        check(loss_rel < PAR_LOSS_RTOL, f"(c) {case}: loss off by {loss_rel}")
        check(worst["params"] < PAR_PARAM_ATOL and worst["ema"] < PAR_PARAM_ATOL, f"(c) {case}: state off {worst}")
        check(worst.get("key_bias", 0.0) < key_tol, f"(c) {case}: key bias off {worst}")

    # (e) the int8 TP solve: exact launches, the ranks equal, equal to the mesh-free int8 engine
    for r, o in enumerate(outs):
        c = o["int8"]
        want = _int8_tp_want(r, forwards, 2)
        log(f"(e) rank {r}: int8 TP 2 solve ({PAR_SOLVE_BATCH} x 1024, ralston NFE {PAR_SOLVE_NFE}, CFG 2, bf16, W8A8 "
            f"sharded then quantized) {c['s']:.3f} s wall over gloo on {card} (a correctness run, not a speed); "
            f"launches {c['launches']} (want {want}: per forward {QUANTIZED_LINEARS} x 22 quant_matmul, 44 row_amax, "
            f"44 rescale_rows)")
        check(c["launches"] == want, f"(e) rank {r} launches {c['launches']}, want {want}")
        for k, n_l in c["launches"].items():
            launches.setdefault(k, {})[f"parallel_int8_tp_rank{r}"] = n_l
    same = (np.array_equal(outs[0]["int8"]["wave"], outs[1]["int8"]["wave"])
            and np.array_equal(outs[0]["int8"]["mel"], outs[1]["int8"]["mel"]))
    mel8, wave8 = outs[0]["int8"]["mel"], outs[0]["int8"]["wave"]
    free_same = np.array_equal(mel8, refs["mel8"]) and np.array_equal(wave8, refs["wave8"])
    rel8 = float(np.linalg.norm(mel8 - refs["mel8"]) / np.linalg.norm(refs["mel8"]))
    log(f"(e) the two ranks' int8 waves and mels bit-equal: {same}; int8 TP 2 mel and wave against the mesh-free int8 "
        f"engine from the same seeds bit-equal: {free_same} (mel relative L2 {rel8:.3e}); finite "
        f"{bool(np.isfinite(wave8).all())}")
    check(same, "(e) the ranks' int8 waves differ")
    check(free_same, f"(e) the int8 TP solve differs from the mesh-free int8 solve (mel relative L2 {rel8})")

    # (g) the MMDiT at TP 2: the fp32 forward against the mesh-free one, the step against the mesh-free step
    # fp32: the conv-pos pair is two launches (conv_generic_kernel per layer); the joint attention is plain
    want_fwd = {"flash_attention": 0, "rope_rows": 0, "conv_pos": 2, "flash_attention_train_fwd": 0,
                "flash_attention_train_bwd": 0}
    for r, o in enumerate(outs):
        g = o["mmdit"]
        log(f"(g) rank {r}: MMDiT TP 2 forward launches {g['fwd_launches']} (want {want_fwd}), step {g['s']:.3f} s "
            f"(gloo), loss {g['metrics']['loss']:.6f}, launches {g['launches']} (want {want_fwd})")
        check(g["fwd_launches"] == want_fwd and g["launches"] == want_fwd, f"(g) rank {r} MMDiT launches")
        for k, n_l in g["launches"].items():
            launches.setdefault(k, {})[f"parallel_mmdit_step_rank{r}"] = n_l
        for k, n_l in g["fwd_launches"].items():
            launches.setdefault(k, {})[f"parallel_mmdit_fwd_rank{r}"] = n_l
    mm_ref = refs["mmdit32"]
    mm_rel = [float(np.linalg.norm(o["mmdit"]["fwd"] - mm_ref) / np.linalg.norm(mm_ref)) for o in outs]
    g = outs[0]["mmdit"]
    ref = g["ref_metrics"]
    loss_rel = abs(g["metrics"]["loss"] - ref["loss"]) / abs(ref["loss"])
    worst = g["max_abs_diff"]
    log(f"(g) MMDiTConfig() (dim 1024, depth 22, 16 x 64) fp32 forward (2 x 1024 frames + 256 text tokens) at TP 2 "
        f"vs mesh-free: relative L2 {mm_rel[0]:.3e} / {mm_rel[1]:.3e} (ranks 0 / 1; tol {PAR_MMDIT_REL}); fp32 step "
        f"({PAR_MMDIT_TRAIN_BATCH[0]} x {PAR_MMDIT_TRAIN_BATCH[1]} frames, reduced batch) vs the mesh-free step: loss "
        f"{g['metrics']['loss']:.6f} vs {ref['loss']:.6f} (rel {loss_rel:.2e}, tol {PAR_LOSS_RTOL}), grad norm "
        f"{ref['grad_norm']:.4f} (clip {PAR_TRAIN_CLIP}); max abs diff params {worst['params']:.3e}, EMA "
        f"{worst['ema']:.3e} (tol {PAR_PARAM_ATOL:.1e})")
    check(all(np.isfinite(e) and e < PAR_MMDIT_REL for e in mm_rel), f"(g) MMDiT TP forward off by {mm_rel}")
    check(loss_rel < PAR_LOSS_RTOL, f"(g) MMDiT step loss off by {loss_rel}")
    check(worst["params"] < PAR_PARAM_ATOL and worst["ema"] < PAR_PARAM_ATOL, f"(g) MMDiT step state off {worst}")

    _par_ring_check(dev, card, launches)
    _par_ring_backward_check(dev, card, launches)
    log(f"phase 18 (multi-device) took {time.perf_counter() - t_phase:.1f} s on {card}")


# ---------------------------------------------------------------------------
# phase 20: the module leftovers
# ---------------------------------------------------------------------------

FUSED_MEL_REL = 5e-2  # fused vs unfused bf16 solve from the same noise, relative L2 (the script's bf16 solve tolerance)
HARNESS_CONFIGS = ("base", "anchor64", "ralston8", "mid8", "truth")


def _fused_qkv_check(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, launches: dict, bf16_bench) -> None:
    """(a) the fused q/k/v projection: kernel 1 on its views, a solve against
    the unfused one, the bench beside the unfused bench."""
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
    from f5tts_tpu_torch.models.modules import fuse_attention_qkv
    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm
    from f5tts_tpu_torch.ops.rope import rotary_freqs

    fused_np = {**dit_np, "blocks": {**dit_np["blocks"], "attn": fuse_attention_qkv(dit_np["blocks"]["attn"])}}
    b, n, h, d = 16, 1024, dit_cfg.heads, dit_cfg.dim_head
    g = torch.Generator(device="cpu").manual_seed(20)
    x = torch.randn((b, n, dit_cfg.dim), generator=g).to(dev, torch.bfloat16)
    w = torch.as_tensor(fused_np["blocks"]["attn"]["qkv"]["w"][0], device=dev).to(torch.bfloat16)
    q, k, v = ((x @ w).chunk(3, -1)[i].reshape(b, n, h, d).transpose(1, 2) for i in range(3))
    check(q.stride() == k.stride() == v.stride() == (n * 3 * h * d, d, 3 * h * d, 1),
          f"the fused thirds' head-split strides {q.stride()}")
    lens = torch.randint(n // 2, n + 1, (b,), generator=g).to(dev)
    mask = torch.arange(n, device=dev)[None, :] < lens[:, None]
    freqs = torch.as_tensor(rotary_freqs(n, d), device=dev)
    out = flash_attention(q, k, v, mask, rope_freqs=freqs)
    dense = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask, rope_freqs=freqs)
    check(torch.equal(out, dense), "flash_attention on the fused product's views differs from the contiguous call")
    log(f"(a) fused q/k/v: kernel 1 on the head-split thirds of one (1024, 3072) product (strides {q.stride()}, "
        f"bf16, {b} x {n}, head-0 RoPE, key mask) is bit-equal to the call on contiguous copies")
    del x, w, q, k, v, out, dense

    # one solve from the same noise at the bench geometry, fused against unfused
    cfg = EngineConfig(vocoder=voc_cfg, duration_buckets=(1024,), batch_buckets=(8,), text_pad=512)
    cond, cond_lens, text, duration, seeds = _bench_inputs(dev)
    mels = []
    for tree in (dit_np, fused_np):
        engine = TTSEngine(tree, dit_cfg, voc_np, tok, cfg, device=dev)
        with torch.no_grad():
            mels.append(engine.bucket_program(cond, cond_lens, text, duration, seeds, steps=10, cfg_strength=2.0)[0])
        del engine
    gen = slice(0, 1024 - 128)  # the program rolls the generated frames to the origin
    rel = float(torch.linalg.vector_norm((mels[1] - mels[0])[:, gen].float())
                / torch.linalg.vector_norm(mels[0][:, gen].float()))
    log(f"(a) fused against unfused solve from the same noise (bench geometry, Ralston NFE 20, CFG 2, bf16): "
        f"generated mel relative L2 {rel:.3e} (tol {FUSED_MEL_REL})")
    check(np.isfinite(rel) and rel < FUSED_MEL_REL, f"the fused solve's mel is off by {rel}")
    del mels
    torch.cuda.empty_cache()

    wrappers = {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos, "row_norm": row_norm}
    if bf16_bench is None:
        bf16_bench = bench_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card)
    for wr in wrappers.values():
        wr.launches = 0
    fused_bench = bench_phase(dev, dit_cfg, voc_cfg, fused_np, voc_np, tok, card, backbone="F5-TTS fused q/k/v")
    for name, wr in wrappers.items():
        launches[name]["bench_fused"] = wr.launches
    forwards = 5 * 20  # a warm call, the profiled call and three timed ones, 20 forwards each
    want = {"flash_attention": dit_cfg.depth * forwards, "rope_rows": dit_cfg.depth * forwards, "conv_pos": forwards,
            "row_norm": (2 * dit_cfg.depth + 1) * forwards}
    check({name: wr.launches for name, wr in wrappers.items()} == want,
          f"fused bench launch counts {({name: wr.launches for name, wr in wrappers.items()})}, want {want}")
    fams = ("flash_attention", "rope_rows", "conv_pos")
    kern_u, kern_f = ({f: bench["launch_counts"].get(f, 0) for f in fams} for bench in (bf16_bench, fused_bench))
    gemm_u, gemm_f = (bench["launch_counts"].get("gemm", 0) for bench in (bf16_bench, fused_bench))
    moved = 2 * dit_cfg.depth * 20  # two of every block's three projections, 20 forwards
    log(f"(a) fused q/k/v against unfused at the bench geometry on {card}: {fused_bench['audio_s_per_s']:.2f} against "
        f"{bf16_bench['audio_s_per_s']:.2f} audio-s/s (median solve {fused_bench['median_s']:.4f} against "
        f"{bf16_bench['median_s']:.4f} s); library GEMM launches per solve {gemm_f} against {gemm_u} ({gemm_u - gemm_f} "
        f"fewer, want {moved}), GEMM device ms {fused_bench['device_ms'].get('gemm', 0.0):.1f} against "
        f"{bf16_bench['device_ms'].get('gemm', 0.0):.1f}; kernels per solve {kern_f} against {kern_u}")
    check(gemm_u - gemm_f == moved, f"the fused solve launched {gemm_u - gemm_f} fewer library GEMMs, want {moved}")
    check(kern_f == kern_u == {"flash_attention": dit_cfg.depth * 20, "rope_rows": dit_cfg.depth * 20, "conv_pos": 20},
          f"kernel launches per solve: fused {kern_f}, unfused {kern_u}")


def _native_audio_check(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, launches: dict, t_script: float) -> None:
    """(b) the native audio library: the build, bit equality with the numpy
    forms, a streaming request through its crossfade."""
    from f5tts_tpu_torch.audio import native
    from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine

    t0 = time.perf_counter()
    native.load()
    built_now = os.path.getmtime(native.LIBRARY) >= t_script
    check(os.path.dirname(native.LIBRARY) == os.path.join(HERE, "f5tts_tpu_torch", "_build")
          and os.path.getmtime(native.LIBRARY) >= os.path.getmtime(native.SOURCE),
          "the native audio library is not the build of the checkout's source")
    log(f"(b) native audio library {os.path.relpath(native.LIBRARY, HERE)} from "
        f"{os.path.relpath(native.SOURCE, HERE)}: {'built in this run' if built_now else 'built before this run'}, "
        f"loaded in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(21)
    ks = np.arange(-32767, 32767, 7)
    ties = ((ks + 0.5) / 32767).astype(np.float32)
    ties = ties[(ties * np.float32(32767.0)) % 1 == 0.5]
    x = np.concatenate([rng.uniform(-1.5, 1.5, 24000 * 30).astype(np.float32), ties])
    t0 = time.perf_counter()
    pcm = native.encode_pcm16(x)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = native.encode_pcm16_plain(x)
    t_plain = time.perf_counter() - t0
    check(np.array_equal(pcm, plain), "the native int16 encode differs from the numpy form")
    log(f"(b) encode_pcm16 on {len(x)} samples ({len(ties)} exact .5 ties, clipping): bit-equal to the numpy form; "
        f"{t_native * 1e3:.2f} ms against numpy's {t_plain * 1e3:.2f} ms (host clock)")
    a, bb = rng.standard_normal(48000).astype(np.float32), rng.standard_normal(36000).astype(np.float32)
    for n_fade in (0, 1, 2, 3600):
        got, want = native.crossfade_pair(a, bb, n_fade), native.crossfade_pair_plain(a, bb, n_fade)
        head, tail = slice(0, len(a) - n_fade), slice(len(a), None)
        check(len(got) == len(want) and np.array_equal(got[head], want[head]) and np.array_equal(got[tail], want[tail])
              and (n_fade > 2 or np.array_equal(got, want)), f"native crossfade, fade {n_fade}: differs from numpy")
        diff = float(np.abs(got - want).max())
        log(f"(b) crossfade_pair, fade {n_fade}: outside the overlap bit-equal to numpy; in it max abs difference "
            f"from np.linspace's fades {diff:.3e} (the C loop takes i / (n - 1) and 1 - i / (n - 1))")

    from f5tts_tpu_torch.ops.kernels.conv_pos import conv_pos
    from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention, rope_rows
    from f5tts_tpu_torch.ops.kernels.row_norm import row_norm

    engine = TTSEngine(dit_np, dit_cfg, voc_np, tok, EngineConfig(vocoder=voc_cfg), device=dev)
    solves = _count_solves(engine)
    ref, ref_text = synthetic_ref(3.0, 130.0, 22), "A reference clip for the streamed request."
    text = ("A streamed request hands back each chunk as its solve ends, joined by the native crossfade. " * 4).strip()
    wrappers = {"flash_attention": flash_attention, "rope_rows": rope_rows, "conv_pos": conv_pos, "row_norm": row_norm}
    for wr in (*wrappers.values(), native.crossfade_pair):
        wr.launches = 0
    t0 = time.perf_counter()
    segments = list(engine.synthesize_streaming(text, ref, 24000, ref_text, seed=23))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    forwards = sum(f for f, _ in solves)
    got = {name: wr.launches for name, wr in wrappers.items()}
    want = {"flash_attention": dit_cfg.depth * forwards, "rope_rows": dit_cfg.depth * forwards, "conv_pos": forwards,
            "row_norm": (2 * dit_cfg.depth + 1) * forwards}
    joins = native.crossfade_pair.launches
    log(f"(b) synthesize_streaming: {len(segments)} segments in {wall:.3f} s, solves (forwards, rows) {solves}; "
        f"native crossfade calls {joins} (want {len(solves) - 1}: one per chunk join); launches {got} (want {want})")
    check(len(solves) > 1 and joins == len(solves) - 1, "the streamed chunks were not joined by the native crossfade")
    check(got == want, f"streaming launches {got}, want {want}")
    check(all(np.isfinite(s_).all() for s_ in segments) and sum(len(s_) for s_ in segments) > 0,
          "streamed segments not finite")
    for name in wrappers:
        launches[name]["stream_native"] = got[name]
    del engine
    torch.cuda.empty_cache()


def _harness_check(launches: dict) -> None:
    """(c) the quality harness at Base, bf16, 4 prompts, in-process."""
    import tempfile

    from f5tts_tpu_torch.sampling.euler import EVALS_PER_STEP
    from f5tts_tpu_torch.scripts import quality_harness as qh

    depth = qh.DiTConfig.base().depth
    calls = sum(qh.CONFIGS[n].steps * EVALS_PER_STEP[qh.CONFIGS[n].method] for n in HARNESS_CONFIGS)  # one 2b pair each
    want = {"flash_attention": depth * calls, "rope_rows": depth * calls, "conv_pos": calls,
            "row_norm": (2 * depth + 1) * calls}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--geometry", "base", "--dtype", "bf16", "--prompts", "4", "--configs", ",".join(HARNESS_CONFIGS),
                "--out", os.path.join(tmp, "quality.json"), "--solve-cache", os.path.join(tmp, "cache"),
                "--device", "cuda"]
        result = _launched(f"(c) quality harness at Base ({calls} DiT forwards of 8 rows)", lambda: qh.main(argv), want)
    secs = time.perf_counter() - t0
    for name, n in want.items():
        launches.setdefault(name, {})["quality_harness"] = n
    rows = result["rows"]
    numbers = [v for r in rows for k, v in r.items() if isinstance(v, float)]
    check([r["name"] for r in rows] == list(HARNESS_CONFIGS) and all(np.isfinite(numbers)),
          f"harness rows not finite: {rows}")
    check(all(r["forwards"] == qh.n_forwards(qh.CONFIGS[r["name"]]) for r in rows), "harness forwards")
    log(f"(c) quality harness at Base (bf16, 4 prompts, {','.join(HARNESS_CONFIGS)}): recipe error to truth "
        f"{result['base_truth_l2']:.5f}, x recipe-err " + ", ".join(
            f"{r['name']} {r['vs_recipe_truth_err']:.3f}" for r in rows if "vs_recipe_truth_err" in r)
        + f"; {secs:.1f} s")


def leftovers_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card: str, launches: dict, bf16_bench,
                    t_script: float) -> None:
    """Phase 20: (a) the fused q/k/v projection, (b) the native audio ops,
    (c) the quality harness at Base."""
    t_phase = time.perf_counter()
    _fused_qkv_check(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches, bf16_bench)
    _native_audio_check(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, launches, t_script)
    _harness_check(launches)
    log(f"phase 20 (module leftovers) took {time.perf_counter() - t_phase:.1f} s on {card}")



# ---------------------------------------------------------------------------
# phase 21: the probe and profiling tools
# ---------------------------------------------------------------------------

TOOLS_E2E = dict(nfe=4, bucket=512, dtype="bfloat16")  # the JAX script's chip run
TOOLS_PROFILE_ITERS = 2  # the JAX script's iterations per variant
TOOLS_STEP_PROBE = dict(batch=16, steps=16)  # as PARLER_STEP_PROBE.json ran
TOOLS_STEP_ITERS = 3
TOOLS_KERNELATTN_REL = 5e-2  # kernelattn vs unrolled last hidden state, bf16 (the kernel vs fp32-score attention)
TOOLS_ROOFLINE_BATCH = 16  # the JAX script's default batches 8,16,32 cut to 16 for time, iters 1


def _tools_e2e(dev, card: str, launches: dict) -> None:
    """(a) a full-size trainer ``.pt`` through the convert CLI, the engine and
    the parity solves, in a temporary directory."""
    import tempfile

    from f5tts_tpu_torch.models.convert import init_dit_numpy
    from f5tts_tpu_torch.models.dit import param_count
    from f5tts_tpu_torch.models.vocos import VocosConfig
    from f5tts_tpu_torch.scripts import e2e_real_ckpt as e2e

    cfg, nfe = e2e.base_config(), TOOLS_E2E["nfe"]
    forwards = nfe  # Euler, CFG fused: one 2-row forward a step
    want = {"flash_attention": cfg.depth * forwards * 4, "rope_rows": cfg.depth * forwards,  # fp32: RoPE in the kernel
            "conv_pos": forwards + 3 * 2 * forwards,  # fp32 conv-pos: one launch a layer
            "row_norm": (2 * cfg.depth + 1) * forwards * 4}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="f5_e2e_") as tmp:
        result, _ = _launched(f"(a) e2e_real_ckpt at Base ({TOOLS_E2E['dtype']} engine, NFE {nfe}, bucket "
                              f"{TOOLS_E2E['bucket']}; three fp32 parity solves)",
                              lambda: e2e.run(cfg, VocosConfig(), os.path.join(tmp, "f5_base_e2e.pt"),
                                              device=dev, **TOOLS_E2E, log=lambda m: log(f"(a) {m}")), want)
        left = os.listdir(tmp)
    for name, n in want.items():
        launches.setdefault(name, {})["tools_e2e"] = n
    log(f"(a) e2e_real_ckpt on {card}: {json.dumps(result)} in {time.perf_counter() - t0:.1f} s")
    check(result["parity_ok"] and result["mel_rel"] <= e2e.PARITY_REL
          and result["online_mel_rel"] > e2e.ONLINE_MIN_REL and result["wave_samples"] > 0 and not left,
          f"e2e: {result}, files left {left}")
    n_params = param_count(init_dit_numpy(cfg, seed=None))  # shapes only
    check(round(result["params_m"] * 1e6) == n_params and result["ckpt_gb"] > 2 * 4 * n_params / 1e9,
          f"e2e checkpoint size: {result}, want {n_params} params in two fp32 dicts")


def _tools_strict(dev, card: str, launches: dict) -> None:
    """(b) the strict probe over ``ModelService`` on the seeded Base tree."""
    import tempfile

    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.scripts import strict_live_probe as slp

    depth = DiTConfig.base().depth
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="f5_strict_") as work:
        settings = {**slp.write_assets(work, seeded_teacher=True), "warmup": False,
                    "speech_rate_limit": "1000/minute", "device": dev.type}
        forwards = {}  # the solves' DiT forwards (one conv-pos launch each): known after the requests

        def want(got):
            forwards["n"] = got["conv_pos"]
            return {"flash_attention": depth * forwards["n"], "rope_rows": depth * forwards["n"],
                    "conv_pos": forwards["n"], "row_norm": (2 * depth + 1) * forwards["n"]}

        out = _launched("(b) strict_live_probe over the service (seeded Base, bf16)",
                        lambda: slp.run("service", settings, work, log=lambda m: log(f"(b) {m}")), want)
    for name, per_forward in (("flash_attention", depth), ("rope_rows", depth), ("conv_pos", 1),
                              ("row_norm", 2 * depth + 1)):
        launches.setdefault(name, {})["tools_strict"] = per_forward * forwards["n"]
    rows = out["rows"]
    log(f"(b) strict_live_probe on {card} in {time.perf_counter() - t0:.1f} s: threshold {out['threshold']}, rows "
        f"{json.dumps(rows)}; {out['note']}")
    check(list(rows) == ["easy_strict", "hard_strict", "hard_default"]
          and all(r["wav_bytes"] > 44 and r["escalations_delta"] >= 0 for r in rows.values())
          and rows["hard_default"]["escalations_delta"] == 0, f"strict probe rows: {rows}")


def _tools_profile(dev, card: str, launches: dict) -> None:
    """(c) the knock-out table at the shipping recipe, with ``full``'s families."""
    from f5tts_tpu_torch.models.convert import dit_params_from_numpy, init_dit_numpy
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.scripts import profile_sampler as ps

    cfg = DiTConfig.base()
    params = dit_params_from_numpy(init_dit_numpy(cfg, seed=0), dev, torch.bfloat16)
    inputs = ps.make_inputs(cfg, device=dev)
    forwards, calls = 20, TOOLS_PROFILE_ITERS + 1  # Ralston NFE 20; a warm call and the timed ones
    per_solve = {"full": (1, 1), "no-attention": (0, 1), "no-ff": (1, 1), "no-convpos": (1, 0), "no-adaln": (1, 1),
                 "plain-attn": (0, 1)}  # variant -> (attention kernels, conv-pos kernel) a forward
    want_solve = {v: {"flash_attention": a * cfg.depth * forwards, "rope_rows": a * cfg.depth * forwards,
                      "conv_pos": c * forwards} for v, (a, c) in per_solve.items()}
    norms = {v: (cfg.depth + 1 if v == "no-adaln" else 2 * cfg.depth + 1) * forwards  # no-adaln: the second
             for v in want_solve}                                                  # norm and the final one
    want = {k: sum(w[k] * (calls + (v == "full")) for v, w in want_solve.items())  # full: one profiled solve more
            for k in ("flash_attention", "rope_rows", "conv_pos")}
    want["row_norm"] = sum(r * (calls + (v == "full")) for v, r in norms.items())
    originals = {name: getattr(m, name) for name, _ in ps.KNOCKOUTS.values()}
    t0 = time.perf_counter()
    out = _launched("(c) profile_sampler, six variants", lambda: ps.profile(
        params, cfg, inputs, iters=TOOLS_PROFILE_ITERS, device=dev, log=lambda msg: log(f"(c) {msg}")), want)
    for name, n in want.items():
        launches.setdefault(name, {})["tools_profile"] = n
    check(all(getattr(m, name) is fn for name, fn in originals.items()), "a knock-out was left patched")
    check(out["launches"] == want_solve, f"knock-out launches per solve {out['launches']}, want {want_solve}")
    fams = out["families"] or {}
    check(fams.get("flash_attention", {}).get("launches") == cfg.depth * forwards
          and fams.get("conv_pos", {}).get("launches") == forwards
          and fams.get("row_norm", {}).get("launches") == norms["full"], f"full's profile families {fams}")
    total = sum(f["launches"] for f in fams.values())
    log(f"(c) full's profiled solve: {total} device launches, {total / forwards:.1f} a forward (the sampler's own "
        f"ops included)")
    t = out["times_s"]
    shares = sum(t["full"] - t[v] for v in ("no-attention", "no-ff", "no-convpos", "no-adaln"))
    log(f"(c) knock-out table on {card} (b 8 x 1024, Ralston NFE 20, CFG 2, bf16): "
        + ", ".join(f"{v} {s:.4f} s" for v, s in t.items())
        + f"; the four shares sum to {shares:.4f} s of the full {t['full']:.4f} s; {time.perf_counter() - t0:.1f} s")
    check(all(np.isfinite(v) and v > 0 for v in t.values()), f"knock-out times {t}")
    del params


def _tools_component(dev, card: str, launches: dict) -> None:
    """(d) one fused-CFG DiT step per attention path and the Vocos decode."""
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.models.vocos import VocosConfig
    from f5tts_tpu_torch.scripts import component_bench as cb

    depth, iters = DiTConfig.base().depth, 5
    steps = iters + 1  # a warm call and the timed ones, per path
    want = {"flash_attention": depth * steps, "rope_rows": depth * steps, "conv_pos": 2 * steps,
            "row_norm": (2 * depth + 1) * 2 * steps}  # the norms on both attention paths
    out = _launched("(d) component_bench", lambda: cb.run(DiTConfig.base(), VocosConfig(), 16, 1024, iters, dev,
                                                           log=lambda m: log(f"(d) {m}")), want)
    for name, n in want.items():
        launches.setdefault(name, {})["tools_component"] = n
    log(f"(d) component_bench on {card}: {json.dumps(out)}")
    check(all(np.isfinite(out[k]) and out[k] > 0 for k in ("dit_step_plain_ms", "dit_step_flash_ms",
                                                           "vocos_decode_ms")), f"component times {out}")


def _tools_roofline(dev, card: str, launches: dict, cfgs, trees) -> None:
    """(e) the Parler roofline at batch 16, one timed call each."""
    from f5tts_tpu_torch.models.convert import parler_params_from_numpy
    from f5tts_tpu_torch.scripts import parler_roofline as pr

    dec_cfg = cfgs[1]
    frames = 430
    steps = frames + dec_cfg.codebooks - 1
    half = frames // 2 + dec_cfg.codebooks - 1
    decodes = [steps] * 3 + [half]  # sampled (warm + timed), greedy, half the frames
    want = {"decode_attention": 2 * dec_cfg.layers * sum(decodes)}
    t0 = time.perf_counter()
    tensors = parler_params_from_numpy(*trees, dev, torch.bfloat16)
    out = _launched(f"(e) parler_roofline at batch {TOOLS_ROOFLINE_BATCH} ({len(decodes)} decodes of "
                    f"{decodes} positions, 2 x {dec_cfg.layers} kernel launches a position)",
                    lambda: pr.run(tensors, cfgs, [TOOLS_ROOFLINE_BATCH], frames, iters=1, device=dev,
                                   log=lambda m: log(f"(e) {m}")), want)
    launches["decode_attention"]["tools_roofline"] = want["decode_attention"]
    (row,) = out["rows"]
    log(f"(e) parler_roofline on {card} in {time.perf_counter() - t0:.1f} s: step {row['step_us']:.1f} us against "
        f"a bound of {row['step_bound_us']:.1f} us ({100 * row['bw_efficiency']:.2f}% of it), "
        f"{row['audio_s_per_s_pipeline']:.2f} audio-s/s the pipeline")
    check(all(np.isfinite(v) and v > 0 for v in row.values()), f"roofline row {row}")
    del tensors


def _tools_step_probe(dev, card: str, launches: dict) -> None:
    """(f) the decode-step layouts, eager and in a CUDA graph."""
    from f5tts_tpu_torch.scripts import parler_step_probe as psp

    t0 = time.perf_counter()
    probe = psp.StepProbe(**TOOLS_STEP_PROBE, device=dev)
    log(f"(f) step probe weights ({probe.L} layers, hidden {probe.H}, ffn {probe.F}, b {probe.b}) in "
        f"{time.perf_counter() - t0:.1f} s")
    per_run = 2 * probe.L * probe.steps  # self and cross attention, every layer, every position
    runs = 1 + TOOLS_STEP_ITERS + 2  # the counted warm run, the timed ones, the graph's warm-up and its capture
    want = {"decode_attention": per_run * runs}
    out = _launched("(f) parler_step_probe, six variants", lambda: psp.run(
        probe, iters=TOOLS_STEP_ITERS, log=lambda m: log(f"(f) {m}")), want)
    launches["decode_attention"]["tools_step_probe"] = want["decode_attention"]
    rows = {r["variant"]: r for r in out["rows"]}
    check(list(rows) == list(psp.VARIANTS) and all("graph_step_us" in r for r in rows.values()),
          f"step probe rows {list(rows)}")
    check(all(r["decode_attention_launches"] == (per_run if v == "kernelattn" else 0) for v, r in rows.items()),
          f"kernel launches per eager run {({v: r['decode_attention_launches'] for v, r in rows.items()})}")
    ref = probe.hidden["unrolled"]
    rel = {v: float((h - ref).norm() / ref.norm()) for v, h in probe.hidden.items()}
    graph_off = {v: r["graph_vs_eager_max_abs"] for v, r in rows.items()}
    log(f"(f) step probe on {card} (b {probe.b}, {probe.steps} positions): eager / graph us a step "
        + ", ".join(f"{v} {r['step_us']:.1f} / {r['graph_step_us']:.1f}" for v, r in rows.items())
        + f"; bound {rows['unrolled']['bound_us']:.1f} us; last hidden state vs unrolled, relative L2 {rel}; "
          f"graph vs eager max abs {graph_off}; {time.perf_counter() - t0:.1f} s")
    check(all(np.isfinite(v) for v in (*rel.values(), *graph_off.values())), "step probe states not finite")
    check(rel["kernelattn"] < TOOLS_KERNELATTN_REL and rel["fusedqkv"] < TOOLS_KERNELATTN_REL,
          f"kernelattn / fusedqkv off unrolled: {rel}")
    del probe


def tools_phase(dev, card: str, launches: dict, parler_cfgs, parler_trees) -> None:
    """Phase 21: the probe and profiling tools, each through its module's
    functions as ``main`` calls them."""
    from f5tts_tpu_torch.utils import timing

    check((timing.PEAK_BF16_FLOPS, timing.PEAK_INT8_OPS, timing.PEAK_BYTES)
          == (PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES), "the tools' peaks differ from this script's")
    t_phase = time.perf_counter()
    for name in ("decode_attention", "flash_attention", "rope_rows", "conv_pos"):
        launches.setdefault(name, {})
    _tools_e2e(dev, card, launches)
    _tools_strict(dev, card, launches)
    _tools_profile(dev, card, launches)
    _tools_component(dev, card, launches)
    torch.cuda.empty_cache()
    _tools_roofline(dev, card, launches, parler_cfgs, parler_trees)
    _tools_step_probe(dev, card, launches)
    torch.cuda.empty_cache()
    log(f"phase 21 (tools) took {time.perf_counter() - t_phase:.1f} s on {card}")

def main():
    t_script = time.time()
    ap = argparse.ArgumentParser()
    ap.add_argument("--serving-only", action="store_true",
                    help="build the kernels and run only the serving phase (no result lines)")
    ap.add_argument("--backbones-only", action="store_true",
                    help="build the kernels and run only the F5 bench and phases 13-16 (no result lines)")
    ap.add_argument("--distill-only", action="store_true",
                    help="build the kernels and run only the distillation phase (no result lines)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build the kernels and run only the multi-device phase (no result lines)")
    ap.add_argument("--ar-only", action="store_true",
                    help="build the kernels and run only the autoregressive leftovers phase (no result lines)")
    ap.add_argument("--leftovers-only", action="store_true",
                    help="build the kernels and run only the F5 bench and the module leftovers phase (no result lines)")
    ap.add_argument("--tools-only", action="store_true",
                    help="build the kernels and run only the probe and profiling tools phase (no result lines)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels (and run the ablation), skip the engine, bench, int8, "
                         "training, distillation and Parler phases")
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

    if args.ar_only:
        launches = {"decode_attention": {}}
        ar_phase(dev, card, launches, *parler_full_trees())
        log(f"launches {launches}")
        return
    if args.tools_only:
        launches = {}
        tools_phase(dev, card, launches, *parler_full_trees())
        log(f"launches {launches}")
        check(ablate_attention.launches == 0, "the ablation kernel ran on a tool's path")
        return
    if args.serving_only or args.backbones_only or args.distill_only or args.parallel_only or args.leftovers_only:
        from f5tts_tpu_torch.models.convert import init_dit_numpy, init_vocos_numpy
        from f5tts_tpu_torch.models.dit import DiTConfig
        from f5tts_tpu_torch.models.vocos import VocosConfig
        from f5tts_tpu_torch.text.tokenizer import Tokenizer

        tok = Tokenizer.from_file(os.path.join(HERE, "examples", "vocab.txt"))
        dit_cfg, voc_cfg = DiTConfig(text_num_embeds=tok.vocab_size), VocosConfig()
        dit_np, voc_np = init_dit_numpy(dit_cfg, seed=0), init_vocos_numpy(voc_cfg, seed=1)
        launches = {name: {} for name in (*DISTILL_WRAPPERS, "row_norm")}
        if args.serving_only:
            serving_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches)
        elif args.distill_only:
            distill_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches)
        elif args.parallel_only:
            parallel_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches)
        elif args.leftovers_only:
            leftovers_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches, None, t_script)
        else:
            f5_bench = bench_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card)
            backbone_phases(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches, f5_bench)
        log(f"launches {launches}")
        return
    kernels = [attention_phase(dev), conv_phase(dev), *train_kernel_phase(dev), decode_attention_phase(dev),
               quant_matmul_phase(dev)]
    kernels[-1]["tp_modes"], companions = quant_tp_phase(dev)  # kernel 5's row-parallel modes and companions
    kernels += [*companions, row_norm_phase(dev), ablate_attention_phase(dev)]
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
        serving_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches)
        backbone_phases(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches, bf16_bench)  # phases 13-16
        train_phase(dev, dit_cfg, TRAIN_SHAPES, tok, card, launches)  # F5-TTS Base, dropout 0.1, kernels
        distill_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches)  # phase 17
        parallel_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches)  # phase 18
        parler = parler_full_trees()  # indic-parler-tts width and depth, random weights
        parler_phase(dev, card, launches, *parler)
        ar_phase(dev, card, launches, *parler)  # phase 19
        leftovers_phase(dev, dit_cfg, voc_cfg, dit_np, voc_np, tok, card, launches, bf16_bench, t_script)  # phase 20
        del dit_np, voc_np
        tools_phase(dev, card, launches, *parler)  # phase 21
        del parler
        log(f"ablate_attention launches through the engine, int8, serving, training, distillation, Parler, "
            f"autoregressive, module-leftover and tool phases: "
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
        *(key for key in ("eager_ms", "int_mm_ms", "bf16_matmul_ms", "mma_sync_s8_top_s", "wgmma_s8_top_s",
                          "graph_ms", "variants_ms", "other_shapes", "tp_modes", "kernel",
                          "layouts_ms", "ablation_rows", "max_rel_peak_err", "rope_rows_launches",
                          "rope_rows_launches_by_path") if key in k))}
        for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
