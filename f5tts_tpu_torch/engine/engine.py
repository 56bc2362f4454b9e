"""TTS engine (counterpart of ``f5tts_tpu/engine/engine.py``): text + reference
clip -> waveform.

- **Buckets.** Rows pad up to a duration bucket and a batch bucket, so each
  bucket runs one fixed-shape program (``bucket_program``).
- **Batched chunks.** Long texts are chunked (speech-rate-aware byte budget,
  word top-off packing to fill the 1024-frame bucket) and the chunks of one
  bucket run as ONE batched ODE solve, capped per bucket by
  ``solve_batch_caps``.
- **Program per bucket.** ``sample_cfm`` (fused 2b-row CFG) -> roll the
  generated frames to the origin and zero past each row's generated length
  -> the vocoder (``self._decode``).

- **Strict quality.** Rows with ``quality="strict"`` solve with the sampler's
  embedded error estimate; a row whose estimate exceeds ``strict_threshold``
  is solved again with the exact reference recipe (euler, 32 steps).
- **Speech edit.** An edit row (``prepare_edit_row``) carries an ``edit_mask``
  (frames to keep) and returns the whole utterance from frame 0; it shares
  its bucket's solve with synthesis rows.
- **Dispatch/fetch pipelining.** ``synthesize_rows`` queues up to
  ``fetch_pipeline_depth`` solves on the card before it copies the oldest
  one's results to the host: a CUDA event per solve and a non-blocking copy
  into pinned memory, so the host's unpacking of one solve overlaps the card's
  next one.

The engine keeps a bf16 serving copy of the parameters and runs the backbone
with ``attn_impl="flash"`` and ``conv_pos_impl="fused"``: on a GPU those are
the hand-written CUDA kernels, on the CPU their plain versions. The backbone
is the DiT by default; ``forward_fn``/``embed_fn`` (``unett_forward``/
``unett_embed``) make it the E2-TTS UNetT, and they reach every solve, the
step batcher's segments included. The vocoder is Vocos, or BigVGAN with
``vocoder_type="bigvgan"``; every decode goes through ``self._decode``. With
``quantization="int8"`` the DiT blocks' six linears are quantized after the
dtype cast (W8A8, ``models/dit.py:quantize_dit_params``) and run through the
``quant_matmul`` kernel.

Multi-device (``TTSEngine(mesh=...)``, ``parallel/mesh.py``): the backbone is
sharded over the mesh's ``model`` axis (Megatron, ``parallel/sharding.py``)
and the vocoder replicated. Every rank runs the same ``synthesize*`` calls
(SPMD, as the JAX package's multi-host path) and returns the same wave; each
rank's blocks run the serving kernels on its own heads (head-0 RoPE on model
rank 0 only). ``bucket_program``, the step batcher and ``forward_fn``/
``embed_fn`` see only local shards. The host's seed generator starts from a
seed broadcast from rank 0, so requests without a seed draw the same noise on
every rank. With ``quantization="int8"`` the engine shards, then quantizes,
as the JAX engine does: the row-parallel linears' scales are the whole
weight's and their row abs-max is all-reduced, so a sharded int8 solve equals
the one-device int8 solve bit for bit (``models/modules.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from f5tts_tpu_torch.audio.preprocess import TARGET_RMS, TARGET_SR, normalize_rms, resample
from f5tts_tpu_torch.audio.stitch import crossfade_concat, crossfade_pair
from f5tts_tpu_torch.models.bigvgan import BigVGANConfig, bigvgan_decode
from f5tts_tpu_torch.models.convert import (backbone_params_from_numpy, bigvgan_params_from_numpy,
                                            vocos_params_from_numpy)
from f5tts_tpu_torch.models.dit import DiTConfig, dit_embed, dit_forward, quantize_dit_params
from f5tts_tpu_torch.models.vocos import VocosConfig, vocos_decode
from f5tts_tpu_torch.ops.mel import MelConfig, bucketed_log_mel
from f5tts_tpu_torch.sampling.euler import (EVALS_PER_STEP, SamplerConfig, default_time_grid, nfe_to_steps,
                                            sample_cfm, serving_default_sampler)
from f5tts_tpu_torch.text.chunker import chunk_text, chunk_text_packed, duration_frames, max_chars_for_ref
from f5tts_tpu_torch.text.tokenizer import Tokenizer
from f5tts_tpu_torch.utils.device import resolve_device, to_device
from f5tts_tpu_torch.utils.profiling import GLOBAL_TIMER

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class EngineConfig:
    mel: MelConfig = field(default_factory=MelConfig)
    vocoder_type: str = "vocos"  # "vocos" | "bigvgan" (pair "bigvgan" with MelConfig(flavor="bigvgan"))
    vocoder: VocosConfig = field(default_factory=VocosConfig)
    bigvgan: BigVGANConfig | None = None  # vocoder_type="bigvgan": None = BigVGANConfig(mel_dim=mel.n_mels)
    # serving default: Ralston RK2, 10 intervals (NFE 20 per branch), CFG 2
    sampler: SamplerConfig = field(default_factory=serving_default_sampler)
    duration_buckets: tuple[int, ...] = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    text_pad: int = 512
    max_duration: int = 4096
    compute_dtype: str = "bfloat16"
    quantization: str = "none"  # "none" | "int8" (W8A8 dynamic, serving-only)
    cross_fade_duration: float = 0.15
    target_rms: float = TARGET_RMS
    speed: float = 1.0
    # per-solve row caps by duration bucket (the JAX package's measured
    # values on its chip; not re-measured for the GPU yet)
    solve_batch_caps: tuple[tuple[int, int], ...] = (
        (512, 16), (768, 8), (1024, 8), (1536, 8), (2048, 8), (3072, 8), (4096, 8))
    # cap each chunk so ref + generated frames fit this bucket (None = the
    # reference's ~25 s byte budget)
    chunk_frames_budget: int | None = 1024
    # quality="strict": a row whose embedded-error estimate (RMSE over its
    # generated frames of the accumulated RK2-vs-Euler disagreement) exceeds
    # this is solved again with the exact reference recipe (euler, 32 steps);
    # the JAX package's calibrated value
    strict_threshold: float = 0.12
    min_chunk_gen_frames: int = 256
    chunk_pack_words: bool = True
    # solves queued on the card before the oldest one's results are copied to
    # the host by synthesize_rows; bounds the extra device buffers to O(depth)
    fetch_pipeline_depth: int = 3

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {self.compute_dtype!r}")
        if self.vocoder_type not in ("vocos", "bigvgan"):
            raise ValueError(f"vocoder_type must be 'vocos' or 'bigvgan', got {self.vocoder_type!r}")
        if self.quantization not in ("none", "int8"):
            raise ValueError(f"quantization must be 'none' or 'int8', got {self.quantization!r}")
        if self.fetch_pipeline_depth < 1:
            raise ValueError("fetch_pipeline_depth must be >= 1")
        # drop caps of absent buckets and snap each cap down to a batch bucket
        caps = []
        for nb, cap in self.solve_batch_caps:
            if nb not in self.duration_buckets:
                continue
            legal = [b for b in self.batch_buckets if b <= cap]
            caps.append((nb, max(legal) if legal else min(self.batch_buckets)))
        object.__setattr__(self, "solve_batch_caps", tuple(caps))


def _bucket(v: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if v <= b:
            return b
    return buckets[-1]


@dataclass
class RowSpec:
    """One utterance chunk to synthesize: its own reference voice and duration.

    With ``edit_mask`` set it is a speech-edit row: ``cond_mel`` is the whole
    edited utterance (``ref_frames == duration``), ``edit_mask`` marks the
    frames kept verbatim (False = regenerate), and the result covers the whole
    utterance from frame 0 instead of the generated tail."""

    text: str  # ref_text + gen chunk (edit rows: the full target text)
    cond_mel: np.ndarray  # (ref_frames, n_mels)
    ref_frames: int
    duration: int  # total frames incl. ref
    steps: int = 32
    cfg_strength: float = 2.0
    seed: int | None = None
    edit_mask: np.ndarray | None = None  # (duration,) bool; None = synthesis row
    quality: str = "default"  # "default" | "strict" (estimate, escalate past the threshold)


@dataclass
class RequestPlan:
    """One request's preprocessed synthesis plan."""

    rows: list[RowSpec]
    rms: float
    cross_fade_duration: float


def _shared_seed(mesh) -> int | None:
    """None (fresh entropy) without a mesh; under one, a seed drawn on rank 0
    and broadcast to every rank, so the ranks' seed generators agree."""
    if mesh is None or mesh.world == 1:
        return None
    import torch.distributed as dist

    seed = torch.tensor([int(np.random.default_rng().integers(0, 2**62))], dtype=torch.int64, device=mesh.device)
    dist.broadcast(seed, src=0)
    return int(seed.item())


class TTSEngine:
    def __init__(self, dit_params, dit_cfg: DiTConfig, vocos_params, tokenizer: Tokenizer,
                 cfg: EngineConfig = EngineConfig(), device: str | torch.device | None = None,
                 forward_fn=dit_forward, embed_fn=dit_embed, mesh=None):
        """``dit_params``/``vocos_params``: the JAX numpy params trees of the
        backbone and the vocoder (e.g. ``load_params_npz`` of an
        ``f5tpu-convert`` file, a converted torch checkpoint, or
        ``init_*_numpy``); ``vocos_params`` holds BigVGAN's tree when
        ``cfg.vocoder_type == "bigvgan"``. ``forward_fn``/``embed_fn`` are the
        backbone's (``dit_*`` or ``unett_*``; ``dit_cfg`` is its config). The
        engine keeps its serving copy on ``device`` in ``cfg.compute_dtype``.
        ``mesh``: serve tensor-parallel on the mesh's device (see the module
        docstring); every rank must make the same calls."""
        if mesh is not None:
            if device is not None and resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} differs from the mesh's {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.dit_params = backbone_params_from_numpy(dit_params, self.device, self.compute_dtype)
        if mesh is not None:
            from f5tts_tpu_torch.parallel.sharding import shard_params

            self.dit_params = shard_params(self.dit_params, mesh)
            forward_fn = functools.partial(forward_fn, tp=mesh["model"])
        if cfg.quantization == "int8":
            if "blocks" not in self.dit_params:
                raise ValueError("quantization='int8' quantizes the DiT's blocks; this backbone has none")
            # after the dtype cast and the sharding, on the device: the scales
            # come from the weights as served (rounded to bf16) and stay fp32
            self.dit_params = quantize_dit_params(self.dit_params, tp=mesh["model"] if mesh is not None else None)
        self.dit_cfg = dataclasses.replace(dit_cfg, attn_impl="flash", conv_pos_impl="fused")
        self.forward_fn, self.embed_fn = forward_fn, embed_fn
        self.tokenizer = tokenizer
        self.cfg = cfg
        if cfg.vocoder_type == "bigvgan":
            bcfg = cfg.bigvgan if cfg.bigvgan is not None else BigVGANConfig(mel_dim=cfg.mel.n_mels)
            self._upsampling = math.prod(bcfg.upsample_rates)
            self.vocos_params = bigvgan_params_from_numpy(vocos_params, self.device, self.compute_dtype)
            # the wave in fp32, as the iSTFT gives Vocos's
            self._decode = lambda vp, mel: bigvgan_decode(vp, mel, bcfg, compute_dtype=self.compute_dtype).float()
        else:
            self.vocos_params = vocos_params_from_numpy(vocos_params, self.device, self.compute_dtype)
            self._decode = lambda vp, mel: vocos_decode(vp, mel, cfg.vocoder, compute_dtype=self.compute_dtype)
        self._host_rng = np.random.default_rng(_shared_seed(mesh))
        # quality="strict" observability: recipe escalations so far, and the
        # last synthesize_rows call's per-row embedded-error estimates
        self.escalations = 0
        self.last_estimates: dict[int, float] = {}

    # ------------------------------------------------------------------
    # host-side planning
    # ------------------------------------------------------------------

    def _max_chunk_chars(self, ref_text: str, ref_secs: float, ref_frames: int, speed: float) -> int:
        """Chunker byte budget, additionally capped by ``chunk_frames_budget``
        so ref + generated frames of a full chunk fit the target bucket."""
        max_chars = max_chars_for_ref(ref_text, ref_secs)
        budget = self.cfg.chunk_frames_budget
        if budget is not None:
            if budget - ref_frames < self.cfg.min_chunk_gen_frames:
                # long reference: relax to the smallest bucket with real room
                budget = next((b for b in self.cfg.duration_buckets
                               if b - ref_frames >= self.cfg.min_chunk_gen_frames), None)
            if budget is not None:
                ref_bytes = max(len(ref_text.encode("utf-8")), 1)
                budget_frames = max(budget - ref_frames, 1)
                max_chars = min(max_chars, int(budget_frames * ref_bytes / max(ref_frames, 1) * speed))
        return max(max_chars, 1)

    def _chunk(self, gen_text: str, max_chars: int) -> list[str]:
        if self.cfg.chunk_frames_budget is not None and self.cfg.chunk_pack_words:
            return chunk_text_packed(gen_text, max_chars=max_chars)
        return chunk_text(gen_text, max_chars=max_chars)

    def _wave_samples(self, n_frames: int) -> int:
        """Samples produced for n mel frames: Vocos's centered iSTFT yields
        (n-1)*hop; BigVGAN's transposed convs yield n*prod(rates)."""
        if self.cfg.vocoder_type == "bigvgan":
            return max(n_frames * self._upsampling, 0)
        return max((n_frames - 1) * self.cfg.mel.hop_length, 0)

    def _prepare_reference(self, gen_text: str, ref_audio: np.ndarray, ref_sr: int, ref_text: str, speed: float):
        """Reference conditioning and chunking, shared by the batch and the
        streaming path so both see the same chunks: ``(cond_mel[:ref_frames],
        ref_frames, ref_text, rms, chunks)``."""
        cfg = self.cfg
        if ref_audio.ndim == 2:
            ref_audio = ref_audio.mean(axis=0)
        ref_audio, rms = normalize_rms(ref_audio, cfg.target_rms)
        if ref_sr != TARGET_SR:
            ref_audio = resample(ref_audio, ref_sr, TARGET_SR)
        ref_secs = len(ref_audio) / TARGET_SR
        if ref_text and len(ref_text[-1].encode("utf-8")) == 1:
            ref_text = ref_text + " "
        ref_frames = len(ref_audio) // cfg.mel.hop_length
        cond_mel = bucketed_log_mel(ref_audio, cfg.mel, device=self.device)
        chunks = self._chunk(gen_text, self._max_chunk_chars(ref_text, ref_secs, ref_frames, speed)) or [gen_text]
        return cond_mel[:ref_frames], ref_frames, ref_text, rms, chunks

    def prepare_request(self, gen_text: str, ref_audio: np.ndarray, ref_sr: int, ref_text: str, *,
                        speed: float | None = None, fix_duration_secs: float | None = None,
                        nfe_step: int | None = None, cfg_strength: float | None = None,
                        seed: int | None = None, cross_fade_duration: float | None = None,
                        quality: str = "default") -> RequestPlan:
        """Reference conditioning, chunking and durations -> the rows to synthesize."""
        if quality not in ("default", "strict"):
            raise ValueError(f"quality must be default|strict, got {quality!r}")
        cfg = self.cfg
        speed = speed if speed is not None else cfg.speed
        steps = nfe_to_steps(nfe_step, cfg.sampler.method) if nfe_step is not None else cfg.sampler.steps
        guidance = cfg_strength if cfg_strength is not None else cfg.sampler.cfg_strength
        xfade = cross_fade_duration if cross_fade_duration is not None else cfg.cross_fade_duration
        cond_mel, ref_frames, ref_text, rms, chunks = self._prepare_reference(gen_text, ref_audio, ref_sr, ref_text, speed)
        rows = [
            RowSpec(
                text=ref_text + c, cond_mel=cond_mel, ref_frames=ref_frames,
                duration=min(duration_frames(ref_frames, ref_text, c, speed, fix_duration_secs,
                                             cfg.mel.sample_rate, cfg.mel.hop_length), cfg.max_duration),
                steps=steps, cfg_strength=guidance, seed=seed, quality=quality,
            )
            for c in chunks
        ]
        return RequestPlan(rows=rows, rms=rms, cross_fade_duration=xfade)

    def finalize_request(self, plan: RequestPlan, results: list[tuple[np.ndarray, np.ndarray]]):
        """Per-row (wave, mel) results -> (stitched wave, sr, concatenated mel)."""
        waves = [w for w, _ in results]
        mels = [m_ for _, m_ in results]
        if plan.rms < self.cfg.target_rms:
            waves = [w * plan.rms / self.cfg.target_rms for w in waves]
        final = crossfade_concat(waves, plan.cross_fade_duration, TARGET_SR)
        mel = np.concatenate(mels, axis=0) if mels else np.zeros((0, self.cfg.mel.n_mels), np.float32)
        return final, TARGET_SR, mel

    def synthesize(self, gen_text, ref_audio, ref_sr, ref_text, **kw) -> tuple[np.ndarray, int, np.ndarray]:
        """Full text -> waveform path: returns (wave, 24000, concatenated mel)."""
        plan = self.prepare_request(gen_text, ref_audio, ref_sr, ref_text, **kw)
        return self.finalize_request(plan, self.synthesize_rows(plan.rows))

    def synthesize_streaming(self, gen_text: str, ref_audio: np.ndarray, ref_sr: int, ref_text: str, *,
                             speed: float | None = None, nfe_step: int | None = None,
                             cfg_strength: float | None = None, seed: int | None = None,
                             cross_fade_duration: float | None = None):
        """Generator of waveform segments, one per text chunk as its solve
        finishes: time to first audio is one chunk, not the whole utterance.
        Crossfade regions are blended across yields; the concatenated yields
        are the non-streaming output (each chunk solved alone instead of in a
        batch, so up to the rounding of a batch-1 solve)."""
        cfg = self.cfg
        speed = speed if speed is not None else cfg.speed
        steps = nfe_to_steps(nfe_step, cfg.sampler.method) if nfe_step is not None else cfg.sampler.steps
        guidance = cfg_strength if cfg_strength is not None else cfg.sampler.cfg_strength
        xfade = cross_fade_duration if cross_fade_duration is not None else cfg.cross_fade_duration
        n_fade = int(xfade * TARGET_SR)
        cond_mel, ref_frames, ref_text, rms, chunks = self._prepare_reference(gen_text, ref_audio, ref_sr, ref_text, speed)

        pending: np.ndarray | None = None
        for ci, c in enumerate(chunks):
            dur = min(duration_frames(ref_frames, ref_text, c, speed, None, cfg.mel.sample_rate, cfg.mel.hop_length),
                      cfg.max_duration)
            row = RowSpec(text=ref_text + c, cond_mel=cond_mel, ref_frames=ref_frames, duration=dur, steps=steps,
                          cfg_strength=guidance, seed=seed)
            wave = self.synthesize_rows([row])[0][0]
            if rms < cfg.target_rms:
                wave = wave * rms / cfg.target_rms
            merged = wave if pending is None else crossfade_pair(pending, wave, min(n_fade, len(pending), len(wave)))
            if ci < len(chunks) - 1 and n_fade > 0:
                yield merged[:-n_fade] if len(merged) > n_fade else merged[:0]
                pending = merged[-n_fade:]
            else:
                yield merged
                pending = None
        if pending is not None and len(pending):
            yield pending

    def synthesize_batch(self, chunks: list[str], cond_mel: np.ndarray, ref_frames: int, ref_text: str,
                         durations: list[int], *, steps: int, cfg_strength: float,
                         seed: int | None = None) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """One request's chunks as batched rows (input order kept): (waves, mels)."""
        rows = [RowSpec(text=ref_text + c, cond_mel=cond_mel, ref_frames=ref_frames, duration=d, steps=steps,
                        cfg_strength=cfg_strength, seed=seed) for c, d in zip(chunks, durations)]
        out = self.synthesize_rows(rows)
        return [w for w, _ in out], [m_ for _, m_ in out]

    def speech_edit(self, audio: np.ndarray, sr: int, target_text: str, parts_to_edit: list[tuple[float, float]],
                    fix_durations: list[float] | None = None, *, steps: int | None = None,
                    cfg_strength: float | None = None, seed: int | None = None) -> tuple[np.ndarray, int, np.ndarray]:
        """Regenerate the given time spans (seconds) so the utterance says
        ``target_text``; frames outside them are kept verbatim (the sampler's
        ``edit_mask``). ``fix_durations`` gives the spans new lengths: the
        resized signal is what conditions the solve. Returns (wave, 24000,
        mel) of the whole utterance."""
        row, rms = self.prepare_edit_row(audio, sr, target_text, parts_to_edit, fix_durations,
                                         steps=steps, cfg_strength=cfg_strength, seed=seed)
        wave, gen_mel = self.synthesize_rows([row])[0]
        return self.finalize_edit(row, rms, wave, gen_mel)

    def prepare_edit_row(self, audio: np.ndarray, sr: int, target_text: str,
                         parts_to_edit: list[tuple[float, float]], fix_durations: list[float] | None = None, *,
                         steps: int | None = None, cfg_strength: float | None = None,
                         seed: int | None = None) -> tuple[RowSpec, float]:
        """Host-side edit preprocessing -> a batchable edit ``RowSpec`` and the
        clip's original RMS (for ``finalize_edit``). ``steps`` counts model
        evals per guidance branch, as ``prepare_request``'s ``nfe_step``."""
        cfg = self.cfg
        hop = cfg.mel.hop_length
        steps = nfe_to_steps(steps, cfg.sampler.method) if steps is not None else cfg.sampler.steps
        guidance = cfg_strength if cfg_strength is not None else cfg.sampler.cfg_strength
        if audio.ndim == 2:
            audio = audio.mean(axis=0)
        audio, rms = normalize_rms(audio, cfg.target_rms)
        if sr != TARGET_SR:
            audio = resample(audio, sr, TARGET_SR)

        fixes = list(fix_durations) if fix_durations else None
        pieces, mask_frames = [], []
        offset = 0.0
        for start, end in parts_to_edit:
            part_dur = (end - start) if fixes is None else fixes.pop(0)
            keep = audio[round(offset * TARGET_SR) : round(start * TARGET_SR)]
            pieces += [keep, np.zeros(round(part_dur * TARGET_SR), np.float32)]
            mask_frames += [np.ones(round((start - offset) * TARGET_SR / hop), bool),
                            np.zeros(round(part_dur * TARGET_SR / hop), bool)]
            offset = end
        pieces.append(audio[round(offset * TARGET_SR) :])
        edited = np.concatenate(pieces)
        n_frames = len(edited) // hop
        edit_mask = np.concatenate(mask_frames)
        edit_mask = np.pad(edit_mask, (0, max(n_frames + 1 - len(edit_mask), 0)), constant_values=True)[:n_frames]

        nb = _bucket(min(n_frames, cfg.max_duration), cfg.duration_buckets)
        n_frames = min(n_frames, nb)  # the bucket clamps the utterance
        cond_mel = bucketed_log_mel(edited, cfg.mel, device=self.device)[:n_frames]
        row = RowSpec(text=target_text, cond_mel=cond_mel, ref_frames=n_frames, duration=n_frames, steps=steps,
                      cfg_strength=guidance,
                      seed=seed if seed is not None else int(self._host_rng.integers(2**31 - 1)),
                      edit_mask=edit_mask[:n_frames])
        return row, rms

    def finalize_edit(self, row: RowSpec, rms: float, wave: np.ndarray,
                      gen_mel: np.ndarray) -> tuple[np.ndarray, int, np.ndarray]:
        if rms < self.cfg.target_rms:
            wave = wave * rms / self.cfg.target_rms
        return wave, TARGET_SR, gen_mel

    def load_kernels(self) -> None:
        """Build and load the CUDA kernels this engine launches (on a GPU)."""
        if self.device.type == "cuda":
            from f5tts_tpu_torch.ops.kernels import _build

            names = ["flash_attention", "conv_pos"] + (["quant_matmul"] if self.cfg.quantization == "int8" else [])
            _build.build(names)
            for name in names:
                _build.load(name)

    def warmup(self, buckets: list[tuple[int, int]] | None = None, *, nfe_step: int | None = None,
               cfg_strength: float | None = None) -> None:
        """Pay the first-use costs before the first request: build and load
        the engine's CUDA kernels (on a GPU) and run each (duration, batch)
        bucket's program once. ``nfe_step`` counts model evals per guidance
        branch, as in ``prepare_request``. There is nothing to compile: eager
        PyTorch runs any shape, so this only warms allocator and library state."""
        self.load_kernels()
        steps = nfe_to_steps(nfe_step, self.cfg.sampler.method) if nfe_step is not None else self.cfg.sampler.steps
        guidance = cfg_strength if cfg_strength is not None else self.cfg.sampler.cfg_strength
        caps = dict(self.cfg.solve_batch_caps)
        dev = self.device
        for nb, bb in buckets or [(self.cfg.duration_buckets[0], self.cfg.batch_buckets[0])]:
            bb = min(bb, caps.get(nb, bb))  # synthesize_rows never runs more rows than the bucket's cap
            _, wave = self.bucket_program(
                torch.zeros((bb, nb, self.cfg.mel.n_mels), device=dev),
                torch.full((bb,), 2, dtype=torch.int32, device=dev),
                torch.full((bb, self.cfg.text_pad), -1, dtype=torch.int32, device=dev),
                torch.full((bb,), nb, dtype=torch.int32, device=dev), np.zeros((bb,), np.int64),
                steps=steps, cfg_strength=guidance)
            float(wave[:, :1].sum())  # host fetch: the program has finished

    # ------------------------------------------------------------------
    # device program
    # ------------------------------------------------------------------

    def request_sampler(self, steps: int, cfg_strength: float) -> SamplerConfig:
        """The configured sampler at a per-request (steps, guidance); a
        configured knot grid applies only at its own step count."""
        s = self.cfg.sampler
        return dataclasses.replace(
            s, steps=steps, cfg_strength=cfg_strength,
            time_grid=s.time_grid if steps == s.steps else default_time_grid(s.method, steps))

    def _supports_estimate(self) -> bool:
        """quality="strict" needs the embedded 2-stage estimate: a 2-eval
        integrator on the plain guidance path. With the euler recipe (or the
        cached/interval accelerations) configured, strict is a no-op."""
        smp = self.cfg.sampler
        return (EVALS_PER_STEP.get(smp.method) == 2 and smp.cfg_cache_period == 1
                and tuple(smp.cfg_interval) == (0.0, 1.0))

    @torch.no_grad()
    def bucket_program(self, cond: torch.Tensor, cond_lens: torch.Tensor, text: torch.Tensor,
                       duration: torch.Tensor, seeds=None, *, steps: int, cfg_strength: float,
                       y0: torch.Tensor | None = None, estimate: bool = False, recipe: bool = False,
                       edit_mask: torch.Tensor | None = None, out_start: torch.Tensor | None = None):
        """One bucket's program on device tensors: ``cond (b, n, mel)``,
        ``cond_lens (b,)``, ``text (b, nt)``, ``duration (b,)``, per-row
        ``seeds`` or explicit noise ``y0 (b, n, mel)``. Returns (generated mel
        rolled to frame ``out_start`` (default ``cond_lens``: the generated
        tail) and zeroed past each row's generated length, fp32
        ``(b, n, mel)``; fp32 waveform ``(b, samples)``: Vocos ``(n-1)*hop``,
        BigVGAN ``n*prod(rates)``) and, with ``estimate``, the per-row
        embedded error ``(b,)``. ``edit_mask
        (b, n)`` bool (False = regenerate) turns rows into edit rows, which
        pass ``out_start`` 0 to get the whole utterance. ``recipe`` solves
        with the exact reference recipe (euler, 32 steps, sway -1) whatever
        the engine's sampler: the escalation target."""
        n = cond.shape[1]
        if recipe:
            sampler = SamplerConfig(method="euler", steps=32, cfg_strength=cfg_strength, sway_sampling_coef=-1.0)
        else:
            sampler = self.request_sampler(steps, cfg_strength)
        mel_out = sample_cfm(
            self.dit_params, self.dit_cfg, cond=cond, cond_lens=cond_lens, text=text, duration=duration,
            sampler=sampler, y0=y0, seeds=seeds, edit_mask=edit_mask, compute_dtype=self.compute_dtype,
            return_error_estimate=estimate, forward_fn=self.forward_fn, embed_fn=self.embed_fn)
        if estimate:
            mel_out, est = mel_out
        start = cond_lens if out_start is None else out_start
        frames = torch.arange(n, device=cond.device)
        idx = (frames[None, :] + start[:, None]) % n
        gen = torch.gather(mel_out, 1, idx[..., None].expand(-1, -1, mel_out.shape[-1]))
        gen_len = duration - start
        gen = torch.where(frames[None, :, None] < gen_len[:, None, None], gen,
                          torch.zeros((), dtype=gen.dtype, device=gen.device))
        wave = self._decode(self.vocos_params, gen)
        return (gen.float(), wave, est) if estimate else (gen.float(), wave)

    def _pack_group(self, rows: list[RowSpec], sub: list[int], nb: int, bb: int):
        """Pack the rows at indices ``sub`` into padded host arrays; pad rows
        repeat the group's first row."""
        cfg = self.cfg
        pad_rows = bb - len(sub)
        text_ids = self.tokenizer.encode([rows[i].text for i in sub], pad_to=cfg.text_pad)
        if pad_rows:
            text_ids = np.concatenate([text_ids, np.repeat(text_ids[:1], pad_rows, 0)])
        cond = np.zeros((bb, nb, cfg.mel.n_mels), np.float32)
        cond_lens = np.empty((bb,), np.int32)
        dur = np.empty((bb,), np.int32)
        out_start = np.empty((bb,), np.int32)
        em = np.ones((bb, nb), bool)
        seeds = np.empty((bb,), np.int64)
        for row, i in enumerate(sub):
            r = rows[i]
            rf = min(r.ref_frames, nb)
            cond[row, :rf] = r.cond_mel[:rf]
            cond_lens[row] = rf
            dur[row] = min(r.duration, nb)
            if r.edit_mask is None:
                out_start[row] = rf  # synthesis: the generated tail
            else:
                out_start[row] = 0  # edit: the whole utterance
                em[row, : min(len(r.edit_mask), nb)] = r.edit_mask[:nb]
            seeds[row] = r.seed if r.seed is not None else self._host_rng.integers(2**31 - 1)
        if pad_rows:
            for a in (cond, cond_lens, dur, out_start, em, seeds):
                a[len(sub):] = a[0]
        return text_ids, cond, cond_lens, dur, out_start, em, seeds

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """Start ``t``'s copy to the host: into pinned memory without waiting
        on CUDA (read it after the solve's event), ``t`` itself on the CPU."""
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _solve_groups(self, rows: list[RowSpec], groups: dict[tuple, list[int]], *, recipe: bool = False):
        """Run each ``(bucket, steps, guidance) -> row indices`` group in capped
        batched solves. Yields ``(row index, (wave, gen mel), estimate or None)``;
        a solve estimates when a row of it is strict, none is an edit row and
        the sampler can. Up to ``fetch_pipeline_depth`` solves are queued
        before the oldest one's results are read."""
        cfg = self.cfg
        caps = dict(cfg.solve_batch_caps)
        can_estimate = not recipe and self._supports_estimate()
        dev = self.device
        in_flight: list[tuple] = []

        def fetch(entry):
            nb, bb, sub, dur, out_start, host, event = entry
            with GLOBAL_TIMER.stage(f"{'escalate' if recipe else 'sample_decode'}_n{nb}_b{bb}"):
                if event is not None:
                    event.synchronize()
                gen, wave = host[0].numpy(), host[1].numpy()
            est = host[2].numpy() if len(host) > 2 else None
            for row, i in enumerate(sub):
                gen_len = int(dur[row]) - int(out_start[row])
                yield (i, (wave[row, : self._wave_samples(gen_len)], gen[row, :gen_len]),
                       None if est is None else float(est[row]))

        for (nb, steps, guidance), idxs in groups.items():
            cap = min(caps.get(nb, cfg.batch_buckets[-1]), cfg.batch_buckets[-1])
            for start in range(0, len(idxs), cap):
                sub = idxs[start : start + cap]
                bb = _bucket(len(sub), cfg.batch_buckets)
                has_edit = any(rows[i].edit_mask is not None for i in sub)
                want_est = can_estimate and not has_edit and any(rows[i].quality == "strict" for i in sub)
                text_ids, cond, cond_lens, dur, out_start, em, seeds = self._pack_group(rows, sub, nb, bb)
                edit = ({"edit_mask": to_device(torch.from_numpy(em), dev),
                         "out_start": to_device(torch.from_numpy(out_start), dev)} if has_edit else {})
                out = self.bucket_program(
                    to_device(torch.from_numpy(cond), dev), to_device(torch.from_numpy(cond_lens), dev),
                    to_device(torch.from_numpy(text_ids), dev), to_device(torch.from_numpy(dur), dev), seeds,
                    steps=steps, cfg_strength=guidance, estimate=want_est, recipe=recipe, **edit)
                host = tuple(self._to_host(t) for t in out)
                event = None
                if dev.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
                in_flight.append((nb, bb, sub, dur, out_start, host, event))
                if len(in_flight) > cfg.fetch_pipeline_depth:
                    yield from fetch(in_flight.pop(0))
        for entry in in_flight:
            yield from fetch(entry)
    def synthesize_rows(self, rows: list[RowSpec]) -> list[tuple[np.ndarray, np.ndarray]]:
        """Row-level batched synthesis: rows may carry different reference
        voices and durations. Rows group by (duration bucket, steps, cfg); each
        group runs in capped batched solves. Returns per-row (wave, gen mel).

        Rows with ``quality="strict"`` run with the error estimate; any whose
        estimate exceeds ``cfg.strict_threshold`` is solved again with the
        exact reference recipe (euler, 32 steps; the row's seed gives the same
        noise) in a second pass."""
        cfg = self.cfg
        results: list[tuple[np.ndarray, np.ndarray] | None] = [None] * len(rows)
        self.last_estimates = {}

        def bucket_of(r: RowSpec) -> int:
            return _bucket(max(r.duration, r.ref_frames + 2), cfg.duration_buckets)

        groups: dict[tuple, list[int]] = {}
        for i, r in enumerate(rows):
            groups.setdefault((bucket_of(r), r.steps, r.cfg_strength), []).append(i)
        escalate: dict[tuple, list[int]] = {}
        for i, result, est in self._solve_groups(rows, groups):
            results[i] = result
            if est is not None:
                self.last_estimates[i] = est
                if rows[i].quality == "strict" and est > cfg.strict_threshold:
                    escalate.setdefault((bucket_of(rows[i]), 32, rows[i].cfg_strength), []).append(i)
        if escalate:
            self.escalations += sum(len(v) for v in escalate.values())
            for i, result, _ in self._solve_groups(rows, escalate, recipe=True):
                results[i] = result
        return results  # type: ignore[return-value]
