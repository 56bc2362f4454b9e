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
  -> ``vocos_decode``.

The engine keeps a bf16 serving copy of the parameters and runs the DiT with
``attn_impl="flash"`` and ``conv_pos_impl="fused"``: on a GPU those are the
hand-written CUDA kernels, on the CPU their plain versions. Edit rows,
``quality="strict"`` escalation, streaming and multi-device serving are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from f5tts_tpu_torch.audio.preprocess import TARGET_RMS, TARGET_SR, normalize_rms, resample
from f5tts_tpu_torch.audio.stitch import crossfade_concat
from f5tts_tpu_torch.models.convert import dit_params_from_numpy, vocos_params_from_numpy
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.models.vocos import VocosConfig, vocos_decode
from f5tts_tpu_torch.ops.mel import MelConfig, bucketed_log_mel
from f5tts_tpu_torch.sampling.euler import (SamplerConfig, default_time_grid, nfe_to_steps, sample_cfm,
                                            serving_default_sampler)
from f5tts_tpu_torch.text.chunker import chunk_text, chunk_text_packed, duration_frames, max_chars_for_ref
from f5tts_tpu_torch.text.tokenizer import Tokenizer
from f5tts_tpu_torch.utils.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class EngineConfig:
    mel: MelConfig = field(default_factory=MelConfig)
    vocoder: VocosConfig = field(default_factory=VocosConfig)
    # serving default: Ralston RK2, 10 intervals (NFE 20 per branch), CFG 2
    sampler: SamplerConfig = field(default_factory=serving_default_sampler)
    duration_buckets: tuple[int, ...] = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    text_pad: int = 512
    max_duration: int = 4096
    compute_dtype: str = "bfloat16"
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
    min_chunk_gen_frames: int = 256
    chunk_pack_words: bool = True

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {self.compute_dtype!r}")
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
    """One utterance chunk to synthesize: its own reference voice and duration."""

    text: str  # ref_text + gen chunk
    cond_mel: np.ndarray  # (ref_frames, n_mels)
    ref_frames: int
    duration: int  # total frames incl. ref
    steps: int = 32
    cfg_strength: float = 2.0
    seed: int | None = None


@dataclass
class RequestPlan:
    """One request's preprocessed synthesis plan."""

    rows: list[RowSpec]
    rms: float
    cross_fade_duration: float


class TTSEngine:
    def __init__(self, dit_params, dit_cfg: DiTConfig, vocos_params, tokenizer: Tokenizer,
                 cfg: EngineConfig = EngineConfig(), device: str | torch.device | None = None):
        """``dit_params``/``vocos_params``: the JAX numpy params trees (e.g.
        ``load_params_npz`` of an ``f5tpu-convert`` file, or ``init_*_numpy``).
        The engine keeps its serving copy on ``device`` in ``cfg.compute_dtype``."""
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.dit_params = dit_params_from_numpy(dit_params, self.device, self.compute_dtype)
        self.vocos_params = vocos_params_from_numpy(vocos_params, self.device, self.compute_dtype)
        self.dit_cfg = dataclasses.replace(dit_cfg, attn_impl="flash", conv_pos_impl="fused")
        self.tokenizer = tokenizer
        self.cfg = cfg
        self._host_rng = np.random.default_rng()

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
        """Samples produced for n mel frames: the centered iSTFT yields (n-1)*hop."""
        return max((n_frames - 1) * self.cfg.mel.hop_length, 0)

    def prepare_request(self, gen_text: str, ref_audio: np.ndarray, ref_sr: int, ref_text: str, *,
                        speed: float | None = None, fix_duration_secs: float | None = None,
                        nfe_step: int | None = None, cfg_strength: float | None = None,
                        seed: int | None = None, cross_fade_duration: float | None = None,
                        quality: str = "default") -> RequestPlan:
        """Reference conditioning, chunking and durations -> the rows to synthesize."""
        if quality != "default":
            raise NotImplementedError("quality='strict' escalation is not ported to the PyTorch engine yet")
        cfg = self.cfg
        speed = speed if speed is not None else cfg.speed
        steps = nfe_to_steps(nfe_step, cfg.sampler.method) if nfe_step is not None else cfg.sampler.steps
        guidance = cfg_strength if cfg_strength is not None else cfg.sampler.cfg_strength
        xfade = cross_fade_duration if cross_fade_duration is not None else cfg.cross_fade_duration

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
        rows = [
            RowSpec(
                text=ref_text + c, cond_mel=cond_mel[:ref_frames], ref_frames=ref_frames,
                duration=min(duration_frames(ref_frames, ref_text, c, speed, fix_duration_secs,
                                             cfg.mel.sample_rate, cfg.mel.hop_length), cfg.max_duration),
                steps=steps, cfg_strength=guidance, seed=seed,
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

    @torch.no_grad()
    def bucket_program(self, cond: torch.Tensor, cond_lens: torch.Tensor, text: torch.Tensor,
                       duration: torch.Tensor, seeds=None, *, steps: int, cfg_strength: float,
                       y0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """One bucket's program on device tensors: ``cond (b, n, mel)``,
        ``cond_lens (b,)``, ``text (b, nt)``, ``duration (b,)``, per-row
        ``seeds`` or explicit noise ``y0 (b, n, mel)``. Returns (generated mel
        rolled to frame 0 and zeroed past each row's generated length, fp32
        ``(b, n, mel)``; waveform ``(b, (n-1)*hop)`` fp32)."""
        n = cond.shape[1]
        mel_out = sample_cfm(
            self.dit_params, self.dit_cfg, cond=cond, cond_lens=cond_lens, text=text, duration=duration,
            sampler=self.request_sampler(steps, cfg_strength), y0=y0, seeds=seeds,
            compute_dtype=self.compute_dtype)
        frames = torch.arange(n, device=cond.device)
        idx = (frames[None, :] + cond_lens[:, None]) % n
        gen = torch.gather(mel_out, 1, idx[..., None].expand(-1, -1, mel_out.shape[-1]))
        gen_len = duration - cond_lens
        gen = torch.where(frames[None, :, None] < gen_len[:, None, None], gen,
                          torch.zeros((), dtype=gen.dtype, device=gen.device))
        wave = vocos_decode(self.vocos_params, gen, self.cfg.vocoder, compute_dtype=self.compute_dtype)
        return gen.float(), wave

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
        seeds = np.empty((bb,), np.int64)
        for row, i in enumerate(sub):
            r = rows[i]
            rf = min(r.ref_frames, nb)
            cond[row, :rf] = r.cond_mel[:rf]
            cond_lens[row] = rf
            dur[row] = min(r.duration, nb)
            seeds[row] = r.seed if r.seed is not None else self._host_rng.integers(2**31 - 1)
        if pad_rows:
            for a in (cond, cond_lens, dur, seeds):
                a[len(sub):] = a[0]
        return text_ids, cond, cond_lens, dur, seeds

    def synthesize_rows(self, rows: list[RowSpec]) -> list[tuple[np.ndarray, np.ndarray]]:
        """Row-level batched synthesis: rows may carry different reference
        voices and durations. Rows group by (duration bucket, steps, cfg); each
        group runs in capped batched solves. Returns per-row (wave, gen mel)."""
        cfg = self.cfg
        results: list[tuple[np.ndarray, np.ndarray] | None] = [None] * len(rows)
        groups: dict[tuple, list[int]] = {}
        for i, r in enumerate(rows):
            nb = _bucket(max(r.duration, r.ref_frames + 2), cfg.duration_buckets)
            groups.setdefault((nb, r.steps, r.cfg_strength), []).append(i)
        caps = dict(cfg.solve_batch_caps)
        for (nb, steps, guidance), idxs in groups.items():
            cap = min(caps.get(nb, cfg.batch_buckets[-1]), cfg.batch_buckets[-1])
            for start in range(0, len(idxs), cap):
                sub = idxs[start : start + cap]
                bb = _bucket(len(sub), cfg.batch_buckets)
                text_ids, cond, cond_lens, dur, seeds = self._pack_group(rows, sub, nb, bb)
                dev = self.device
                gen, wave = self.bucket_program(
                    torch.as_tensor(cond, device=dev), torch.as_tensor(cond_lens, device=dev),
                    torch.as_tensor(text_ids, device=dev), torch.as_tensor(dur, device=dev), seeds,
                    steps=steps, cfg_strength=guidance)
                gen, wave = gen.cpu().numpy(), wave.cpu().numpy()
                for row, i in enumerate(sub):
                    gen_len = int(dur[row]) - int(cond_lens[row])
                    results[i] = (wave[row, : self._wave_samples(gen_len)], gen[row, :gen_len])
        return results  # type: ignore[return-value]
