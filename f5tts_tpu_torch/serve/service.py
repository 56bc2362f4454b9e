"""Model lifecycle and request handling of the server, with no HTTP library
(counterpart of ``f5tts_tpu/serve/server.py:40-471``).

``ModelService`` loads the model a ``Settings`` names (lazily, and again after
repeated failures), swaps it, unloads it, keeps the reference voices and turns
a request into audio through the configured batcher: ``StepBatcher`` for
``batcher="step"``/``"auto"`` (auto chains a lone group's segments), the
window ``ContinuousBatcher`` otherwise, or for the Parler branch. Where the
JAX service raises an aiohttp ``web.HTTP*`` error this one raises
``ServiceError(status, body)`` with the same status and JSON body, which
``serve/server.py`` maps back to HTTP; so this module (and whatever drives it
in-process, like ``chip_smoke.py``) needs neither aiohttp nor pydantic.

Checkpoints: torch ``.pt``/``.pth``/``.bin``/``.ckpt``/``.safetensors`` files
(F5-TTS, Vocos and BigVGAN state dicts, converted by ``models/convert.py``),
``.npz`` params trees (``cli/convert.py`` or ``f5tpu-convert`` output) and
checkpoint directories of the port's ``Trainer`` (their EMA params). The
vocoder is Vocos or, with ``vocoder_type="bigvgan"``, BigVGAN with the
``bigvgan`` mel flavor, as in the JAX server. The Parler branch
(``tts_model="parler"``) reads one ParlerTTSForConditionalGeneration state
dict (``parler_ckpt``) and a local T5 tokenizer directory
(``parler_tokenizer``, through ``transformers.AutoTokenizer``), or with
``demo_tiny`` serves random weights with an ``ord(c) % vocab`` stand-in
tokenizer.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading

import numpy as np

from f5tts_tpu_torch.audio.io import read_wav, wav_bytes
from f5tts_tpu_torch.audio.preprocess import clip_ref_audio, ensure_sentence_punctuation
from f5tts_tpu_torch.engine.batcher import ContinuousBatcher, OverloadedError
from f5tts_tpu_torch.serve.schemas import SpeechRequest
from f5tts_tpu_torch.text.chunker import split_style_segments
from f5tts_tpu_torch.utils.config import Settings, parse_rate_limit

log = logging.getLogger("f5tpu.serve")

_LATIN_VOCAB = {" ": 0, **{chr(i): i - 31 for i in range(33, 127)}}


class ServiceError(Exception):
    """A request the service refuses: ``status`` is the HTTP status the
    server answers with, ``body`` its JSON body."""

    def __init__(self, status: int, body: dict):
        super().__init__(body.get("error", str(body)))
        self.status, self.body = status, body


def _not_loaded() -> ServiceError:
    return ServiceError(503, {"error": "TTS model not loaded"})


class RateLimiter:
    """Sliding-window request limit per client."""

    def __init__(self, spec: str):
        self.limit, self.window = parse_rate_limit(spec)
        self._hits: dict[str, list[float]] = {}
        self._lock = threading.Lock()

    def allow(self, client: str) -> bool:
        import time

        now = time.monotonic()
        with self._lock:
            if len(self._hits) > 4096:  # evict clients idle past the window
                self._hits = {c: h for c, h in self._hits.items() if h and now - h[-1] < self.window}
            hits = [t for t in self._hits.get(client, []) if now - t < self.window]
            allowed = len(hits) < self.limit
            if allowed:
                hits.append(now)
            self._hits[client] = hits
            return allowed


def load_checkpoint_tree(path: str, kind: str = "f5", cfg=None) -> dict:
    """The numpy params tree of a checkpoint: a torch file converted as
    ``kind`` says (``"f5"`` at ``cfg`` or F5-TTS Base's depth, ``"vocos"``,
    ``"bigvgan"`` at ``cfg`` or the default geometry), an ``.npz`` params tree
    or a ``Trainer`` checkpoint directory (its EMA params)."""
    from f5tts_tpu_torch.models import convert as C
    from f5tts_tpu_torch.models.bigvgan import BigVGANConfig
    from f5tts_tpu_torch.models.dit import DiTConfig

    if os.path.isdir(path):
        return C.load_trained_checkpoint(path)
    if path.endswith(".npz"):
        return C.load_params_npz(path)
    if path.endswith(C.TORCH_SUFFIXES):
        try:
            sd = C.load_torch_state_dict(path)
        except Exception as e:  # unpickling and safetensors errors, named with the file
            raise ValueError(f"{path}: cannot read the torch checkpoint: {e}") from e
        if kind == "f5":
            return C.convert_f5_dit(sd, cfg or DiTConfig())
        if kind == "vocos":
            return C.convert_vocos(sd)
        if kind == "bigvgan":
            return C.convert_bigvgan(sd, cfg or BigVGANConfig())
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    raise ValueError(f"{path}: not a checkpoint the port reads (torch file, .npz params tree or a Trainer "
                     "directory)")


class ModelService:
    """Model lifecycle (lazy load/unload, hot swap, one background reload
    after consecutive failures) and the request paths the routes call."""

    MAX_VOICE_SLOTS = 100

    def __init__(self, settings: Settings):
        self.settings = settings
        self.engine = None
        self.batcher = None
        self.voices: dict[str, tuple[np.ndarray, int, str]] = {}
        self.failures = 0
        self.reloads = 0
        self._reloading = False
        self._fail_lock = threading.Lock()
        # serializes load/unload/swap across the routes' executor threads and
        # the failure-recovery reload thread
        self._lifecycle = threading.RLock()

    @property
    def loaded(self) -> bool:
        return self.engine is not None

    def load(self):
        with self._lifecycle:
            self._load_locked()

    def _load_locked(self):
        if self.loaded:
            return
        if self.settings.tts_model == "parler":
            self._load_parler_locked()
            return
        from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
        from f5tts_tpu_torch.models.bigvgan import BigVGANConfig
        from f5tts_tpu_torch.models.convert import init_bigvgan_numpy, init_dit_numpy, init_vocos_numpy
        from f5tts_tpu_torch.models.dit import DiTConfig
        from f5tts_tpu_torch.models.vocos import VocosConfig
        from f5tts_tpu_torch.ops.mel import MelConfig
        from f5tts_tpu_torch.sampling.euler import DEFAULT_NFE, default_time_grid, nfe_to_steps, parse_cfg_interval
        from f5tts_tpu_torch.text.tokenizer import Tokenizer

        s = self.settings
        use_bigvgan = s.vocoder_type == "bigvgan"
        flavor = "bigvgan" if use_bigvgan else "vocos"  # the vocoder's paired mel front end
        if s.demo_tiny:
            mel_cfg = MelConfig(n_mels=20, flavor=flavor)
            dit_cfg = DiTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=256,
                                text_dim=32, conv_layers=1, max_pos=1024)
            voc_cfg = VocosConfig(input_channels=20, dim=48, intermediate_dim=96, num_layers=2)
            bcfg = BigVGANConfig.demo_tiny()
            tok = Tokenizer(_LATIN_VOCAB)
            dit_params = init_dit_numpy(dit_cfg, seed=0)
            voc_params = init_bigvgan_numpy(bcfg, seed=1) if use_bigvgan else init_vocos_numpy(voc_cfg, seed=1)
            engine_kw = dict(compute_dtype="float32", duration_buckets=(128, 256, 512), text_pad=128)
        else:
            mel_cfg, voc_cfg = MelConfig(flavor=flavor), VocosConfig()
            bcfg = BigVGANConfig(mel_dim=mel_cfg.n_mels)
            dit_params = load_checkpoint_tree(s.tts_ckpt, "f5")
            voc_params = load_checkpoint_tree(s.vocoder_ckpt, "bigvgan" if use_bigvgan else "vocos", bcfg)
            tok = Tokenizer.from_file(s.tts_vocab)
            dit_cfg = DiTConfig(text_num_embeds=tok.vocab_size)  # F5-TTS Base
            engine_kw = dict(compute_dtype=s.dtype)
        engine_cfg = EngineConfig(mel=mel_cfg, vocoder=voc_cfg, **engine_kw,
                                  **({"vocoder_type": "bigvgan", "bigvgan": bcfg} if use_bigvgan else {}))

        if s.cfg_interval or s.cfg_cache > 1 or s.ode_method or s.nfe:
            # the euler-only accelerations pick euler (Settings refuses them
            # with another explicit method)
            method = s.ode_method or ("euler" if (s.cfg_interval or s.cfg_cache > 1) else engine_cfg.sampler.method)
            steps = nfe_to_steps(s.nfe or DEFAULT_NFE[method], method)
            sampler = dataclasses.replace(
                engine_cfg.sampler, method=method, steps=steps,
                time_grid=default_time_grid(method, steps),  # grids are (method, steps)-specific
                cfg_interval=parse_cfg_interval(s.cfg_interval) if s.cfg_interval else (0.0, 1.0),
                cfg_cache_period=s.cfg_cache)
            engine_cfg = dataclasses.replace(engine_cfg, sampler=sampler)
        if s.chunk_budget != 0:  # 0 = engine default; -1 = the reference's chunking
            engine_cfg = dataclasses.replace(engine_cfg,
                                             chunk_frames_budget=s.chunk_budget if s.chunk_budget > 0 else None)
        # build into locals and publish only on full success: a failure in
        # voices or warmup must not leave a half-loaded service behind
        engine = TTSEngine(dit_params, dit_cfg, voc_params, tok, engine_cfg, device=s.device)
        del dit_params, voc_params
        voices = self._read_voices()
        want_step = s.batcher in ("step", "auto")
        if want_step and s.batcher == "auto" and engine.cfg.sampler.cfg_cache_period > 1:
            log.info("batcher=auto: cfg_cache sampler -> window batcher")
            want_step = False
        if want_step:
            from f5tts_tpu_torch.engine.step_batcher import StepBatcher

            batcher = StepBatcher(engine, s.batcher_segment_intervals, adaptive=s.batcher == "auto")
        else:
            batcher = ContinuousBatcher(engine, s.max_batch, s.batch_wait_ms)
        if s.warmup:
            buckets = self._warmup_buckets(engine)
            log.info("warming up (duration, batch) buckets %s...", buckets)
            (batcher.warmup if want_step else engine.warmup)(buckets=buckets)
        self.engine = engine
        self.batcher = batcher.start()
        self.voices = voices
        log.info("models loaded (demo_tiny=%s, batcher=%s, device=%s)", s.demo_tiny, s.batcher, engine.device)

    def _warmup_buckets(self, engine) -> list[tuple[int, int]]:
        s = self.settings
        batches = [int(v) for v in str(s.warmup_batches).split(",") if v.strip()]
        durations = [int(v) for v in str(s.warmup_buckets).split(",") if v.strip()] or [engine.cfg.duration_buckets[0]]
        for d in durations:
            if d not in engine.cfg.duration_buckets:
                raise ValueError(f"warmup bucket {d} not in engine duration buckets {engine.cfg.duration_buckets}")
        for bv in batches:
            if bv not in engine.cfg.batch_buckets:
                raise ValueError(f"warmup batch {bv} not in engine batch buckets {engine.cfg.batch_buckets}")
        return [(d, b) for d in durations for b in batches]

    def _load_parler_locked(self):
        """The autoregressive branch: a style description and a prompt in,
        44.1 kHz DAC audio out, through the window batcher."""
        from f5tts_tpu_torch.engine.ar_engine import ParlerEngineConfig, ParlerTTSEngine
        from f5tts_tpu_torch.models import parler as P

        s = self.settings
        if s.demo_tiny:
            from f5tts_tpu_torch.models.convert import init_dac_numpy, init_parler_decoder_numpy, init_t5_numpy

            t5 = P.T5Config(vocab=60, d_model=24, d_kv=6, d_ff=32, heads=4, layers=2, rel_buckets=8,
                            rel_max_dist=20)
            dec = P.ParlerDecoderConfig(vocab=40, codebooks=4, hidden=32, layers=2, heads=4, ffn=48, cross_dim=24,
                                        prompt_vocab=60)
            dac = P.DacConfig(num_codebooks=4, codebook_size=40, codebook_dim=6, latent_dim=24, decoder_dim=16,
                              rates=(4, 2))
            trees = init_t5_numpy(t5, seed=0), init_parler_decoder_numpy(dec, seed=1), init_dac_numpy(dac, seed=2)
            encode_fn = lambda txt: [ord(c) % t5.vocab for c in txt]  # noqa: E731
            ecfg = ParlerEngineConfig(max_frames=32, desc_pad=64, prompt_pad=64, temperature=0.0, eos_token=-1,
                                      compute_dtype="float32", batch_buckets=(1, 2, 4))
        else:
            if not s.parler_ckpt or not s.parler_tokenizer:
                raise ValueError("tts_model=parler needs F5TPU_PARLER_CKPT and "
                                 "F5TPU_PARLER_TOKENIZER (local T5 tokenizer dir)")
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(s.parler_tokenizer)
            encode_fn = lambda txt: tok(txt).input_ids  # noqa: E731
            t5, dec, dac = P.T5Config(), P.ParlerDecoderConfig(), P.DacConfig()
            trees = P.load_parler_checkpoint(s.parler_ckpt, t5, dec, dac)
            ecfg = ParlerEngineConfig(max_frames=s.parler_max_frames, desc_pad=s.parler_desc_pad,
                                      prompt_pad=s.parler_prompt_pad, compute_dtype=s.dtype)
        engine = ParlerTTSEngine(trees[0], t5, trees[1], dec, trees[2], dac, ecfg, encode_fn=encode_fn,
                                 device=s.device)
        if s.warmup:
            batches = [int(v) for v in str(s.warmup_batches).split(",") if v.strip()] or [1]
            engine.warmup(batches)
        self.engine = engine
        self.batcher = ContinuousBatcher(engine, s.max_batch, s.batch_wait_ms).start()
        self.voices = {}  # Parler conditions on style descriptions, not reference voices
        log.info("parler models loaded (demo_tiny=%s, device=%s)", s.demo_tiny, engine.device)

    def _read_voices(self) -> dict[str, tuple[np.ndarray, int, str]]:
        voices: dict[str, tuple[np.ndarray, int, str]] = {}
        d = self.settings.voices_dir
        if d and os.path.isdir(d):
            for name in os.listdir(d):
                if name.endswith(".wav"):
                    stem = name[:-4]
                    wav, sr = read_wav(os.path.join(d, name))
                    txt_path = os.path.join(d, stem + ".txt")
                    ref_text = open(txt_path, encoding="utf-8").read().strip() if os.path.exists(txt_path) else ""
                    voices[stem] = (clip_ref_audio(wav, sr), sr, ref_text)
        if not voices:
            # a built-in voice, so the API is usable without assets
            sr = 24000
            tone = (np.sin(2 * np.pi * 220 * np.arange(sr) / sr) * 0.1).astype(np.float32)
            voices["default"] = (tone, sr, "reference audio.")
        return voices

    def add_voice(self, name: str, wav_data: bytes, ref_text: str) -> None:
        """Register a reference voice at run time (persisted into
        ``voices_dir`` when set). The voices dict is swapped, not mutated, so
        requests in flight keep a consistent snapshot."""
        if not re.fullmatch(r"[\w.-]{1,64}", name):
            raise ValueError("voice name must be 1-64 chars of [A-Za-z0-9_.-]")
        if len(self.voices) >= self.MAX_VOICE_SLOTS and name not in self.voices:
            raise ValueError(f"voice-slot limit ({self.MAX_VOICE_SLOTS}) reached")
        wav, sr = read_wav(wav_data)
        clipped = clip_ref_audio(wav, sr)
        if self.settings.voices_dir:
            os.makedirs(self.settings.voices_dir, exist_ok=True)
            with open(os.path.join(self.settings.voices_dir, f"{name}.wav"), "wb") as f:
                f.write(wav_data)
            with open(os.path.join(self.settings.voices_dir, f"{name}.txt"), "w", encoding="utf-8") as f:
                f.write(ref_text)
        self.voices = {**self.voices, name: (clipped, sr, ref_text)}

    def remove_voice(self, name: str) -> None:
        if name not in self.voices:
            raise KeyError(name)
        if len(self.voices) == 1:
            raise ValueError("cannot remove the last voice")
        new = dict(self.voices)
        new.pop(name)
        self.voices = new
        if self.settings.voices_dir:
            for ext in (".wav", ".txt"):
                p = os.path.join(self.settings.voices_dir, name + ext)
                if os.path.exists(p):
                    os.remove(p)

    def unload(self):
        """Stop the batcher, drop every reference to the model's device
        tensors, and hand the card's cached memory (and the threads' cuBLAS
        workspaces) back."""
        with self._lifecycle:
            if self.batcher:
                self.batcher.stop()
            device = getattr(self.engine, "device", None)
            self.engine = None
            self.batcher = None
            # replace, don't clear(): requests in flight read their snapshot
            self.voices = {}
            if device is not None and device.type == "cuda":
                import gc

                import torch

                gc.collect()
                # each thread that ran a GEMM (request threads, the batcher)
                # holds a cuBLAS workspace; drop them with the model
                clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
                if clear_workspaces is not None:
                    clear_workspaces()
                torch.cuda.empty_cache()

    def swap(self, mutate_settings):
        """Unload, apply ``mutate_settings()``, load: one lifecycle-lock hold,
        so the failure-recovery reload cannot interleave."""
        with self._lifecycle:
            self.unload()
            mutate_settings()
            self._load_locked()

    # -- request paths -------------------------------------------------------

    def _voice(self, req: SpeechRequest, voices) -> str:
        voice = req.voice or next(iter(voices))
        if voice not in voices:
            raise ServiceError(400, {"error": f"unknown voice {voice!r}"})
        return voice

    def _fail(self, e: Exception) -> ServiceError:
        """The status of a failed solve: 503 for load shedding, else a model
        fault that counts toward the automatic reload."""
        if isinstance(e, OverloadedError):
            return ServiceError(503, {"error": str(e)})
        self._record_failure(e)
        return ServiceError(500, {"error": f"synthesis failed: {e}"})

    def _succeeded(self) -> None:
        with self._fail_lock:
            self.failures = 0

    def synthesize_sync(self, req: SpeechRequest) -> bytes:
        """A whole request -> WAV bytes. ``{Style}``/``[voice]`` tags switch
        the reference voice per segment; every chunk row of every segment
        goes through the batcher, so concurrent requests share solves."""
        if self.settings.tts_model == "parler":
            return self._synthesize_parler_sync(req)
        # snapshot: a concurrent unload or swap replaces the attributes, and
        # work in flight finishes against the old objects
        engine, batcher, voices = self.engine, self.batcher, self.voices
        if engine is None or batcher is None or not voices:
            raise _not_loaded()
        voice = self._voice(req, voices)
        segments = split_style_segments(req.effective_text, voices, default=voice)
        try:
            plans = []
            for seg_voice, seg_text in segments:
                ref_audio, ref_sr, ref_text = voices[seg_voice]
                if seg_voice == voice and req.ref_text:
                    ref_text = req.ref_text
                plans.append(engine.prepare_request(
                    seg_text, ref_audio, ref_sr, ensure_sentence_punctuation(ref_text), speed=req.speed,
                    nfe_step=req.nfe_step, cfg_strength=req.cfg_strength, seed=req.seed, quality=req.quality))
            futures = [[batcher.submit(row) for row in plan.rows] for plan in plans]
            waves = []
            for plan, fs in zip(plans, futures):
                seg_wave, sr, _ = engine.finalize_request(plan, [f.result(timeout=600) for f in fs])
                waves.append(seg_wave)
            wave = waves[0] if len(waves) == 1 else np.concatenate(waves)
            if not np.isfinite(wave).all():
                # a NaN/Inf solve fails this request (and counts toward the
                # reload): never ship non-finite PCM
                raise RuntimeError("non-finite audio from solve (NaN/Inf): model fault")
        except ServiceError:
            raise
        except Exception as e:
            raise self._fail(e) from e
        self._succeeded()
        return wav_bytes(wave, sr)

    def _synthesize_parler_sync(self, req: SpeechRequest) -> bytes:
        from f5tts_tpu_torch.engine.ar_engine import ParlerRow

        engine, batcher = self.engine, self.batcher
        if engine is None or batcher is None:
            raise _not_loaded()
        desc = req.description or self.settings.parler_default_description
        try:
            # before batching: an oversized request fails alone, not its group
            engine.validate_lengths(desc, req.effective_text)
        except ValueError as e:
            raise ServiceError(400, {"error": str(e)}) from e
        try:
            wave, _ = batcher.submit(ParlerRow(desc, req.effective_text, seed=req.seed or 0)).result(timeout=600)
            if not np.isfinite(wave).all():
                raise RuntimeError("non-finite audio from decode (NaN/Inf): model fault")
        except ValueError as e:  # the strict length check inside the batch
            raise ServiceError(400, {"error": str(e)}) from e
        except Exception as e:
            raise self._fail(e) from e
        self._succeeded()
        return wav_bytes(wave, engine.dac_cfg.sampling_rate)

    def stream_segments(self, req: SpeechRequest):
        """Validate a streamed request and return ``(sample_rate, segments)``:
        ``segments()`` yields float32 PCM arrays as each text chunk's solve
        (or each Parler decode window) finishes; their concatenation is the
        request's audio."""
        engine = self.engine
        if self.settings.tts_model == "parler":
            if engine is None:
                raise _not_loaded()
            desc = req.description or self.settings.parler_default_description
            try:
                engine.validate_lengths(desc, req.effective_text)
            except ValueError as e:
                raise ServiceError(400, {"error": str(e)}) from e
            return engine.dac_cfg.sampling_rate, lambda: engine.synthesize_streaming(
                desc, req.effective_text, seed=req.seed or 0)
        voices = self.voices
        if engine is None or not voices:
            raise _not_loaded()
        ref_audio, ref_sr, ref_text = voices[self._voice(req, voices)]
        ref_text = ensure_sentence_punctuation(req.ref_text or ref_text)
        return 24000, lambda: engine.synthesize_streaming(
            req.effective_text, ref_audio, ref_sr, ref_text, speed=req.speed, nfe_step=req.nfe_step,
            cfg_strength=req.cfg_strength, seed=req.seed)

    def speech_edit_sync(self, audio: np.ndarray, sr: int, target_text: str, parts: list[tuple[float, float]],
                         fixes: list[float] | None = None, *, nfe_step: int | None = None,
                         cfg_strength: float = 2.0, seed: int | None = None) -> tuple[np.ndarray, int]:
        """Regenerate ``parts`` (seconds) of an utterance to say
        ``target_text``; the edit row rides the batcher, sharing solves with
        synthesis traffic. Returns (wave, sample rate)."""
        engine, batcher = self.engine, self.batcher
        if engine is None or batcher is None:
            raise _not_loaded()
        row, rms = engine.prepare_edit_row(audio, sr, target_text, parts, fixes, steps=nfe_step,
                                           cfg_strength=cfg_strength, seed=seed)
        wave, gen_mel = batcher.submit(row).result(timeout=600)
        wave, out_sr, _ = engine.finalize_edit(row, rms, wave, gen_mel)
        return wave, out_sr

    def _record_failure(self, exc: Exception, threshold: int = 2):
        """Consecutive device or runtime failures -> one background reload."""
        log.error("synthesis failure: %s", exc)
        with self._fail_lock:
            self.failures += 1
            should_reload = self.failures >= threshold and not self._reloading
            if should_reload:
                self._reloading = True
        if should_reload:
            def _do():
                try:
                    log.warning("reloading models after %d consecutive failures", self.failures)
                    with self._lifecycle:  # the pair, so no unload/swap interleaves
                        self.unload()
                        self.load()
                    self.reloads += 1
                    with self._fail_lock:
                        self.failures = 0
                finally:
                    self._reloading = False

            threading.Thread(target=_do, name="model-reload", daemon=True).start()
