"""The two autoregressive engines (counterpart of
``f5tts_tpu/engine/ar_engine.py``).

``ARTTSEngine`` serves the AR mel decoder of ``models/ar.py``: tokenize the
text, generate mel frames at a fixed frame budget with the KV-cache decode,
zero the frames past each row's predicted length, vocode with Vocos, trim.
It shares the tokenizer and Vocos with the flow engine.

``ParlerTTSEngine`` serves the ParlerTTS architecture: style description +
text -> 44.1 kHz waveform. T5-encode the description, generate DAC codes with
the delay-pattern KV-cache decode, vocode with the DAC decoder. It runs the
decode step's cache attention through ``ops/kernels/decode_attention.py``
(``decode_attn="kernel"``: the CUDA kernel on a GPU, the plain version on the
CPU). Each batch it decodes is traced in ``GLOBAL_TIMER`` (the ``parler.*``
names that ``utils/profiling.py`` lists).

Each engine keeps a serving copy of its parameters on its device in
``cfg.compute_dtype``. PyTorch runs eagerly, so there is nothing to compile
per (batch, frames) bucket: the JAX engines' program caches have no
counterpart, the batch buckets only bound the shapes the card sees, and the
streaming path's tail segment is not padded. (On a card the Parler decode
captures its step in a CUDA graph once a call, ``models/parler.py``.)
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from f5tts_tpu_torch.models import parler as P
from f5tts_tpu_torch.models.ar import ARConfig, ar_generate
from f5tts_tpu_torch.models.convert import ar_params_from_numpy, parler_params_from_numpy, vocos_params_from_numpy
from f5tts_tpu_torch.models.vocos import VocosConfig, vocos_decode
from f5tts_tpu_torch.utils.device import resolve_device
from f5tts_tpu_torch.utils.profiling import GLOBAL_TIMER

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class AREngineConfig:
    vocoder: VocosConfig = field(default_factory=VocosConfig)
    text_pad: int = 256
    max_frames: int = 1024
    hop_length: int = 256
    sample_rate: int = 24000
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {self.compute_dtype!r}")


class ARTTSEngine:
    """Batched serving wrapper over ``models/ar.py:ar_generate`` + Vocos."""

    def __init__(self, ar_params, ar_cfg: ARConfig, vocos_params, tokenizer, cfg: AREngineConfig = AREngineConfig(),
                 device: str | torch.device | None = None):
        """``ar_params`` / ``vocos_params``: the JAX package's numpy params
        trees (or ``init_ar_numpy`` / ``init_vocos_numpy``); ``tokenizer``:
        ``text/tokenizer.py:Tokenizer``."""
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.ar_params = ar_params_from_numpy(ar_params, self.device, self.compute_dtype)
        self.vocos_params = vocos_params_from_numpy(vocos_params, self.device, self.compute_dtype)
        self.ar_cfg, self.tokenizer, self.cfg = ar_cfg, tokenizer, cfg

    @torch.no_grad()
    def synthesize_batch(self, texts: list[str]) -> list[np.ndarray]:
        """One wave per text (float32 at ``cfg.sample_rate``), trimmed to
        ``(length - 1) * hop_length`` samples of the row's generated length."""
        cfg = self.cfg
        ids = torch.as_tensor(self.tokenizer.encode(texts, pad_to=cfg.text_pad), device=self.device)
        mel, lengths = ar_generate(self.ar_params, self.ar_cfg, ids, cfg.max_frames, compute_dtype=self.compute_dtype)
        keep = torch.arange(cfg.max_frames, device=self.device)[None, :, None] < lengths[:, None, None]
        wave = vocos_decode(self.vocos_params, torch.where(keep, mel, 0.0), cfg.vocoder,
                            compute_dtype=self.compute_dtype).float().cpu().numpy()
        lengths = lengths.cpu().numpy()
        return [wave[i, : max((int(lengths[i]) - 1) * cfg.hop_length, 0)] for i in range(len(texts))]


@dataclass(frozen=True)
class ParlerEngineConfig:
    max_frames: int = 256
    desc_pad: int = 64
    prompt_pad: int = 64
    temperature: float = 1.0
    top_k: int = 0
    eos_token: int = 1024
    compute_dtype: str = "bfloat16"
    # batch sizes snapped up to these when serving rows (the JAX package's
    # list; which bucket serves best on the GPU has not been measured)
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    # streaming: decode segment length (code-stream positions per call) and
    # the DAC receptive-field margin (latent frames withheld until the window
    # around them is final, which makes streamed PCM equal the batch path)
    stream_frames: int = 64
    stream_margin_frames: int = 32
    # overrides applied onto the decoder config (None = keep the decoder's own
    # value): one fused q|k|v matmul per decode step, and the decode-step
    # attention ("kernel" | "plain", see ParlerDecoderConfig.decode_attn)
    fuse_decode_qkv: bool | None = True
    decode_attn: str | None = None

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {self.compute_dtype!r}")


@dataclass
class ParlerRow:
    """One serving request for the AR branch: a style description + the text
    to speak (the ParlerTTS contract: no reference audio)."""

    description: str
    prompt: str
    seed: int = 0


class ParlerTTSEngine:
    """Batched serving wrapper over ``models/parler.py``.

    Token ids come from the caller (the real checkpoint's T5 tokenizer is a
    sentencepiece asset that ships with the weights; any per-string callable
    ``text -> list[int]`` plugs in via ``encode_fn``; padding and masking are
    handled here)."""

    def __init__(self, t5_params, t5_cfg: P.T5Config, dec_params, dec_cfg: P.ParlerDecoderConfig, dac_params,
                 dac_cfg: P.DacConfig, cfg: ParlerEngineConfig = ParlerEngineConfig(), encode_fn=None,
                 device: str | torch.device | None = None):
        """``t5_params``/``dec_params``/``dac_params``: the JAX package's numpy
        params trees (or ``init_*_numpy``)."""
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.t5_params, self.dec_params, self.dac_params = parler_params_from_numpy(
            t5_params, dec_params, dac_params, self.device, self.compute_dtype)
        overrides = {k: v for k, v in (("fuse_decode_qkv", cfg.fuse_decode_qkv), ("decode_attn", cfg.decode_attn))
                     if v is not None}
        self.t5_cfg, self.dec_cfg, self.dac_cfg = t5_cfg, dataclasses.replace(dec_cfg, **overrides), dac_cfg
        self.cfg = cfg
        self.encode_fn = encode_fn
        # Style-description encoder cache: deployments serve a small set of
        # named voices/styles, so repeated descriptions skip the T5. Keyed by
        # the exact (truncated) token-id tuple; the value is a device-resident
        # (desc_pad, hidden) row, so a hit costs no host round trip.
        self._desc_cache: OrderedDict = OrderedDict()
        self.desc_cache_max = 256
        self.desc_cache_hits = 0
        self.desc_cache_misses = 0

    def _pad_ids(self, ids_list, pad_to, side: str = "right"):
        """Prompts pad LEFT (official ParlerTTS batched inference: every
        prompt abuts the decoder start so sinusoidal position indices match
        the trained layout); descriptions pad right (standard T5 encoder)."""
        b = len(ids_list)
        out = np.zeros((b, pad_to), np.int32)
        mask = np.zeros((b, pad_to), bool)
        for i, ids in enumerate(ids_list):
            ids = np.asarray(ids, np.int32)
            if side == "left":
                # over-long prompts keep their TAIL: the tokens abutting the
                # decoder start are the ones the position layout depends on
                ids = ids[-pad_to:]
                out[i, pad_to - len(ids):] = ids
                mask[i, pad_to - len(ids):] = True
            else:
                ids = ids[:pad_to]
                out[i, : len(ids)] = ids
                mask[i, : len(ids)] = True
        return out, mask

    def _to_device(self, *arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def _encode(self, desc, desc_mask):
        with torch.no_grad():
            return P.t5_encode(self.t5_params, self.t5_cfg, desc, desc_mask, compute_dtype=self.compute_dtype)

    @staticmethod
    def _check_budget(n_desc: int, n_prompt: int, desc_pad: int, prompt_pad: int, row: str = "") -> None:
        if n_desc > desc_pad:
            raise ValueError(f"description{row} is {n_desc} tokens, over the {desc_pad}-token budget")
        if n_prompt > prompt_pad:
            raise ValueError(f"text{row} is {n_prompt} tokens, over the {prompt_pad}-token budget: "
                             "split the request into shorter utterances")

    def _encode_inputs(self, descriptions, prompts):
        """Token ids (``encode_fn`` applied to strings), padded and masked on
        the device: ``(descriptions, prompts, desc, desc_mask, prompt,
        prompt_mask)``, the first two as id lists."""
        cfg = self.cfg
        if self.encode_fn is not None:
            descriptions = [self.encode_fn(d) for d in descriptions]
            prompts = [self.encode_fn(p) for p in prompts]
        desc, desc_mask = self._pad_ids(descriptions, cfg.desc_pad)
        prompt, prompt_mask = self._pad_ids(prompts, cfg.prompt_pad, side="left")
        return (descriptions, prompts, *self._to_device(desc, desc_mask, prompt, prompt_mask))

    def synthesize_batch(self, descriptions, prompts, seed: int = 0, frames: int | None = None, row_seeds=None,
                         strict_lengths: bool = False, with_codes: bool = False):
        """descriptions/prompts: lists of token-id sequences (or raw strings
        when ``encode_fn`` is set). Returns float32 waves at the DAC rate,
        trimmed to each row's predicted length; with ``with_codes``, ``(waves,
        codes)``: also each row's de-delayed codes, ``(K, length)`` int64 on
        the host, the tokens the decoder drew before the DAC's clamp of special
        tokens (``finalize_codes``), so that ``build_delay_pattern`` of them
        gives back the stream the decode fed itself.

        ``row_seeds`` (one int per row) makes each row's sampling stream
        independent of batch composition; ``seed`` alone keys the whole batch.
        ``strict_lengths`` raises instead of silently clipping rows whose
        encoded prompt/description exceed the pad budgets (serving turns this
        on: an answer with the head of the text missing is worse than an
        error)."""
        if len(descriptions) != len(prompts):
            raise ValueError(f"descriptions ({len(descriptions)}) and prompts ({len(prompts)}) "
                             "must pair up row-for-row")
        cfg = self.cfg
        descriptions, prompts, desc, desc_mask, prompt, prompt_mask = self._encode_inputs(descriptions, prompts)
        if strict_lengths:
            for i, (d, pr) in enumerate(zip(descriptions, prompts)):
                self._check_budget(len(d), len(pr), cfg.desc_pad, cfg.prompt_pad, f" of row {i}")
        frames = cfg.max_frames if frames is None else frames
        b = len(descriptions)
        GLOBAL_TIMER.add("parler.flushes")
        GLOBAL_TIMER.add("parler.rows", b)
        enc = self._cached_encode(descriptions, desc, desc_mask)
        with GLOBAL_TIMER.stage("parler.prefill"):
            ctx = P.parler_prefill(self.dec_params, self.dec_cfg, enc, desc_mask, frames, seed, prompt_ids=prompt,
                                   prompt_mask=prompt_mask, eos_token=cfg.eos_token, temperature=cfg.temperature,
                                   top_k=cfg.top_k, row_seeds=row_seeds, compute_dtype=self.compute_dtype)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if self.device.type == "cuda" else None
        with GLOBAL_TIMER.stage("parler.decode"):
            if events:
                events[0].record()  # before the loop's first launch
            stream, eos_frame = P.parler_decode_positions(ctx)
            if events:
                events[1].record()  # after its last
        GLOBAL_TIMER.add("parler.positions", ctx.steps)
        GLOBAL_TIMER.add("parler.row_positions", b * ctx.steps)
        drawn = P.revert_delay_pattern(stream, frames)
        codes, lengths = P.finalize_codes(drawn, eos_frame, self.dec_cfg, self.dac_cfg.codebook_size)
        with GLOBAL_TIMER.stage("parler.dac"):
            wave = P.dac_decode_codes(self.dac_params, codes, self.dac_cfg, compute_dtype=self.compute_dtype)
        GLOBAL_TIMER.add("parler.frames", b * frames)
        with GLOBAL_TIMER.stage("parler.finalize"):
            wave = wave.float().cpu().numpy()
            lengths = lengths.cpu().numpy()
            waves = [wave[i, : int(lengths[i]) * self.dac_cfg.hop] for i in range(b)]
            if with_codes:
                drawn = drawn.cpu().numpy()
                row_codes = [drawn[i, :, : int(lengths[i])] for i in range(b)]
        if events:  # the host copies above have synchronised
            GLOBAL_TIMER.record("parler.decode_device", events[0].elapsed_time(events[1]) * 1e-3)
        return (waves, row_codes) if with_codes else waves

    def _cached_encode(self, descriptions, desc, desc_mask):
        """The T5 states of the rows' descriptions: from the description cache
        when every row's style is in it, else the T5 over the whole batch."""
        cfg = self.cfg
        # key on the TRUNCATED ids: _pad_ids clips to desc_pad, so anything
        # past it never reaches the T5
        keys = [tuple(np.asarray(d, np.int32)[: cfg.desc_pad].tolist()) for d in descriptions]
        if all(k in self._desc_cache for k in keys):
            # every row's style is cached: skip the T5
            self.desc_cache_hits += len(keys)
            GLOBAL_TIMER.add("parler.desc_cache_hits", len(keys))
            enc = torch.stack([self._desc_cache[k] for k in keys])
            for k in keys:
                self._desc_cache.move_to_end(k)
            return enc
        self.desc_cache_misses += len(keys)
        with GLOBAL_TIMER.stage("parler.encode"):
            enc = self._encode(desc, desc_mask)
        GLOBAL_TIMER.add("parler.encode_rows", len(keys))
        for i, k in enumerate(keys):
            self._desc_cache[k] = enc[i]
            self._desc_cache.move_to_end(k)
        while len(self._desc_cache) > self.desc_cache_max:
            self._desc_cache.popitem(last=False)
        return enc

    def replay_logits(self, rows: list[ParlerRow], codes: list[np.ndarray], asked) -> torch.Tensor:
        """fp32 logits of the cached decode path at the batch of ``rows``,
        teacher-forced on each row's ``codes`` (``(K, length)`` as
        ``synthesize_rows`` returned them; pad past the length): ``(len(asked),
        steps, K, vocab)`` for the rows ``asked`` (``P.parler_replay_logits``).
        The description states come from the T5 itself, not its cache."""
        _, _, desc, desc_mask, prompt, prompt_mask = self._encode_inputs([r.description for r in rows],
                                                                         [r.prompt for r in rows])
        K, frames = self.dec_cfg.codebooks, self.cfg.max_frames
        pad = self.dec_cfg.vocab  # the decode's pad: BOS, the code embedding's extra row
        full = np.full((len(rows), K, frames), pad, np.int64)
        for i, c in enumerate(codes):
            full[i, :, : c.shape[1]] = c
        stream = torch.as_tensor(P.build_delay_pattern(full, pad, frames + K - 1), device=self.device)
        return P.parler_replay_logits(self.dec_params, self.dec_cfg, self._encode(desc, desc_mask), desc_mask, stream,
                                      asked, prompt_ids=prompt, prompt_mask=prompt_mask,
                                      compute_dtype=self.compute_dtype)

    def synthesize_rows(self, rows: list[ParlerRow]) -> list[tuple[np.ndarray, np.ndarray]]:
        """Row-level batched synthesis (the ``ContinuousBatcher`` primitive):
        co-arriving requests share one decode. Batches are split at
        ``batch_buckets[-1]`` and snapped UP to the next bucket by repeating
        the last row; per-row masks isolate rows, and ``ParlerRow.seed`` keys
        each row's own sampling stream, so outputs don't depend on which rows
        happened to co-batch. Returns per row ``(wave, codes)``, ``codes`` its
        de-delayed ``(K, length)`` tokens (``synthesize_batch(with_codes=True)``)."""
        results: list[tuple[np.ndarray, np.ndarray]] = []
        top = self.cfg.batch_buckets[-1]
        for start in range(0, len(rows), top):
            sub = rows[start : start + top]
            bucket = next(v for v in self.cfg.batch_buckets if v >= len(sub))
            padded = sub + [sub[-1]] * (bucket - len(sub))
            waves, codes = self.synthesize_batch(
                [r.description for r in padded], [r.prompt for r in padded],
                row_seeds=[r.seed for r in padded], strict_lengths=True, with_codes=True)
            results.extend(zip(waves[: len(sub)], codes[: len(sub)]))
        return results

    def synthesize_streaming(self, description, prompt, seed: int = 0, frames: int | None = None):
        """Generator of PCM segments for ONE request: the AR decode is
        incremental, so audio streams as codes become final instead of after
        the whole utterance.

        Concatenating every yield equals ``synthesize_batch([description],
        [prompt], row_seeds=[seed])[0]``. Two mechanisms make that hold:
        per-(seed, position) sampling streams (segmentation-invariant tokens),
        and DAC windows with ``stream_margin_frames`` of context on each side:
        a latent frame's samples are only emitted once every code within the
        decoder's receptive field is final. ``eos_frame`` is read to the host
        once per segment."""
        cfg = self.cfg
        if self.encode_fn is not None:
            d_ids, p_ids = self.encode_fn(description), self.encode_fn(prompt)
        else:
            d_ids, p_ids = description, prompt
        self._check_budget(len(d_ids), len(p_ids), cfg.desc_pad, cfg.prompt_pad)
        desc, desc_mask = self._pad_ids([d_ids], cfg.desc_pad)
        pr, pr_mask = self._pad_ids([p_ids], cfg.prompt_pad, side="left")
        desc, desc_mask, pr, pr_mask = self._to_device(desc, desc_mask, pr, pr_mask)
        frames = cfg.max_frames if frames is None else frames
        K = self.dec_cfg.codebooks
        steps = frames + K - 1
        seg = cfg.stream_frames
        margin = cfg.stream_margin_frames
        max_code = self.dac_cfg.codebook_size
        hop = self.dac_cfg.hop

        enc = self._encode(desc, desc_mask)
        carry = None
        toks_all = np.zeros((steps, 1, K), np.int64)
        n_done = 0  # decoded code-stream positions
        emitted = 0  # latent frames already emitted as PCM

        for j0 in range(1, steps + 1, seg):
            real = min(seg, steps + 1 - j0)
            carry, toks = P.parler_decode_segment(
                self.dec_params, self.dec_cfg, enc, desc_mask, frames, range(j0, j0 + real), carry,
                prompt_ids=pr, prompt_mask=pr_mask, eos_token=cfg.eos_token, temperature=cfg.temperature,
                top_k=cfg.top_k, row_seeds=[seed], compute_dtype=self.compute_dtype)
            toks_all[n_done : n_done + real] = toks.cpu().numpy()
            n_done += real
            eos = int(carry[3][0])
            # frame f is final once codebook K-1 emitted at position f+K
            done = min(max(n_done - K + 1, 0), frames, eos)
            finished = (n_done == steps) or (done >= eos)
            target = done if finished else max(done - margin, emitted)
            if target > emitted:
                # Window context: on the final flush after an early EOS the
                # batch path decoded `frames`-wide codes ZEROED past eos;
                # extend the window with those known zeros so the tail samples
                # see the identical code context (conv padding differs from
                # code-0 embeddings).
                ctx_end = min(frames, done + margin) if finished else done
                # de-delay + finalize the decoded prefix (host-side numpy)
                codes = np.zeros((1, K, ctx_end), np.int64)
                for k in range(K):
                    codes[0, k, :done] = toks_all[k : k + done, 0, k]
                codes[:, :, eos:] = 0
                codes = np.where((codes >= 0) & (codes < max_code), codes, 0)
                w0 = max(0, emitted - margin)
                wave = P.dac_decode_codes(self.dac_params, torch.as_tensor(codes[:, :, w0:ctx_end], device=self.device),
                                          self.dac_cfg, compute_dtype=self.compute_dtype).float().cpu().numpy()
                yield wave[0, (emitted - w0) * hop : (target - w0) * hop]
                emitted = target
            if finished:
                break

    def validate_lengths(self, description: str, prompt: str) -> None:
        """Raise ValueError when the encoded description/prompt exceeds the
        pad budgets; called per request BEFORE batching so one oversized
        request cannot fail an entire co-batched group."""
        if self.encode_fn is None:
            return
        self._check_budget(len(self.encode_fn(description)), len(self.encode_fn(prompt)),
                           self.cfg.desc_pad, self.cfg.prompt_pad)

    def warmup(self, batches=(1,)) -> None:
        """Run the (bucket, max_frames) shapes a first burst would otherwise
        meet cold (kernel build and load, library handles, allocator)."""
        for bv in batches:
            self.synthesize_rows([ParlerRow("warmup description", "warm up.")] * bv)
