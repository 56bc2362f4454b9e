"""Parler-TTS-compatible autoregressive branch (counterpart of
``f5tts_tpu/models/parler.py``): a T5 *description* encoder conditions a
MusicGen-style delay-pattern decoder over DAC codec tokens; the transcript
*prompt* is embedded with its own table and prepended to the decoder
sequence; the DAC decoder turns codes into a 44.1 kHz waveform.

Plain functions on parameter trees that keep the JAX layouts (stacked
``blocks`` with a leading layer axis, ``(d_in, d_out)`` linears, ``(k, in,
out)`` convs; see ``models/convert.py:parler_params_from_numpy``).

- ``t5_encode``             -- T5 encoder (relative-position-bias attention,
                               gated ``gelu_new`` FF, RMS norm).
- ``parler_decoder_forward`` -- teacher-forced decoder pass; ``parler_loss``
                               its cross-entropy over delayed codes.
- ``parler_generate``        -- incremental decode with a KV cache, per-codebook
                               sampling and the delay pattern applied in the
                               loop.
- ``parler_prefill``, ``parler_decode_positions`` -- its two phases, for a
                               caller that times them apart (the engine).
- ``parler_decode_segment``  -- the same decode over a sub-range of positions,
                               the carry handed between calls (streaming).
- ``parler_replay_logits``   -- the cached step path teacher-forced over given
                               token streams: fp32 logits (the benchmark's judge).
- ``dac_decode_codes``       -- DAC codec decoder.
- ``load_parler_checkpoint`` -- one ParlerTTSForConditionalGeneration state
                               dict -> the three numpy trees
                               (``convert_t5_encoder``,
                               ``convert_parler_decoder``, ``convert_dac``,
                               ``descript_dac_to_hf_keys``).

The decode step's attention against the caches (self- and cross-attention of
every layer at every position) is ``ops/kernels/decode_attention.py``:
``ParlerDecoderConfig.decode_attn="kernel"`` takes the wrapper (CUDA kernel on
a GPU tensor, plain version on a CPU tensor), ``"plain"`` the plain version on
any device. There is one cache layout: per-layer K and V ``(b, n_kv, total,
d)``, written IN PLACE at the step's position, so a carry handed back by
``parler_decode_segment`` shares its cache with the carry that was passed in.
On a card each decode call captures the step's pass through the decoder in a
CUDA graph after its first position and replays it (``_DecodeCtx``).

Sampling: temperature <= 0 is argmax. Otherwise tokens are drawn from
``torch.Generator``s seeded by ``(seed, row seed, position)``,
so a row's stream depends neither on the rows it is batched with nor on how the
positions are cut into segments. The draws differ from the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.ops.kernels import _build
from f5tts_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_plain
from f5tts_tpu_torch.train.tree import tree_map

# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class T5Config:
    """flan-t5 geometry (indic-parler-tts uses flan-t5-large: d_model 1024,
    d_kv 64, d_ff 2816, 16 heads, 24 layers, vocab 32128)."""

    vocab: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    heads: int = 16
    layers: int = 24
    rel_buckets: int = 32
    rel_max_dist: int = 128
    ln_eps: float = 1e-6

    @property
    def inner(self) -> int:
        return self.heads * self.d_kv


def _t5_rms(g, x, eps):
    """T5LayerNorm: no mean subtraction, fp32 variance, scale only."""
    x32 = x.float()
    var = torch.square(x32).mean(-1, keepdim=True)
    return (g.float() * x32 * torch.rsqrt(var + eps)).to(x.dtype)


def _rel_bucket(rel: torch.Tensor, num_buckets: int, max_dist: int) -> torch.Tensor:
    """Bidirectional relative-position bucketing (T5Attention semantics);
    the logarithm is taken in fp32 and truncated, as in the JAX package."""
    nb = num_buckets // 2
    buckets = (rel > 0).to(torch.int32) * nb
    rel = rel.abs()
    max_exact = nb // 2
    is_small = rel < max_exact
    rel_f = rel.to(torch.float32).clamp_min(1.0)  # the value is unused when is_small
    large = max_exact + (torch.log(rel_f / max_exact) / math.log(max_dist / max_exact)
                         * (nb - max_exact)).to(torch.int32)
    large = large.clamp_max(nb - 1)
    return buckets + torch.where(is_small, rel.to(torch.int32), large)


def t5_relative_bias(rel_bias: torch.Tensor, n: int, cfg: T5Config) -> torch.Tensor:
    """(1, heads, n, n) additive attention bias from the bucket table."""
    pos = torch.arange(n, device=rel_bias.device)
    rel = pos[None, :] - pos[:, None]  # memory - query
    bucket = _rel_bucket(rel, cfg.rel_buckets, cfg.rel_max_dist)
    return rel_bias[bucket.long()].permute(2, 0, 1)[None]


def _layer(blocks, l: int):
    """Layer ``l`` of a stacked-blocks tree (views, no copies)."""
    return tree_map(lambda t: t[l], blocks)


def _softmax_pv(logits, v):
    """fp32 softmax, weights cast to ``v.dtype``, ``(b,h,q,k) x (b,h,k,d)``."""
    return torch.softmax(logits, dim=-1).to(v.dtype) @ v


def t5_encode(params, cfg: T5Config, ids: torch.Tensor, mask: torch.Tensor | None = None,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ids (b, n) int, mask (b, n) bool (True = valid) -> (b, n, d_model).

    Matches transformers T5EncoderModel: unscaled attention, shared relative
    bias from layer 0, gated gelu_new FF, pre-RMS norms, fp32 softmax."""
    b, n = ids.shape
    h = params["embed"][ids.long()].to(compute_dtype)
    bias = t5_relative_bias(params["rel_bias"].float(), n, cfg)
    if mask is not None:
        bias = bias + torch.where(mask, 0.0, -1e9)[:, None, None, :]

    def heads(t):
        return t.reshape(b, n, cfg.heads, cfg.d_kv).transpose(1, 2)

    for l in range(cfg.layers):
        blk = _layer(params["blocks"], l)
        x = _t5_rms(blk["ln1"]["g"], h, cfg.ln_eps)
        q, k, v = heads(m.linear(blk["q"], x)), heads(m.linear(blk["k"], x)), heads(m.linear(blk["v"], x))
        logits = q.float() @ k.float().transpose(-1, -2)
        o = _softmax_pv(logits + bias, v).transpose(1, 2).reshape(b, n, -1)
        h = h + m.linear(blk["o"], o)
        x = _t5_rms(blk["ln2"]["g"], h, cfg.ln_eps)
        gate = F.gelu(m.linear(blk["wi_0"], x), approximate="tanh")  # gelu_new
        h = h + m.linear(blk["wo"], gate * m.linear(blk["wi_1"], x))
    return _t5_rms(params["final_ln"]["g"], h, cfg.ln_eps)


# ---------------------------------------------------------------------------
# Parler / MusicGen codebook decoder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParlerDecoderConfig:
    """indic-parler-tts decoder geometry: hidden 1024, 24 layers, 16 heads,
    ffn 4096, 9 codebooks, codebook vocab 1088 (+1 pad slot in the embedding),
    prompt vocab = the T5 tokenizer (32128)."""

    vocab: int = 1088
    codebooks: int = 9
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    ffn: int = 4096
    cross_dim: int = 1024
    prompt_vocab: int = 32128
    ln_eps: float = 1e-5
    # grouped-query attention (llama-style repeat_kv); None = full MHA
    kv_heads: int | None = None
    cross_kv_heads: int | None = None
    # decode step: one (hidden -> q|k|v) matmul per layer instead of three;
    # the concatenation runs once per decode call
    fuse_decode_qkv: bool = False
    # decode-step cache attention: "kernel" = ops/kernels/decode_attention.py
    # (CUDA kernel on a GPU tensor, plain version on a CPU tensor); "plain" =
    # its plain version on any device
    decode_attn: str = "kernel"

    def __post_init__(self):
        if self.decode_attn not in ("kernel", "plain"):
            raise ValueError(f"decode_attn must be 'kernel' or 'plain', got {self.decode_attn!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def n_kv(self) -> int:
        return self.kv_heads or self.heads

    @property
    def n_cross_kv(self) -> int:
        return self.cross_kv_heads or self.heads


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """MusicGen sinusoidal table: ``cat([cos, sin], dim=1)`` over half-dim
    frequencies (cos first)."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=positions.device)
                     * -(math.log(10000.0) / (half - 1)))
    ang = positions.float()[:, None] * freq[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)


def _split_heads(t, b, n, heads):
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def _kv_count(p, head_dim: int) -> int:
    """KV head count inferred from the projection width (GQA-aware)."""
    return p["k"]["w"].shape[-1] // head_dim


def _expand_kv(t, heads: int):
    """(b, kvh, n, d) -> (b, heads, n, d) llama-style repeat_kv."""
    kvh = t.shape[1]
    if kvh == heads:
        return t
    return t.repeat_interleave(heads // kvh, dim=1)


def _attend(q, k, v, bias):
    """``q`` pre-scaled ``(b,h,nq,d)``, ``k``/``v (b,h,nk,d)``: fp32 logits +
    bias, fp32 softmax, weights in ``v.dtype`` -> ``(b, nq, h*d)``."""
    logits = q.float() @ k.float().transpose(-1, -2)
    if bias is not None:
        logits = logits + bias
    b, _, nq, _ = q.shape
    return _softmax_pv(logits, v).transpose(1, 2).reshape(b, nq, -1)


def _mha(p, x, kv, heads, bias=None):
    """Generic M(Q/G)A: q from x, k/v from kv (possibly fewer KV heads),
    additive bias (b,1,nq,nk) or None."""
    b, nq, _ = x.shape
    nk = kv.shape[1]
    head_dim = x.shape[-1] // heads
    nkv = _kv_count(p, head_dim)
    q = _split_heads(m.linear(p["q"], x) * head_dim**-0.5, b, nq, heads)
    k = _expand_kv(_split_heads(m.linear(p["k"], kv), b, nk, nkv), heads)
    v = _expand_kv(_split_heads(m.linear(p["v"], kv), b, nk, nkv), heads)
    return m.linear(p["o"], _attend(q, k, v, bias))


def _embed_codes(params, codes):
    """codes (b, K, n) -> summed embeddings (b, n, hidden)."""
    table = params["embed_tokens"]  # (K, vocab + 1, hidden)
    K, rows, hidden = table.shape
    offsets = torch.arange(K, device=codes.device)[None, :, None] * rows
    return table.reshape(K * rows, hidden)[codes.long() + offsets].sum(1)


def _embed_prompts(params, prompt_ids, prompt_mask, compute_dtype):
    pe = params["embed_prompts"][prompt_ids.long().clamp_min(0)].to(compute_dtype)
    if prompt_mask is not None:
        pe = torch.where(prompt_mask[..., None], pe, 0.0)
    return pe


def _encoder_states(params, enc, compute_dtype):
    enc = enc.to(compute_dtype)
    if "enc_proj" in params:
        enc = m.linear(params["enc_proj"], enc)
    return enc


def _ln(p, x, eps):
    """Affine layer norm, statistics in fp32 and one rounding to ``x.dtype``
    (the arithmetic of ``models/modules.py:layer_norm``) as ONE launch: the
    decode loop is bound by the host's launch rate, and the composed form
    costs eleven launches three times per layer and position."""
    return F.layer_norm(x, x.shape[-1:], p["w"].to(x.dtype), p["b"].to(x.dtype), eps)


def _ff(blk, h, eps):
    y = _ln(blk["ln_ff"], h, eps)
    return h + m.linear(blk["fc2"], F.gelu(m.linear(blk["fc1"], y)))  # exact (erf) GELU


def _lm_logits(params, hn):
    """fp32 LM heads: hn (b, n, hidden) -> (b, K, n, vocab)."""
    return torch.einsum("bnh,khv->bknv", hn.float(), params["lm_heads"].float())


def parler_decoder_forward(
    params,
    cfg: ParlerDecoderConfig,
    codes: torch.Tensor,  # (b, K, n) int in [0, vocab] (vocab = pad/bos slot)
    enc: torch.Tensor,  # (b, m, cross_dim) encoder hidden states
    enc_mask: torch.Tensor | None = None,  # (b, m) bool
    prompt_ids: torch.Tensor | None = None,  # (b, p) transcript tokens
    prompt_mask: torch.Tensor | None = None,  # (b, p) bool
    compute_dtype: torch.dtype = torch.float32,
):
    """Teacher-forced pass. Returns per-codebook logits (b, K, n, vocab) for
    the code positions (prompt positions are dropped from the head outputs)."""
    b, K, n = codes.shape
    dev = codes.device
    x = _embed_codes(params, codes).to(compute_dtype)
    p = 0
    if prompt_ids is not None:
        p = prompt_ids.shape[1]
        x = torch.cat([_embed_prompts(params, prompt_ids, prompt_mask, compute_dtype), x], dim=1)
    total = p + n
    h = x + sinusoidal_positions(torch.arange(total, device=dev), cfg.hidden).to(compute_dtype)[None]

    causal = torch.tril(torch.ones((total, total), dtype=torch.bool, device=dev))[None, None]
    if prompt_mask is not None and p:
        key_valid = torch.cat([prompt_mask, torch.ones((b, n), dtype=torch.bool, device=dev)], dim=1)
        causal = causal & key_valid[:, None, None, :]
    sa_bias = torch.where(causal, 0.0, -1e9)
    ca_bias = None
    if enc_mask is not None:
        ca_bias = torch.where(enc_mask, 0.0, -1e9)[:, None, None, :]
    enc_h = _encoder_states(params, enc, compute_dtype)

    for l in range(cfg.layers):
        blk = _layer(params["blocks"], l)
        xn = _ln(blk["ln_sa"], h, cfg.ln_eps)
        h = h + _mha(blk["sa"], xn, xn, cfg.heads, sa_bias)
        xn = _ln(blk["ln_ca"], h, cfg.ln_eps)
        h = h + _mha(blk["ca"], xn, enc_h, cfg.heads, ca_bias)
        h = _ff(blk, h, cfg.ln_eps)
    h = _ln(params["final_ln"], h, cfg.ln_eps)
    return _lm_logits(params, h[:, p:])


def parler_loss(params, cfg: ParlerDecoderConfig, codes, code_mask, enc, enc_mask=None, prompt_ids=None,
                prompt_mask=None, pad_token: int | None = None, compute_dtype: torch.dtype = torch.float32):
    """Teacher-forced next-token cross-entropy, averaged over valid positions
    and codebooks; differentiable (autograd through ``parler_decoder_forward``).
    ``codes`` already carries the delay pattern (pad-filled); positions where
    ``code_mask`` is False, or whose target is the pad slot, are excluded (HF
    trains with those labels at -100). ``pad_token`` defaults to the extra
    pad/bos slot ``cfg.vocab`` (what ``build_delay_pattern`` fills with); a
    negative value disables the pad exclusion. Targets are clamped to
    ``vocab - 1`` before the gather."""
    inp, tgt = codes[..., :-1], codes[..., 1:]
    logits = parler_decoder_forward(params, cfg, inp, enc, enc_mask, prompt_ids, prompt_mask, compute_dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tgt.long().clamp_max(cfg.vocab - 1)[..., None])[..., 0]
    w = code_mask[..., 1:].float()
    pad = cfg.vocab if pad_token is None else pad_token
    if pad >= 0:  # without this, pad targets clamp to real token vocab-1 and get trained
        w = w * (tgt != pad)
    return (nll * w).sum() / w.sum().clamp_min(1.0)


# --- delay pattern -----------------------------------------------------------


def build_delay_pattern(codes: np.ndarray, pad_token: int, max_length: int) -> np.ndarray:
    """(b, K, n) -> (b, K, max_length) with codebook k shifted right by k and
    pad elsewhere (the HF ``build_delay_pattern_mask`` layout, mono)."""
    b, K, n = codes.shape
    out = np.full((b, K, max_length), pad_token, dtype=codes.dtype)
    for k in range(K):
        span = min(n, max_length - k)
        out[:, k, k : k + span] = codes[:, k, :span]
    return out


def revert_delay_pattern(delayed: torch.Tensor, frames: int) -> torch.Tensor:
    """(b, K, total) delayed -> (b, K, frames): codebook k read at offset k."""
    b, K, _ = delayed.shape
    dev = delayed.device
    idx = torch.arange(frames, device=dev)[None, :] + torch.arange(K, device=dev)[:, None]  # (K, frames)
    return torch.gather(delayed, 2, idx[None].expand(b, K, frames))


# --- incremental generation ---------------------------------------------------


def _filtered_probs(logits, temperature: float, top_k: int):
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    return torch.softmax(logits, dim=-1)


def _categorical(probs, gen: torch.Generator | None):
    """One draw per row of ``probs (..., vocab)``: ``argmax(p / e)`` with
    ``e ~ Exp(1)`` (the exponential-race form ``torch.multinomial`` uses for a
    single sample), without multinomial's validity check, which reads a flag
    back to the host and would stall the decode loop at every position."""
    race = torch.empty_like(probs).exponential_(1.0, generator=gen)
    return torch.argmax(probs / race, dim=-1)


def _sample(gen: torch.Generator | None, logits, temperature: float, top_k: int):
    """logits (..., vocab) -> token ids; temperature <= 0 is greedy. One
    generator draws for the whole batch."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return _categorical(_filtered_probs(logits, temperature, top_k), gen)


def _sample_rows(gens, logits, temperature: float, top_k: int):
    """Per-row generators (b,) x logits (b, K, vocab) -> (b, K): each row's
    draws depend only on its own generator, never on the batch size or the
    rows it is batched with (the continuous batcher mixes requests)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = _filtered_probs(logits, temperature, top_k)
    return torch.stack([_categorical(probs[r], g) for r, g in enumerate(gens)])


def _position_seed(seed: int, row_seed: int, j: int) -> int:
    """One 63-bit generator seed from (call seed, row seed, position)."""
    return ((int(seed) & 0xFFFF) << 47) | ((int(row_seed) & 0x7FFFFFFF) << 16) | (int(j) & 0xFFFF)


class _DecodeCtx:
    """What one decode call computes once and every position shares: the
    prefill of ``[prompt ; BOS]``, per-layer parameter views, the fused q|k|v
    weights, the cross-attention K/V of every layer, the position table and
    the key-padding bias. ``carry0 = (logits, cache, ctx, eos_frame)`` is the
    post-prefill state; ``step`` advances a carry by one code-stream position.
    The context rides in the carry (where the JAX package carries its PRNG
    key) so that ``parler_decode_segment`` does not repeat the prefill.

    On a card the position's pass through the decoder (embedding to logits,
    ``_forward``) runs from a CUDA graph: the first step runs it eagerly,
    then it is captured once, with the tokens and the position in static
    buffers, and every later step replays it. Eager, the step is paced by
    the host's ~600 launches a position, several times the card's work at
    batch 32; replayed, by the card. The draw, EOS and the delay pattern stay
    eager (the per-row generators are reseeded from the host each position).
    The graph launches the same kernels in the same order as the eager
    step, so its results are the eager step's."""

    def __init__(self, params, cfg: ParlerDecoderConfig, enc, enc_mask, frames: int, seed: int, prompt_ids,
                 prompt_mask, bos_token, pad_token, eos_token: int, temperature: float, top_k: int, row_seeds,
                 compute_dtype: torch.dtype):
        bos = cfg.vocab if bos_token is None else bos_token
        self.pad = bos if pad_token is None else pad_token
        self.params, self.cfg, self.frames = params, cfg, frames
        self.eos_token, self.temperature, self.top_k = eos_token, temperature, top_k
        self.seed = seed
        self.row_seeds = None if row_seeds is None else [int(s) for s in row_seeds]
        b = self.b = enc.shape[0]
        dev = enc.device
        K = cfg.codebooks
        p = self.p = 0 if prompt_ids is None else prompt_ids.shape[1]
        self.steps = frames + K - 1  # positions 1 .. frames+K-1 of the code stream
        total = self.total = p + 1 + self.steps
        self.attend = decode_attention if cfg.decode_attn == "kernel" else decode_attention_plain
        if temperature > 0.0:
            n_gens = 1 if self.row_seeds is None else b
            self.gens = [torch.Generator(device=dev) for _ in range(n_gens)]

        enc_h = _encoder_states(params, enc, compute_dtype)
        enc_n = enc_h.shape[1]
        ca_bias4 = None
        self.ca_bias = torch.zeros((b, enc_n), dtype=torch.float32, device=dev)
        if enc_mask is not None:
            self.ca_bias = torch.where(enc_mask, 0.0, -1e9).to(torch.float32)
            ca_bias4 = self.ca_bias[:, None, None, :]

        # positions span the concatenated [prompt ; codes] sequence
        self.pos_table = sinusoidal_positions(torch.arange(total, device=dev), cfg.hidden).to(compute_dtype)
        self.pos_ids = torch.arange(total, device=dev)[None, :]
        self.codebook_idx = torch.arange(K, device=dev)[None, :]

        # ---- prefill: [prompt ; BOS] --------------------------------------
        bos_row = torch.full((b, K, 1), bos, dtype=torch.long, device=dev)
        x0 = _embed_codes(params, bos_row).to(compute_dtype)
        if p:
            x0 = torch.cat([_embed_prompts(params, prompt_ids, prompt_mask, compute_dtype), x0], dim=1)
        x0 = x0 + self.pos_table[None, : p + 1]
        n0 = x0.shape[1]

        key_valid = torch.ones((b, total), dtype=torch.bool, device=dev)
        if p and prompt_mask is not None:
            key_valid[:, :p] = prompt_mask
        self.key_bias = torch.where(key_valid, 0.0, -1e9).to(torch.float32)  # (b, total)
        causal0 = torch.tril(torch.ones((n0, n0), dtype=torch.bool, device=dev))[None, None] \
            & key_valid[:, None, None, :n0]
        sa_bias0 = torch.where(causal0, 0.0, -1e9)

        self.blocks = [_layer(params["blocks"], l) for l in range(cfg.layers)]
        scale = cfg.head_dim**-0.5
        # per-layer caches, one allocation: cache[l] = (K, V), each (b, n_kv, total, d)
        store = torch.zeros((cfg.layers, 2, b, cfg.n_kv, total, cfg.head_dim), dtype=compute_dtype, device=dev)
        cache = [(store[l, 0], store[l, 1]) for l in range(cfg.layers)]
        self.ca_kv = []
        h = x0
        for blk, (ck, cv) in zip(self.blocks, cache):
            xn = _ln(blk["ln_sa"], h, cfg.ln_eps)
            q = _split_heads(m.linear(blk["sa"]["q"], xn) * scale, b, n0, cfg.heads)
            k = _split_heads(m.linear(blk["sa"]["k"], xn), b, n0, cfg.n_kv)
            v = _split_heads(m.linear(blk["sa"]["v"], xn), b, n0, cfg.n_kv)
            ck[:, :, :n0] = k
            cv[:, :, :n0] = v
            o = _attend(q, _expand_kv(k, cfg.heads), _expand_kv(v, cfg.heads), sa_bias0)
            h = h + m.linear(blk["sa"]["o"], o)
            xn = _ln(blk["ln_ca"], h, cfg.ln_eps)
            h = h + _mha(blk["ca"], xn, enc_h, cfg.heads, ca_bias4)
            h = _ff(blk, h, cfg.ln_eps)
            # cross-attention K/V are static per layer: computed once, kept
            # with their own (possibly fewer) KV heads for the decode kernel
            self.ca_kv.append((
                _split_heads(m.linear(blk["ca"]["k"], enc_h), b, enc_n, cfg.n_cross_kv).contiguous(),
                _split_heads(m.linear(blk["ca"]["v"], enc_h), b, enc_n, cfg.n_cross_kv).contiguous()))

        # decode-step weights per layer, cast once per call: the step below is
        # bound by the host's call rate, so it walks no dictionaries and makes
        # no per-position casts. With fuse_decode_qkv one (hidden, hidden + 2
        # kv) weight replaces three.
        def cast(p):
            if "b" in p:
                raise ValueError("the decode step takes bias-free linears, as the Parler decoder's are")
            return p["w"].to(compute_dtype)

        def norm(p):
            return p["w"].to(compute_dtype), p["b"].to(compute_dtype)

        self.step_layers = []
        for blk in self.blocks:
            sa, ca = blk["sa"], blk["ca"]
            wq, wk, wv = cast(sa["q"]), cast(sa["k"]), cast(sa["v"])
            qkv = (torch.cat([wq, wk, wv], dim=-1),) if cfg.fuse_decode_qkv else (wq, wk, wv)
            self.step_layers.append((
                *norm(blk["ln_sa"]), qkv, cast(sa["o"]), *norm(blk["ln_ca"]), cast(ca["q"]), cast(ca["o"]),
                *norm(blk["ln_ff"]), cast(blk["fc1"]), cast(blk["fc2"])))
        self.kv_store = store  # (layers, 2, b, n_kv, total, d): K and V of a layer side by side
        # fp32 LM heads laid out for one (hidden, K * vocab) matmul per step
        self.lm_w = params["lm_heads"].float().permute(1, 0, 2).reshape(cfg.hidden, K * cfg.vocab).contiguous()
        # flat code-embedding table and per-codebook row offsets
        rows = params["embed_tokens"].shape[1]
        self.embed_flat = params["embed_tokens"].reshape(K * rows, cfg.hidden)
        self.embed_off = self.codebook_idx * rows

        self._logits0 = self._logits(h[:, -1:])
        self._cache = cache
        self._eos0 = torch.full((b,), frames, dtype=torch.long, device=dev)
        self.graph = None  # the captured _forward, on a card after the first step
        self.graphable = dev.type == "cuda"

    @property
    def carry0(self):
        """The post-prefill carry, made when asked: stored on the context, it
        would hold the context in a reference cycle, and its cache and graph
        would outlive the call until the garbage collector found them."""
        return (self._logits0, self._cache, self, self._eos0)

    def _logits(self, h_last):
        """(b, 1, hidden) -> fp32 (b, K, vocab)."""
        hn = _ln(self.params["final_ln"], h_last, self.cfg.ln_eps)
        return (hn[:, 0].float() @ self.lm_w).reshape(self.b, self.cfg.codebooks, self.cfg.vocab)

    def _draw(self, logits, j: int):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        if self.row_seeds is None:
            self.gens[0].manual_seed(_position_seed(self.seed, 0, j))
            return _sample(self.gens[0], logits, self.temperature, self.top_k)
        # per-row streams: (seed, row seed, position), so a row's audio is
        # reproducible whichever rows it is batched with
        for g, s in zip(self.gens, self.row_seeds):
            g.manual_seed(_position_seed(self.seed, s, j))
        return _sample_rows(self.gens, logits, self.temperature, self.top_k)

    def _token_through_layers(self, h_tok, pos: torch.Tensor):
        """One token (b, 1, hidden) through all layers; K/V rows written in
        place at the position ``pos`` (a (1,) long tensor on the device, so
        that a graph can replay it at any position). No host
        synchronisation."""
        cfg, b, attend = self.cfg, self.b, self.attend
        hidden, heads, n_kv, d, eps = cfg.hidden, cfg.heads, cfg.n_kv, cfg.head_dim, cfg.ln_eps
        scale = d**-0.5
        norm = (hidden,)
        # causal step bound + key padding: built once per position, shared by all layers
        sa_bias = self.key_bias.masked_fill(self.pos_ids > pos, -1e9)
        ca_bias = self.ca_bias
        for l, (ln_sa_w, ln_sa_b, wqkv, w_sa_o, ln_ca_w, ln_ca_b, w_ca_q, w_ca_o, ln_ff_w, ln_ff_b, w_fc1,
                w_fc2) in enumerate(self.step_layers):
            ck, cv = self.kv_store[l]
            cak, cav = self.ca_kv[l]
            xn = F.layer_norm(h_tok, norm, ln_sa_w, ln_sa_b, eps)
            # a length-1 sequence: (b, 1, heads * d) IS (b, heads, 1, d), so heads split as views
            if len(wqkv) == 1:
                qkv = xn @ wqkv[0]
                q = (qkv[..., :hidden] * scale).view(b, heads, 1, d)
                # K and V rows of this position, one copy into the layer's (2, b, n_kv, total, d) store
                self.kv_store[l].index_copy_(3, pos, qkv[..., hidden:].view(b, 2, n_kv, 1, d).transpose(0, 1))
            else:
                q = ((xn @ wqkv[0]) * scale).view(b, heads, 1, d)
                ck.index_copy_(2, pos, (xn @ wqkv[1]).view(b, n_kv, 1, d))
                cv.index_copy_(2, pos, (xn @ wqkv[2]).view(b, n_kv, 1, d))
            h_tok = h_tok + attend(q, ck, cv, sa_bias).view(b, 1, hidden) @ w_sa_o
            xn = F.layer_norm(h_tok, norm, ln_ca_w, ln_ca_b, eps)
            q = ((xn @ w_ca_q) * scale).view(b, heads, 1, d)
            h_tok = h_tok + attend(q, cak, cav, ca_bias).view(b, 1, hidden) @ w_ca_o
            xn = F.layer_norm(h_tok, norm, ln_ff_w, ln_ff_b, eps)
            h_tok = h_tok + F.gelu(xn @ w_fc1) @ w_fc2  # exact (erf) GELU
        return h_tok

    def _forward(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One position's tokens (b, K) at ``pos`` through the decoder: fp32
        logits (b, K, vocab)."""
        x = self.embed_flat[tok + self.embed_off].sum(1, keepdim=True).to(self.pos_table.dtype)
        x = x + self.pos_table.index_select(0, pos)
        return self._logits(self._token_through_layers(x, pos))

    def _advance(self, tok: torch.Tensor, abs_pos: int) -> torch.Tensor:
        """``_forward`` at ``abs_pos``: from the graph once it is captured,
        else eagerly (capturing it after the first eager step on a card).
        A replay's logits are a static buffer that the next replay
        overwrites."""
        if self.graph is not None:
            self._tok.copy_(tok)
            self._pos.fill_(abs_pos)
            self.graph.replay()
            if self._graph_launches:  # the replay's kernel launches, which the wrappers cannot count
                _build.count_launch(decode_attention, self._graph_launches)
            return self._out
        pos = torch.full((1,), abs_pos, dtype=torch.long, device=tok.device)
        logits = self._forward(tok, pos)
        if self.graphable:
            self._capture(tok, pos)
        return logits

    def _capture(self, tok: torch.Tensor, pos: torch.Tensor) -> None:
        """Capture ``_forward`` over static copies of ``tok`` and ``pos`` on a
        side stream, after the eager step that loaded its kernels and
        libraries. Capturing launches nothing and waits for nothing, yet the
        wrapper counts the kernel-4 calls it meets: those, two a layer, are
        taken back here and counted on each replay instead."""
        self._tok, self._pos = tok.clone(), pos.clone()
        main = torch.cuda.current_stream(tok.device)
        side = torch.cuda.Stream(tok.device)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._out = self._forward(self._tok, self._pos)
            finally:
                graph.capture_end()
        main.wait_stream(side)
        self._graph_launches = 2 * self.cfg.layers if self.attend is decode_attention else 0
        _build.count_launch(decode_attention, -self._graph_launches)
        self.graph = graph

    def step(self, carry, j: int, forced: torch.Tensor | None = None):
        """Advance by code-stream position ``j`` (1-based): draw the tokens of
        position ``j`` from the carried logits, apply EOS and delay forcing,
        run them through the layers. Returns ``(carry, tok (b, K))``.
        ``forced (b, K)`` replaces the position's tokens (teacher forcing, for
        numeric comparisons). Positions past ``steps`` write only the last
        cache slot and cannot move ``eos_frame``; their tokens are the
        caller's to discard."""
        logits, cache, _, eos_frame = carry
        frames = self.frames
        sampled = self._draw(logits, j)  # (b, K)
        # codebook-0 EOS at code index i ends the utterance at frame i;
        # trailing codebooks still emit their delayed frames < eos_frame
        idx0 = j - 1
        if idx0 < frames:
            hit = (sampled[:, 0] == self.eos_token) & (eos_frame > idx0)
            eos_frame = eos_frame.masked_fill(hit, idx0)
        # delay forcing: codebook k at position j holds code index j-1-k;
        # outside [0, min(frames, eos_frame)) the pattern forces the pad token
        code_idx = idx0 - self.codebook_idx  # (1, K)
        valid = (code_idx >= 0) & (code_idx < eos_frame.clamp_max(frames)[:, None])
        tok = torch.where(valid, sampled, self.pad)
        if forced is not None:
            tok = forced
        abs_pos = min(self.p + j, self.total - 1)  # a tail past `steps` stays on the last slot
        return (self._advance(tok, abs_pos), cache, self, eos_frame), tok


def parler_prefill(params, cfg: ParlerDecoderConfig, enc, enc_mask, frames: int, seed: int = 0, prompt_ids=None,
                   prompt_mask=None, bos_token: int | None = None, pad_token: int | None = None, eos_token: int = 1024,
                   temperature: float = 1.0, top_k: int = 0, row_seeds=None,
                   compute_dtype: torch.dtype = torch.float32) -> _DecodeCtx:
    """The decode's shared context: the prefill of ``[prompt ; BOS]`` and the
    per-position step (``ctx.carry0``, ``ctx.step``, ``ctx.steps``)."""
    with torch.no_grad():
        return _DecodeCtx(params, cfg, enc, enc_mask, frames, seed, prompt_ids, prompt_mask, bos_token,
                          pad_token, eos_token, temperature, top_k, row_seeds, compute_dtype)


@torch.no_grad()
def parler_decode_positions(ctx: _DecodeCtx):
    """Every position ``1 .. ctx.steps`` from the post-prefill carry: returns
    ``(stream (b, K, steps), eos_frame (b,))``, the delayed token stream as
    the step fed it back (pad where the delay pattern or EOS forces it). No
    host synchronisation."""
    carry, toks = ctx.carry0, []
    for j in range(1, ctx.steps + 1):
        carry, tok = ctx.step(carry, j)
        toks.append(tok)
    return torch.stack(toks, dim=2), carry[3]


def finalize_codes(codes: torch.Tensor, eos_frame: torch.Tensor, cfg: ParlerDecoderConfig,
                   max_code: int | None = None):
    """Post-decode masking shared by the batch and streaming paths: zero codes
    past each row's EOS length and clamp sampled specials below the codec
    codebook (the decoder vocab exceeds the DAC codebook; EOS is only
    intercepted on codebook 0, so strays in codebooks 1+ must not reach the
    codec's gather)."""
    lengths = eos_frame
    frame_pos = torch.arange(codes.shape[2], device=codes.device)[None, None, :]
    codes = torch.where(frame_pos < lengths[:, None, None], codes, 0)
    hi = cfg.vocab if max_code is None else max_code
    codes = torch.where((codes >= 0) & (codes < hi), codes, 0)
    return codes, lengths


@torch.no_grad()
def parler_generate(
    params,
    cfg: ParlerDecoderConfig,
    enc: torch.Tensor,  # (b, m, cross_dim)
    enc_mask: torch.Tensor | None,
    frames: int,
    seed: int = 0,
    prompt_ids: torch.Tensor | None = None,  # (b, p)
    prompt_mask: torch.Tensor | None = None,
    bos_token: int | None = None,  # defaults to the extra pad/bos slot (vocab)
    pad_token: int | None = None,
    eos_token: int = 1024,
    temperature: float = 1.0,
    top_k: int = 0,
    max_code: int | None = None,  # codec codebook size; sampled specials >= it are zeroed
    row_seeds=None,  # (b,) host ints: per-row sampling streams
    compute_dtype: torch.dtype = torch.float32,
):
    """Delay-pattern AR generation with a KV cache.

    Returns ``(codes (b, K, frames) int32, lengths (b,) int32)``: codes are
    de-delayed; rows that emitted EOS in codebook 0 are padded with 0 past
    their length and report the shorter length (``finalize_codes``). The
    position loop issues no host synchronisation."""
    ctx = parler_prefill(params, cfg, enc, enc_mask, frames, seed, prompt_ids, prompt_mask, bos_token, pad_token,
                         eos_token, temperature, top_k, row_seeds, compute_dtype)
    stream, eos_frame = parler_decode_positions(ctx)
    # stream[..., s] holds position s+1 of the code stream
    codes, lengths = finalize_codes(revert_delay_pattern(stream, frames), eos_frame, cfg, max_code)
    return codes.to(torch.int32), lengths.to(torch.int32)


@torch.no_grad()
def parler_decode_segment(
    params,
    cfg: ParlerDecoderConfig,
    enc: torch.Tensor,
    enc_mask: torch.Tensor | None,
    frames: int,
    js,  # contiguous host ints within 1..steps (values past steps: outputs to be discarded)
    carry=None,  # None = prefill first; else the previous segment's carry
    *,
    seed: int = 0,
    prompt_ids: torch.Tensor | None = None,
    prompt_mask: torch.Tensor | None = None,
    bos_token: int | None = None,
    pad_token: int | None = None,
    eos_token: int = 1024,
    temperature: float = 1.0,
    top_k: int = 0,
    row_seeds=None,
    compute_dtype: torch.dtype = torch.float32,
):
    """Decode a sub-range of code-stream positions: the streaming primitive.

    Returns ``(carry, toks (len(js), b, K))``. The KV cache rides the carry
    between calls and is updated in place; the sampling streams are keyed by
    (seed, position), so concatenated segment tokens are identical to
    ``parler_generate``'s. With a ``carry`` the model arguments are not read
    again: the carry holds the context of the call that made it. ``js`` may
    run past ``steps``: those positions are clamped onto the last cache slot,
    cannot move ``eos_frame``, and their tokens are the caller's to discard."""
    if carry is None:
        carry = parler_prefill(params, cfg, enc, enc_mask, frames, seed, prompt_ids, prompt_mask, bos_token,
                               pad_token, eos_token, temperature, top_k, row_seeds, compute_dtype).carry0
    ctx = carry[2]
    toks = []
    for j in js:
        carry, tok = ctx.step(carry, int(j))
        toks.append(tok)
    return carry, torch.stack(toks)


@torch.no_grad()
def parler_replay_logits(params, cfg: ParlerDecoderConfig, enc: torch.Tensor, enc_mask: torch.Tensor | None,
                         stream: torch.Tensor, rows, *, prompt_ids: torch.Tensor | None = None,
                         prompt_mask: torch.Tensor | None = None, bos_token: int | None = None,
                         pad_token: int | None = None, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The cached decode path teacher-forced over given token streams: the
    prefill, then ``_DecodeCtx.step(forced=...)`` at every position, at the
    batch of ``stream``.

    ``stream (b, K, steps)`` is each row's delayed token stream, what the step
    feeds back at positions ``1 .. steps`` (``build_delay_pattern`` of its
    codes, pad where the pattern forces it). Returns fp32 logits ``(len(rows),
    steps, K, vocab)`` of the batch rows ``rows``: entry ``s`` is the
    distribution position ``s + 1`` is drawn from, entry 0 the prefill's at
    BOS. The step's own draw is greedy and discarded for the forced tokens."""
    steps = stream.shape[2]
    ctx = parler_prefill(params, cfg, enc, enc_mask, steps - cfg.codebooks + 1, 0, prompt_ids, prompt_mask, bos_token,
                         pad_token, eos_token=-1, temperature=0.0, top_k=0, compute_dtype=compute_dtype)
    rows = torch.as_tensor(rows, device=stream.device)
    stream = stream.long()
    carry = ctx.carry0
    out = [carry[0][rows]]
    for j in range(1, steps):
        carry, _ = ctx.step(carry, j, forced=stream[:, :, j - 1])
        out.append(carry[0][rows])
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# DAC codec decoder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DacConfig:
    """descript/dac_44khz geometry (what indic-parler-tts decodes with)."""

    num_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    latent_dim: int = 1024  # config.hidden_size
    decoder_dim: int = 1536  # config.decoder_hidden_size
    rates: tuple = (8, 8, 4, 2)  # config.upsampling_ratios
    sampling_rate: int = 44100

    @property
    def hop(self) -> int:
        out = 1
        for r in self.rates:
            out *= r
        return out


def _snake(x, alpha):
    """x + 1/alpha * sin^2(alpha x), channel-last (alpha: (ch,)), in fp32."""
    a = alpha.float()[None, None, :]
    x32 = x.float()
    y = x32 + torch.square(torch.sin(a * x32)) / (a + 1e-9)
    return y.to(x.dtype)


def _dac_convt(p, x, stride: int):
    """ConvTranspose1d(kernel=2*stride, stride, padding=ceil(stride/2)) on
    channel-last ``x``. ``p["w"]`` is ``(in, out, k)``, the layout of
    ``F.conv_transpose1d``: ``parler_params_from_numpy`` makes it from the JAX
    package's time-flipped ``(k, in, out)`` kernel."""
    y = F.conv_transpose1d(x.transpose(1, 2), p["w"].to(x.dtype), stride=stride, padding=math.ceil(stride / 2))
    return y.transpose(1, 2) + p["b"].to(x.dtype)


def dac_from_codes(params, codes: torch.Tensor, compute_dtype: torch.dtype = torch.float32):
    """RVQ reconstruction: (b, K, n) codes -> (b, n, latent_dim)."""
    q = params["quant"]
    K, size, cdim = q["codebook"].shape
    offsets = torch.arange(K, device=codes.device)[None, :, None] * size
    emb = q["codebook"].reshape(K * size, cdim)[codes.long() + offsets]  # (b, K, n, cdim)
    z = torch.einsum("bknc,kcl->bnl", emb.to(compute_dtype), q["proj_w"].to(compute_dtype))
    return z + q["proj_b"].sum(0).to(compute_dtype)


@torch.no_grad()
def dac_decode_codes(params, codes: torch.Tensor, cfg: DacConfig = DacConfig(),
                     compute_dtype: torch.dtype = torch.float32):
    """(b, K, n) codes -> waveform (b, n * hop) in [-1, 1]."""
    x = dac_from_codes(params, codes, compute_dtype)
    x = m.conv1d(params["conv1"], x, padding=3)
    for blk, r in zip(params["blocks"], cfg.rates):
        x = _snake(x, blk["alpha"])
        x = _dac_convt(blk["convt"], x, r)
        # residual units with dilations 1, 3, 9 (pad 3*d keeps length)
        for ru, d in zip(blk["res"], (1, 3, 9)):
            y = m.conv1d(ru["conv1"], _snake(x, ru["alpha1"]), padding=3 * d, dilation=d)
            y = m.conv1d(ru["conv2"], _snake(y, ru["alpha2"]), padding=0)
            x = x + y
    x = _snake(x, params["alpha_out"])
    x = m.conv1d(params["conv2"], x, padding=3)
    return torch.tanh(x[..., 0])


# ---------------------------------------------------------------------------
# checkpoint converters: torch state dicts -> the JAX package's numpy trees
# ---------------------------------------------------------------------------


def _w(sd, name):
    return np.asarray(sd[name], np.float32)


def _lin_t(sd, prefix):
    """torch Linear (out, in) -> {'w': (in, out)} (+ bias), as fp32 numpy."""
    from f5tts_tpu_torch.models.convert import _lin

    return {k: np.asarray(v, np.float32) for k, v in _lin(sd, prefix).items()}


def convert_t5_encoder(sd: dict, cfg: T5Config, prefix: str = "") -> dict:
    """T5EncoderModel state dict (optionally under ``text_encoder.``) -> the
    numpy tree of ``init_t5_numpy``.

    Keys: ``shared.weight`` / ``encoder.embed_tokens.weight``,
    ``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}.weight``,
    ``encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight``,
    ``encoder.block.{i}.layer.{0,1}.layer_norm.weight``,
    ``encoder.block.{i}.layer.1.DenseReluDense.{wi_0,wi_1,wo}.weight``,
    ``encoder.final_layer_norm.weight``."""
    from f5tts_tpu_torch.models.convert import _fp32, _stack

    e = f"{prefix}encoder"
    emb_key = f"{e}.embed_tokens.weight"
    if emb_key not in sd:
        emb_key = f"{prefix}shared.weight"
    blocks = []
    for i in range(cfg.layers):
        b0, b1 = f"{e}.block.{i}.layer.0", f"{e}.block.{i}.layer.1"
        blocks.append({
            "ln1": {"g": _w(sd, f"{b0}.layer_norm.weight")},
            **{name: _lin_t(sd, f"{b0}.SelfAttention.{name}") for name in ("q", "k", "v", "o")},
            "ln2": {"g": _w(sd, f"{b1}.layer_norm.weight")},
            **{name: _lin_t(sd, f"{b1}.DenseReluDense.{name}") for name in ("wi_0", "wi_1", "wo")},
        })
    return _fp32({
        "embed": _w(sd, emb_key),
        "rel_bias": _w(sd, f"{e}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "blocks": _stack(blocks),
        "final_ln": {"g": _w(sd, f"{e}.final_layer_norm.weight")},
    })


def convert_parler_decoder(sd: dict, cfg: ParlerDecoderConfig, prefix: str = "model.decoder.",
                           lm_prefix: str = "lm_heads.", embed_prompts_key: str | None = None,
                           enc_proj_prefix: str | None = None) -> dict:
    """Musicgen/ParlerTTS decoder state dict -> the numpy tree of
    ``init_parler_decoder_numpy``.

    For a full ParlerTTS checkpoint pass ``prefix='decoder.model.decoder.'``,
    ``lm_prefix='decoder.lm_heads.'``, ``embed_prompts_key=
    'embed_prompts.weight'`` and ``enc_proj_prefix='enc_to_dec_proj'``. With no
    ``embed_prompts_key`` the prompt table is zeros."""
    from f5tts_tpu_torch.models.convert import _fp32, _stack

    def ln(p):
        return {"w": _w(sd, f"{p}.weight"), "b": _w(sd, f"{p}.bias")}

    def attn(p):
        return {"q": _lin_t(sd, f"{p}.q_proj"), "k": _lin_t(sd, f"{p}.k_proj"),
                "v": _lin_t(sd, f"{p}.v_proj"), "o": _lin_t(sd, f"{p}.out_proj")}

    blocks = []
    for i in range(cfg.layers):
        L = f"{prefix}layers.{i}"
        blocks.append({
            "ln_sa": ln(f"{L}.self_attn_layer_norm"), "sa": attn(f"{L}.self_attn"),
            "ln_ca": ln(f"{L}.encoder_attn_layer_norm"), "ca": attn(f"{L}.encoder_attn"),
            "ln_ff": ln(f"{L}.final_layer_norm"),
            "fc1": _lin_t(sd, f"{L}.fc1"), "fc2": _lin_t(sd, f"{L}.fc2"),
        })
    params = {
        "embed_tokens": np.stack([_w(sd, f"{prefix}embed_tokens.{k}.weight") for k in range(cfg.codebooks)]),
        "blocks": _stack(blocks),
        "final_ln": ln(f"{prefix}layer_norm"),
        "lm_heads": np.stack([_w(sd, f"{lm_prefix}{k}.weight").T for k in range(cfg.codebooks)]),
        "embed_prompts": (_w(sd, embed_prompts_key) if embed_prompts_key is not None
                          else np.zeros((cfg.prompt_vocab, cfg.hidden), np.float32)),
    }
    if enc_proj_prefix is not None and f"{enc_proj_prefix}.weight" in sd:
        params["enc_proj"] = _lin_t(sd, enc_proj_prefix)
    return _fp32(params)


def _conv_wn(sd, prefix):
    """Conv weight and bias, folding weight norm where the checkpoint keeps it
    (``parametrizations.weight.original{0,1}``, or the ``weight_g`` /
    ``weight_v`` pair of descript-audio-codec checkpoints):
    ``g * v / max(||v||, 1e-12)``, the norm over every axis but the first."""
    if f"{prefix}.weight" in sd:
        return _w(sd, f"{prefix}.weight"), _w(sd, f"{prefix}.bias")
    if f"{prefix}.weight_g" in sd:
        g, v = _w(sd, f"{prefix}.weight_g"), _w(sd, f"{prefix}.weight_v")
    else:
        g = _w(sd, f"{prefix}.parametrizations.weight.original0")
        v = _w(sd, f"{prefix}.parametrizations.weight.original1")
    norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12), _w(sd, f"{prefix}.bias")


def convert_dac(sd: dict, cfg: DacConfig = DacConfig(), prefix: str = "") -> dict:
    """transformers DacModel state dict (decoder + quantizer) -> the numpy tree
    of ``init_dac_numpy``, in the JAX layout: Conv1d ``(out, in, k)`` ->
    ``(k, in, out)``; ConvTranspose1d ``(in, out, k)`` -> ``(k, in, out)``
    flipped along time (``parler_params_from_numpy`` undoes the flip)."""
    from f5tts_tpu_torch.models.convert import _fp32

    def conv(p):
        w, b = _conv_wn(sd, p)
        return {"w": np.ascontiguousarray(w.transpose(2, 1, 0)), "b": b}

    def convt(p):
        w, b = _conv_wn(sd, p)
        return {"w": np.ascontiguousarray(w.transpose(2, 0, 1)[::-1]), "b": b}

    q = f"{prefix}quantizer.quantizers"
    n = range(cfg.num_codebooks)
    quant = {
        "codebook": np.stack([_w(sd, f"{q}.{i}.codebook.weight") for i in n]),
        "proj_w": np.stack([_conv_wn(sd, f"{q}.{i}.out_proj")[0].transpose(2, 1, 0)[0] for i in n]),
        "proj_b": np.stack([_w(sd, f"{q}.{i}.out_proj.bias") for i in n]),
    }
    d = f"{prefix}decoder"
    blocks = []
    for i in range(len(cfg.rates)):
        B = f"{d}.block.{i}"
        blocks.append({
            "alpha": _w(sd, f"{B}.snake1.alpha").reshape(-1),
            "convt": convt(f"{B}.conv_t1"),
            "res": [{"alpha1": _w(sd, f"{B}.res_unit{j}.snake1.alpha").reshape(-1),
                     "conv1": conv(f"{B}.res_unit{j}.conv1"),
                     "alpha2": _w(sd, f"{B}.res_unit{j}.snake2.alpha").reshape(-1),
                     "conv2": conv(f"{B}.res_unit{j}.conv2")} for j in (1, 2, 3)],
        })
    return _fp32({
        "quant": quant,
        "conv1": conv(f"{d}.conv1"),
        "blocks": blocks,
        "alpha_out": _w(sd, f"{d}.snake1.alpha").reshape(-1),
        "conv2": conv(f"{d}.conv2"),
    })


def _descript_renames(cfg: DacConfig) -> dict[str, str]:
    """descript-audio-codec decoder key -> transformers DacModel key."""
    nb = len(cfg.rates)
    ren: dict[str, str] = {}

    def unit(src, dst):
        for suf in ("weight", "bias", "weight_g", "weight_v", "alpha",
                    "parametrizations.weight.original0", "parametrizations.weight.original1"):
            ren[f"{src}.{suf}"] = f"{dst}.{suf}"

    unit("decoder.model.0", "decoder.conv1")
    for i in range(nb):
        B, H = f"decoder.model.{1 + i}", f"decoder.block.{i}"
        unit(f"{B}.block.0", f"{H}.snake1")
        unit(f"{B}.block.1", f"{H}.conv_t1")
        for j in range(3):
            R, RH = f"{B}.block.{2 + j}", f"{H}.res_unit{j + 1}"
            for s, t in enumerate(("snake1", "conv1", "snake2", "conv2")):
                unit(f"{R}.block.{s}", f"{RH}.{t}")
    unit(f"decoder.model.{1 + nb}", "decoder.snake1")
    unit(f"decoder.model.{2 + nb}", "decoder.conv2")
    return ren


def descript_dac_to_hf_keys(sd: dict, cfg: DacConfig = DacConfig(), prefix: str = "") -> dict:
    """Rename descript-audio-codec state-dict keys (what real ParlerTTS
    checkpoints embed under ``audio_encoder.model.``) to the transformers
    DacModel layout ``convert_dac`` reads. Only keys under ``prefix`` are kept,
    the prefix stripped.

    descript's decoder is a positional ``nn.Sequential``: ``decoder.model.0``
    the first conv; ``decoder.model.{1+i}`` decoder block i, whose
    ``block.0`` is the snake, ``block.1`` the transposed conv and
    ``block.{2..4}`` the residual units (inner ``block.{0..3}``: snake, conv
    k7, snake, conv k1); then the last snake and conv. Quantizer names already
    match. Weight-norm tensors pass through for ``_conv_wn``."""
    ren = _descript_renames(cfg)
    out = {}
    for k, v in sd.items():
        if prefix and not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        out[ren.get(k, k)] = v
    return out


def load_parler_checkpoint(path: str, t5_cfg: T5Config | None = None, dec_cfg: ParlerDecoderConfig | None = None,
                           dac_cfg: DacConfig | None = None):
    """One ParlerTTSForConditionalGeneration state dict (``.pt`` /
    ``.safetensors``) -> ``(t5, decoder, dac)`` numpy trees, which
    ``parler_params_from_numpy`` (or ``ParlerTTSEngine``) takes.

    The HF layout ``ai4bharat/indic-parler-tts`` ships: the T5 description
    encoder under ``text_encoder.``, the codebook decoder under
    ``decoder.model.decoder.`` with LM heads at ``decoder.lm_heads.``, prompt
    embeddings at ``embed_prompts.weight``, an optional ``enc_to_dec_proj``,
    and the DAC under ``audio_encoder.model.`` in descript's positional layout
    (HF-named DAC keys pass through)."""
    from f5tts_tpu_torch.models.convert import load_torch_state_dict

    sd = load_torch_state_dict(path)
    t5_cfg, dec_cfg, dac_cfg = t5_cfg or T5Config(), dec_cfg or ParlerDecoderConfig(), dac_cfg or DacConfig()
    t5 = convert_t5_encoder(sd, t5_cfg, prefix="text_encoder.")
    dec = convert_parler_decoder(sd, dec_cfg, prefix="decoder.model.decoder.", lm_prefix="decoder.lm_heads.",
                                 embed_prompts_key="embed_prompts.weight", enc_proj_prefix="enc_to_dec_proj")
    dac = convert_dac(descript_dac_to_hf_keys(sd, dac_cfg, prefix="audio_encoder.model."), dac_cfg)
    return t5, dec, dac
