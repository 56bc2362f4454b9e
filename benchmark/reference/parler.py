"""Indic Parler-TTS (ai4bharat/indic-parler-tts) written out in plain PyTorch,
float32 with TF32 off (``judge.full_fp32``): the T5 description encoder
(google/flan-t5-large), the decoder's full forward pass over ``[prompt ; BOS ;
delayed codes]`` with no cache, the delay pattern, the seeded draw and the
DAC decoder (descript/dac_44khz). It imports nothing of the program and takes
no tensor the program made but the codes it judges; the stand-in tokenizer of
the cell's files is here too.

The model, from the published equations (``m`` is a configuration's ``model``:
``t5``, ``decoder``, ``dac``):

- T5 encoder: ``h = embed[ids]``; per layer ``x = rms(h) * g`` (no mean, eps
  1e-6), unscaled attention ``softmax(q k^T + bias)`` where ``bias`` is the
  bucketed relative-position table of layer 0 shared by every layer (32
  buckets, bidirectional, max distance 128) plus -1e9 on padded keys;
  ``h += o``; ``h += wo(gelu_tanh(wi_0 x) * wi_1 x)``; a final RMS norm.
- Decoder: the 9 codebooks' embeddings summed, the left-padded transcript's
  embeddings (zero at pads) in front, MusicGen's sinusoidal positions
  (``cat[cos, sin]``, frequencies ``exp(-ln(10^4) i / (half - 1))``) over the
  whole sequence added. Per layer, pre-LayerNorm (eps 1e-5): causal
  self-attention (q scaled by ``d**-0.5``, padded prompt keys banned),
  cross-attention to the T5 states (padded description keys banned), an
  exact-GELU feed-forward. A final LayerNorm, then one LM head per codebook.
  A banned key adds -1e9 to its score: a query with every key banned (a
  prompt pad) gets uniform weights and stays finite, and no other position
  reads it.
- Delay pattern: position ``j`` (1-based) of codebook ``k`` holds code ``j - 1
  - k``; outside ``[0, length)`` the pad token, the code embedding's extra row
  (``vocab``), which is also BOS.
- Draw: per row and position a ``torch.Generator`` on the device seeded by
  ``(call seed & 0xFFFF) << 47 | (row seed & 0x7FFFFFFF) << 16 | (position &
  0xFFFF)`` draws ``e ~ Exp(1)`` of shape ``(codebooks, vocab)``; the token is
  ``argmax(softmax(logits / T) / e)`` (the exponential race, one categorical
  draw per codebook), greedy at ``T <= 0``, with the top-k filter where
  ``top_k > 0``. The engine's call seed is 0.
- DAC decoder: codes at or above the codebook size read as 0; ``z = sum_k
  codebook_k[c_k] W_k + b_k``; conv k7 to 1536 channels; four blocks of
  snake (``x + sin^2(a x) / (a + 1e-9)``), a transposed conv (kernel ``2r``,
  stride ``r``, padding ``ceil(r / 2)``) halving the channels, and residual
  units at dilations 1, 3, 9 (snake, conv k7, snake, conv k1, added); a last
  snake, conv k7 to one channel and tanh: ``frames * 512`` samples at 44.1 kHz.

Departures from the published model, each shared with the program: the
weights are random (drawn from the seed, rounded to bf16), so weight norm is
already folded; the tokenizer is the stand-in below, not T5's sentencepiece;
BOS and pad are the code embedding's extra row; EOS is off in the cell
(``eos_token`` -1), so every row decodes its whole budget.

``layers.PRECISION["all"] = "fp8"`` holds every product's operands and result,
each norm's output, the residual streams, the logits and the DAC's
activations in float8 e4m3: the control.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F

from benchmark.reference import layers as L

NEG = -1e9  # the score a banned key gets


# ---------------------------------------------------------------------------
# the stand-in tokenizer and padding
# ---------------------------------------------------------------------------


def token_ids(text: str, tok: dict) -> list[int]:
    """``tok["pieces_per_word"]`` ids per whitespace-separated word, each a
    hash of ``(tok["seed"], piece, word)`` into ``[tok["first_id"],
    tok["end_id"])``: the same word always gives the same ids."""
    out = []
    span = tok["end_id"] - tok["first_id"]
    for word in text.split():
        for piece in range(tok["pieces_per_word"]):
            h = hashlib.blake2b(f"{tok['seed']}|{piece}|{word}".encode(), digest_size=8).digest()
            out.append(tok["first_id"] + int.from_bytes(h, "little") % span)
    return out


def padded(ids_list: list[list[int]], pad_to: int, left: bool, device):
    """``(ids (b, pad_to), mask)``: right-padded descriptions, left-padded
    prompts (every prompt abuts BOS), pads 0 and masked."""
    ids = torch.zeros((len(ids_list), pad_to), dtype=torch.long)
    mask = torch.zeros((len(ids_list), pad_to), dtype=torch.bool)
    for i, row in enumerate(ids_list):
        row = torch.as_tensor(row[-pad_to:] if left else row[:pad_to], dtype=torch.long)
        s = slice(pad_to - len(row), pad_to) if left else slice(0, len(row))
        ids[i, s], mask[i, s] = row, True
    return ids.to(device), mask.to(device)


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------


def _rms(g, x, eps=1e-6):
    return L.rnd(x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g)


def rel_bucket(rel: torch.Tensor, buckets: int, max_dist: int) -> torch.Tensor:
    """T5's bidirectional bucket of ``memory - query``: half the buckets per
    direction, exact below a quarter of them, logarithmic up to ``max_dist``."""
    half = buckets // 2
    out = (rel > 0).long() * half
    rel = rel.abs()
    exact = half // 2
    large = exact + (torch.log(rel.float().clamp_min(1) / exact) / math.log(max_dist / exact) * (half - exact)).long()
    return out + torch.where(rel < exact, rel, large.clamp_max(half - 1))


def _heads(t, heads):
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def _attend(q, k, v, bias):
    """``(b, h, nq, d)`` queries against ``(b, h, nk, d)``: softmax over
    scores plus ``bias``, merged back to ``(b, nq, h * d)``."""
    o = torch.softmax(q @ k.transpose(-1, -2) + bias, -1) @ v
    b, _, nq, _ = o.shape
    return L.rnd(o.transpose(1, 2).reshape(b, nq, -1))


@torch.no_grad()
def t5_encode(p, t5: dict, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``ids``, ``mask (b, n)`` -> ``(b, n, d_model)``."""
    n = ids.shape[1]
    pos = torch.arange(n, device=ids.device)
    bucket = rel_bucket(pos[None, :] - pos[:, None], t5["rel_buckets"], t5["rel_max_dist"])
    bias = p["rel_bias"][bucket].permute(2, 0, 1)[None] + torch.where(mask, 0.0, NEG)[:, None, None, :]
    h = L.rnd(p["embed"][ids])
    for i in range(t5["layers"]):
        blk = L.block(p["blocks"], i)
        x = _rms(blk["ln1"]["g"], h)
        q, k, v = (_heads(L.linear(blk[name], x), t5["heads"]) for name in ("q", "k", "v"))
        h = L.rnd(h + L.linear(blk["o"], _attend(q, k, v, bias)))
        x = _rms(blk["ln2"]["g"], h)
        gate = L.rnd(F.gelu(L.linear(blk["wi_0"], x), approximate="tanh"))
        h = L.rnd(h + L.linear(blk["wo"], L.rnd(gate * L.linear(blk["wi_1"], x))))
    return _rms(p["final_ln"]["g"], h)


# ---------------------------------------------------------------------------
# the decoder's full forward
# ---------------------------------------------------------------------------


def sinusoids(n: int, dim: int, device) -> torch.Tensor:
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=device) * -(math.log(10000.0) / (half - 1)))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * freq[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], 1)


def _ln(p, x):
    return L.layer_norm(x, 1e-5, p["w"], p["b"])


def _mha(p, x, kv, heads, bias):
    scale = (x.shape[-1] // heads) ** -0.5
    q = _heads(L.rnd(L.linear(p["q"], x) * scale), heads)
    return L.linear(p["o"], _attend(q, _heads(L.linear(p["k"], kv), heads), _heads(L.linear(p["v"], kv), heads), bias))


def delay_stream(codes: torch.Tensor, length: int, steps: int, pad: int) -> torch.Tensor:
    """One row's codes ``(K, frames)`` -> its delayed stream ``(K, steps)``
    (position ``j`` at index ``j - 1``), pad outside ``[0, length)``."""
    K = codes.shape[0]
    j = torch.arange(steps, device=codes.device)[None, :]
    idx = j - torch.arange(K, device=codes.device)[:, None]  # code index j - 1 - k, 0-based positions
    ok = (idx >= 0) & (idx < length)
    return torch.where(ok, codes.gather(1, idx.clamp(0, codes.shape[1] - 1)), pad)


@torch.no_grad()
def decoder_logits(p, dec: dict, enc, enc_mask, prompt, prompt_mask, stream) -> torch.Tensor:
    """Logits ``(b, steps, K, vocab)`` of the full forward over ``[prompt ;
    BOS ; stream[..., :steps - 1]]`` for ``stream (b, K, steps)``: entry
    ``s`` is the distribution position ``s + 1`` is drawn from."""
    b, K, steps = stream.shape
    dev = stream.device
    codes = torch.cat([torch.full((b, K, 1), dec["vocab"], dtype=torch.long, device=dev), stream[..., :-1]], 2)
    x = sum(p["embed_tokens"][k][codes[:, k]] for k in range(K))
    pe = p["embed_prompts"][prompt] * prompt_mask[..., None]
    h = torch.cat([pe, x], 1)
    n, np_ = h.shape[1], prompt.shape[1]
    h = L.rnd(h + sinusoids(n, dec["hidden"], dev)[None])
    keys = torch.cat([prompt_mask, torch.ones((b, steps), dtype=torch.bool, device=dev)], 1)
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))[None, None] & keys[:, None, None, :]
    sa_bias = torch.where(causal, 0.0, NEG)
    ca_bias = torch.where(enc_mask, 0.0, NEG)[:, None, None, :]
    if "enc_proj" in p:
        enc = L.linear(p["enc_proj"], enc)
    for i in range(dec["layers"]):
        blk = L.block(p["blocks"], i)
        xn = _ln(blk["ln_sa"], h)
        h = L.rnd(h + _mha(blk["sa"], xn, xn, dec["heads"], sa_bias))
        h = L.rnd(h + _mha(blk["ca"], _ln(blk["ln_ca"], h), enc, dec["heads"], ca_bias))
        y = _ln(blk["ln_ff"], h)
        h = L.rnd(h + L.linear(blk["fc2"], L.rnd(F.gelu(L.linear(blk["fc1"], y)))))
    h = _ln(p["final_ln"], h)[:, np_:]
    return torch.stack([L.linear({"w": p["lm_heads"][k]}, h) for k in range(K)], 2)


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------


def position_seed(seed: int, row_seed: int, j: int) -> int:
    return ((int(seed) & 0xFFFF) << 47) | ((int(row_seed) & 0x7FFFFFFF) << 16) | (int(j) & 0xFFFF)


@torch.no_grad()
def draw(logits: torch.Tensor, row_seed: int, temperature: float, top_k: int, seed: int = 0) -> torch.Tensor:
    """One row's tokens ``(steps, K)`` from its logits ``(steps, K, vocab)``."""
    if temperature <= 0:
        return logits.argmax(-1)
    g = torch.Generator(device=logits.device)
    out = []
    for s in range(logits.shape[0]):
        x = logits[s] / temperature
        if top_k > 0:
            x = torch.where(x < torch.topk(x, top_k, -1).values[..., -1:], -torch.inf, x)
        probs = torch.softmax(x, -1)
        g.manual_seed(position_seed(seed, row_seed, s + 1))
        out.append((probs / torch.empty_like(probs).exponential_(1.0, generator=g)).argmax(-1))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# DAC decoder
# ---------------------------------------------------------------------------


def _conv(p, x, padding=0, dilation=1):
    """Channel-last ``x (b, n, c)``, ``w (k, in, out)``."""
    w = p["w"]
    if L.PRECISION["all"] == "fp8":
        x, w = L.fp8(x, -1), L.fp8(w, (0, 1))
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), p["b"], padding=padding, dilation=dilation)
    return L.rnd(y.transpose(1, 2))


def _conv_t(p, x, stride):
    """Transposed conv, ``w (in, out, 2 * stride)``."""
    w = p["w"]
    if L.PRECISION["all"] == "fp8":
        x, w = L.fp8(x, -1), L.fp8(w, (1, 2))
    y = F.conv_transpose1d(x.transpose(1, 2), w, p["b"], stride=stride, padding=math.ceil(stride / 2))
    return L.rnd(y.transpose(1, 2))


def _snake(x, alpha):
    return L.rnd(x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9))


@torch.no_grad()
def dac_decode(p, dac: dict, codes: torch.Tensor) -> torch.Tensor:
    """``codes (b, K, n)`` -> ``(b, n * hop)`` samples in [-1, 1]."""
    q = p["quant"]
    codes = torch.where((codes >= 0) & (codes < dac["codebook_size"]), codes, 0).long()
    z = sum(L.linear({"w": q["proj_w"][k], "b": q["proj_b"][k]}, q["codebook"][k][codes[:, k]])
            for k in range(codes.shape[1]))
    x = _conv(p["conv1"], L.rnd(z), padding=3)
    for i, r in enumerate(dac["rates"]):
        blk = p["blocks"][str(i)]
        x = _conv_t(blk["convt"], _snake(x, blk["alpha"]), r)
        for u, dil in enumerate((1, 3, 9)):
            ru = blk["res"][str(u)]
            y = _conv(ru["conv1"], _snake(x, ru["alpha1"]), padding=3 * dil, dilation=dil)
            x = L.rnd(x + _conv(ru["conv2"], _snake(y, ru["alpha2"])))
    x = _conv(p["conv2"], _snake(x, p["alpha_out"]), padding=3)
    return torch.tanh(x[..., 0])
