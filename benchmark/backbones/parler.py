"""Indic Parler-TTS (ai4bharat/indic-parler-tts): the T5 description encoder,
the delay-pattern decoder over the DAC's codebooks, the DAC decoder. The
weight layout the benchmark draws (``m`` is a configuration's ``model``:
``t5``, ``decoder``, ``dac``), the program's engine built on it with the
options the cell's files state, and the arithmetic of the work: FLOPs of a
row-position of the decode, of the prefill, of an encoded token and of a DAC
frame, and the bytes of a position's ``decode_attn`` calls.

The layout is the program's own parameter tree except the DAC's: its stages
are dicts keyed ``"0"``, ``"1"``, ... (the weight maker walks dicts) and its
transposed convolutions are held as ``F.conv_transpose1d`` takes them, ``(in,
out, k)``; ``program_trees`` lays them out as the program loads them.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import weights as W
from benchmark.reference import parler as R
from benchmark.serving import DTYPES, _leaves


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _t5(t):
    d, inner, L = t["d_model"], t["heads"] * t["d_kv"], t["layers"]

    def lin(i, o):
        return W.linear(i, o, bias=False, depth=L)

    return {"embed": ((t["vocab"], d), ("n",)), "rel_bias": ((t["rel_buckets"], t["heads"]), ("n",)),
            "blocks": {"ln1": {"g": W.const((L, d), 1.0)}, "q": lin(d, inner), "k": lin(d, inner), "v": lin(d, inner),
                       "o": lin(inner, d), "ln2": {"g": W.const((L, d), 1.0)}, "wi_0": lin(d, t["d_ff"]),
                       "wi_1": lin(d, t["d_ff"]), "wo": lin(t["d_ff"], d)},
            "final_ln": {"g": W.const((d,), 1.0)}}


def _decoder(c):
    h, L, K = c["hidden"], c["layers"], c["codebooks"]

    def ln(lead=(L,)):
        return {"w": W.const((*lead, h), 1.0), "b": W.const((*lead, h), 0.0)}

    def attn():  # full multi-head attention; the cross K/V read states of the decoder's width
        return {name: W.linear(h, h, False, L) for name in ("q", "k", "v", "o")}

    out = {"embed_tokens": ((K, c["vocab"] + 1, h), ("n",)), "embed_prompts": ((c["prompt_vocab"], h), ("n",)),
           "blocks": {"ln_sa": ln(), "sa": attn(), "ln_ca": ln(), "ca": attn(), "ln_ff": ln(),
                      "fc1": W.linear(h, c["ffn"], False, L), "fc2": W.linear(c["ffn"], h, False, L)},
           "final_ln": ln(()), "lm_heads": ((K, h, c["vocab"]), ("u", 1.0 / math.sqrt(h)))}
    if c["cross_dim"] != h:
        out["enc_proj"] = W.linear(c["cross_dim"], h)
    return out


def _dac(a):
    K, cdim, b = a["num_codebooks"], a["codebook_dim"], 1.0 / math.sqrt(a["codebook_dim"])
    blocks, ch = {}, a["decoder_dim"]
    for i, r in enumerate(a["rates"]):
        out = ch // 2
        bt = 1.0 / math.sqrt(out * 2 * r)  # ConvTranspose1d's fan-in: out channels x kernel
        blocks[str(i)] = {"alpha": W.const((ch,), 1.0),
                          "convt": {"w": ((ch, out, 2 * r), ("u", bt)), "b": ((out,), ("u", bt))},
                          "res": {str(u): {"alpha1": W.const((out,), 1.0), "conv1": W.conv1d(out, out, 7),
                                           "alpha2": W.const((out,), 1.0), "conv2": W.conv1d(out, out, 1)}
                                  for u in range(3)}}
        ch = out
    return {"quant": {"codebook": ((K, a["codebook_size"], cdim), ("n",)),
                      "proj_w": ((K, cdim, a["latent_dim"]), ("u", b)), "proj_b": ((K, a["latent_dim"]), ("u", b))},
            "conv1": W.conv1d(a["latent_dim"], a["decoder_dim"], 7), "blocks": blocks,
            "alpha_out": W.const((ch,), 1.0), "conv2": W.conv1d(ch, 1, 7)}


def layout(m):
    return {"t5": _t5(m["t5"]), "decoder": _decoder(m["decoder"]), "dac": _dac(m["dac"])}


def stated_engine(cell) -> dict:
    """``ParlerEngineConfig`` keywords as the cell's files state them (the
    configuration's ``serving.engine``, the mix's ``engine`` over it)."""
    opts = {**cell.config["serving"]["engine"], **cell.traffic.get("engine", {})}
    return {k: tuple(v) if isinstance(v, list) else v for k, v in opts.items()}


def make_weights(cell, seed: int, device) -> dict:
    """fp32 tensors on ``device`` holding values of the serving dtype."""
    return W.make(layout(cell.config["model"]), W.seed_of(seed, "weights"), device,
                  round_to=DTYPES[stated_engine(cell)["compute_dtype"]])


def program(m):
    """The program's three config objects."""
    from f5tts_tpu_torch.models import parler as P

    return (P.T5Config(**m["t5"]), P.ParlerDecoderConfig(**m["decoder"]),
            P.DacConfig(**{**m["dac"], "rates": tuple(m["dac"]["rates"])}))


def program_trees(host: dict):
    """``(t5, decoder, dac)`` numpy trees as the program loads them: the DAC's
    stages as lists and its transposed-conv kernels ``(k, in, out)`` flipped
    in time, the layout ``parler_params_from_numpy`` undoes."""
    dac = dict(host["dac"])
    dac["blocks"] = [{"alpha": blk["alpha"],
                      "convt": {"w": np.ascontiguousarray(blk["convt"]["w"].transpose(2, 0, 1)[::-1]),
                                "b": blk["convt"]["b"]},
                      "res": [blk["res"][str(u)] for u in range(len(blk["res"]))]}
                     for _, blk in sorted(dac["blocks"].items(), key=lambda kv: int(kv[0]))]
    return host["t5"], host["decoder"], dac


def encode_fn(cell):
    """The cell's stand-in tokenizer (``reference/parler.py:token_ids``)."""
    tok = cell.config["tokenizer"]
    return lambda text: R.token_ids(text, tok)


def build_engine(cell, seed: int, device):
    """The program's ``ParlerTTSEngine`` on the seed's weights (one host copy,
    which the engine casts to the serving dtype and uploads) with the options
    the cell's files state."""
    from f5tts_tpu_torch.engine.ar_engine import ParlerEngineConfig, ParlerTTSEngine

    t5, dec, dac = program_trees(W.to_numpy(make_weights(cell, seed, device)))
    t5_cfg, dec_cfg, dac_cfg = program(cell.config["model"])
    return ParlerTTSEngine(t5, t5_cfg, dec, dec_cfg, dac, dac_cfg, ParlerEngineConfig(**stated_engine(cell)),
                           encode_fn=encode_fn(cell), device=device)


def departures(engine, cell) -> int:
    """Each stated option the engine (and the decoder config it made) holds
    otherwise, and each weight tensor not in the stated dtype. 0 when sound."""
    stated = stated_engine(cell)
    off = sum(getattr(engine.cfg, k, None) != v for k, v in stated.items())
    off += sum(getattr(engine.dec_cfg, k) != stated[k] for k in ("fuse_decode_qkv", "decode_attn"))
    dtype = DTYPES[stated["compute_dtype"]]
    return off + sum(t.dtype != dtype for t in _leaves([engine.t5_params, engine.dec_params, engine.dac_params]))


# ---------------------------------------------------------------------------
# arithmetic (2 FLOPs a multiply-add; norms, activations, softmax and
# embedding sums not counted)
# ---------------------------------------------------------------------------


def _layer_linear_flops(c):
    """One token through one decoder layer's projections and feed-forward."""
    h = c["hidden"]
    return 2 * h * 3 * h + 2 * h * h + 2 * 2 * h * h + 2 * 2 * h * c["ffn"]  # q|k|v, o, cross q and o, fc1 and fc2


def _head_flops(c):
    return 2 * c["hidden"] * c["codebooks"] * c["vocab"]


def row_position_flops(m, keys: float, cross: int) -> float:
    """One row through one decode step whose self-attention sees ``keys``
    cached positions and whose cross-attention sees ``cross`` encoder
    states: every layer's projections, feed-forward and the two attentions'
    products (``4 * positions * hidden``), then the LM heads."""
    c = m["decoder"]
    return c["layers"] * (_layer_linear_flops(c) + 4 * (keys + cross) * c["hidden"]) + _head_flops(c)


def prefill_flops(m, n: int, cross: int) -> float:
    """One row's prefill of ``n`` positions (``prompt_pad + 1``): each
    position through every layer, causal self-attention (position ``i``
    sees ``i`` keys), cross-attention to ``cross`` states, the cross K/V
    projections of the ``cross`` states once, the LM heads at the last
    position."""
    c = m["decoder"]
    h, L = c["hidden"], c["layers"]
    attn = 4 * h * (n * (n + 1) / 2 + n * cross)
    return L * (n * _layer_linear_flops(c) + attn + cross * 2 * 2 * c["cross_dim"] * h) + _head_flops(c)


def encoded_token_flops(m, n: int) -> float:
    """One description token through the T5 at sequence length ``n``."""
    t = m["t5"]
    d, inner = t["d_model"], t["heads"] * t["d_kv"]
    return t["layers"] * (2 * d * 3 * inner + 2 * inner * d + 2 * 3 * d * t["d_ff"] + 4 * n * inner)


def dac_frame_flops(m) -> float:
    """One latent frame through the DAC: the codebooks' projections, the
    first conv, each stage's transposed conv (over its input positions) and
    three residual units (k7 and k1 convs over its output positions), the
    last conv; ``hop`` samples out."""
    a = m["dac"]
    total = 2 * a["num_codebooks"] * a["codebook_dim"] * a["latent_dim"] + 2 * 7 * a["latent_dim"] * a["decoder_dim"]
    ch, up = a["decoder_dim"], 1
    for r in a["rates"]:
        out = ch // 2
        total += 2 * ch * out * 2 * r * up
        up *= r
        total += 3 * (2 * 7 * out * out + 2 * out * out) * up
        ch = out
    return total + 2 * 7 * ch * up


def decode_attn_bytes(m, rows: int, keys: float, cross: int) -> float:
    """Bytes one decode step's ``decode_attn`` calls need, all layers: per
    row the self-attention's ``keys`` cached K and V rows and the
    cross-attention's ``cross``, and each call's q read and o written, in
    bf16. The allocated cache beyond ``keys`` is not counted."""
    c = m["decoder"]
    h = c["hidden"]
    return c["layers"] * rows * 2 * (2 * (keys + cross) * h + 2 * 2 * h)
