"""Parameter trees: ``.npz`` files, numpy -> torch, seeded random init, and
params of a model the port trained (counterpart of
``f5tts_tpu/models/convert.py:save_params_npz``/``load_params_npz``/
``load_trained_checkpoint``).

The JAX package's parameter tree is nested dicts of arrays with the blocks
stacked on a leading depth axis; ``f5tpu-convert`` writes it to one ``.npz``
with '/'-joined keys. The port reads the same files and keeps the same tree
and layouts (Linear ``w (in, out)``, conv ``(k, in/groups, out)``), as torch
tensors on a chosen device and dtype. The Parler branch's three trees (T5
encoder, decoder, DAC) cross through ``parler_params_from_numpy``; its
checkpoint converters (HF / Descript state dicts) exist only in the JAX
package so far.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.models.parler import DacConfig, ParlerDecoderConfig, T5Config
from f5tts_tpu_torch.models.vocos import VocosConfig


def save_params_npz(path: str, params: dict) -> None:
    """Params tree (numpy arrays or tensors) -> one ``.npz`` with '/'-joined keys."""
    flat: dict[str, np.ndarray] = {}

    def rec(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(tree, torch.Tensor):
            flat[prefix] = tree.detach().float().cpu().numpy() if tree.is_floating_point() else tree.cpu().numpy()
        elif tree is not None:
            flat[prefix] = np.asarray(tree)

    rec("", params)
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict:
    """Inverse of ``save_params_npz``: the numpy params tree."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def load_trained_checkpoint(directory: str) -> dict:
    """The EMA params (what is served) of the newest step of a checkpoint
    directory written by the port's ``Trainer``, as a numpy tree that
    ``TTSEngine`` takes as it is."""
    from f5tts_tpu_torch.train.checkpoint import latest_step, restore_state
    from f5tts_tpu_torch.train.tree import tree_map

    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint steps under {directory!r}")
    return tree_map(lambda t: t.float().numpy(), restore_state(directory, step)["ema"])


def export_trained_params(directory: str, path: str) -> None:
    """A trained checkpoint's EMA params as the JAX package's ``.npz`` (what
    ``f5tpu-convert`` writes and both ``load_params_npz`` read)."""
    save_params_npz(path, load_trained_checkpoint(directory))


def params_from_numpy(tree, device: torch.device | str, dtype: torch.dtype | None = None):
    """numpy tree -> torch tree on ``device``; floating leaves cast to ``dtype``
    when given (the engine's bf16 serving copy), other leaves unchanged: the
    int8 weights ``w_q`` of a quantized tree, and their scales ``s_w``, which
    stay fp32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, None if k == "s_w" else dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):  # the DAC's stages differ in width and are a list, not a stack
        return [params_from_numpy(v, device, dtype) for v in tree]
    if tree is None:
        return None
    t = torch.as_tensor(np.require(tree, requirements="W"))  # writable: torch tensors may be written
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _require(tree: dict, keys: tuple[str, ...], what: str) -> None:
    missing = [k for k in keys if k not in tree]
    if missing:
        raise KeyError(f"{what} params tree lacks {missing}")


def dit_params_from_numpy(tree: dict, device, dtype: torch.dtype | None = None) -> dict:
    """The JAX DiT params tree (numpy, stacked blocks) as the port's tensors."""
    _require(tree, ("time_embed", "text_embed", "input_embed", "blocks", "norm_out", "proj_out"), "DiT")
    return params_from_numpy(tree, device, dtype)


def vocos_params_from_numpy(tree: dict, device, dtype: torch.dtype | None = None) -> dict:
    """The JAX Vocos params tree (numpy, stacked blocks) as the port's tensors."""
    _require(tree, ("embed", "norm_w", "norm_b", "blocks", "final_norm_w", "final_norm_b", "head"), "Vocos")
    return params_from_numpy(tree, device, dtype)


def parler_params_from_numpy(t5: dict, dec: dict, dac: dict, device, dtype: torch.dtype | None = None):
    """The JAX package's Parler parameter trees (numpy: ``init_t5_encoder``,
    ``init_parler_decoder``, ``init_dac_decoder`` or their converters' output)
    as the port's tensors: ``(t5, decoder, dac)``.

    Everything keeps its JAX layout except the DAC's transposed convolutions.
    The JAX package stores those kernels ``(k, in, out)`` and flipped along
    time, because ``lax.conv_transpose`` correlates where torch convolves; the
    flip is undone here, once, and the kernel laid out ``(in, out, k)`` for
    ``F.conv_transpose1d`` (``models/parler.py:_dac_convt``)."""
    _require(t5, ("embed", "rel_bias", "blocks", "final_ln"), "T5 encoder")
    _require(dec, ("embed_tokens", "embed_prompts", "blocks", "final_ln", "lm_heads"), "Parler decoder")
    _require(dac, ("quant", "conv1", "blocks", "alpha_out", "conv2"), "DAC decoder")
    dac = dict(dac)
    dac["blocks"] = [
        {**blk, "convt": {**blk["convt"], "w": np.ascontiguousarray(
            np.asarray(blk["convt"]["w"])[::-1].transpose(1, 2, 0))}}
        for blk in dac["blocks"]]
    return (params_from_numpy(t5, device, dtype), params_from_numpy(dec, device, dtype),
            params_from_numpy(dac, device, dtype))


# ---------------------------------------------------------------------------
# seeded random init (torch's default Linear/Conv1d init, in numpy)
# ---------------------------------------------------------------------------


class _Init:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def uniform(self, shape, bound: float) -> np.ndarray:
        return (self.rng.random(shape, dtype=np.float32) * np.float32(2 * bound) - np.float32(bound))

    def linear(self, d_in: int, d_out: int, bias: bool = True, depth: int | None = None) -> dict:
        lead = () if depth is None else (depth,)
        bound = 1.0 / math.sqrt(d_in)
        p = {"w": self.uniform((*lead, d_in, d_out), bound)}
        if bias:
            p["b"] = self.uniform((*lead, d_out), bound)
        return p

    def conv1d(self, d_in: int, d_out: int, width: int, groups: int = 1, depth: int | None = None) -> dict:
        lead = () if depth is None else (depth,)
        bound = 1.0 / math.sqrt((d_in // groups) * width)
        return {"w": self.uniform((*lead, width, d_in // groups, d_out), bound),
                "b": self.uniform((*lead, d_out), bound)}


def _convnext_v2(init: _Init, dim: int, inter: int, depth: int) -> dict:
    return {
        "dwconv": init.conv1d(dim, dim, 7, groups=dim, depth=depth),
        "norm_w": np.ones((depth, dim), np.float32),
        "norm_b": np.zeros((depth, dim), np.float32),
        "pw1": init.linear(dim, inter, depth=depth),
        "grn_gamma": np.zeros((depth, inter), np.float32),
        "grn_beta": np.zeros((depth, inter), np.float32),
        "pw2": init.linear(inter, dim, depth=depth),
    }


def init_dit_numpy(cfg: DiTConfig, seed: int = 0) -> dict:
    """Random DiT params tree (numpy fp32) at any ``DiTConfig`` width, with the
    JAX ``init_dit`` tree, shapes and init distributions."""
    init = _Init(seed)
    inner = cfg.heads * cfg.dim_head
    d = cfg.depth
    params = {
        "time_embed": {"mlp1": init.linear(256, cfg.dim), "mlp2": init.linear(cfg.dim, cfg.dim)},
        "text_embed": {
            "embed": {"w": init.rng.standard_normal((cfg.text_num_embeds + 1, cfg.text_dim), dtype=np.float32)},
            "blocks": _convnext_v2(init, cfg.text_dim, cfg.text_dim * 2, cfg.conv_layers) if cfg.conv_layers > 0 else None,
        },
        "input_embed": {
            "proj": init.linear(cfg.mel_dim * 2 + cfg.text_dim, cfg.dim),
            "conv_pos": {"conv1": init.conv1d(cfg.dim, cfg.dim, 31, 16), "conv2": init.conv1d(cfg.dim, cfg.dim, 31, 16)},
        },
        "blocks": {
            "attn_norm": {"linear": init.linear(cfg.dim, cfg.dim * 6, depth=d)},
            "attn": {
                "to_q": init.linear(cfg.dim, inner, depth=d),
                "to_k": init.linear(cfg.dim, inner, depth=d),
                "to_v": init.linear(cfg.dim, inner, depth=d),
                "to_out": init.linear(inner, cfg.dim, depth=d),
            },
            "ff": {"in": init.linear(cfg.dim, cfg.dim * cfg.ff_mult, depth=d),
                   "out": init.linear(cfg.dim * cfg.ff_mult, cfg.dim, depth=d)},
        },
        "norm_out": {"linear": init.linear(cfg.dim, cfg.dim * 2)},
        "proj_out": init.linear(cfg.dim, cfg.mel_dim),
    }
    if cfg.long_skip_connection:
        params["long_skip"] = init.linear(cfg.dim * 2, cfg.dim, bias=False)
    return params


def init_vocos_numpy(cfg: VocosConfig = VocosConfig(), seed: int = 1) -> dict:
    """Random Vocos params tree (numpy fp32) with the JAX ``init_vocos`` tree."""
    init = _Init(seed)
    L = cfg.num_layers
    return {
        "embed": init.conv1d(cfg.input_channels, cfg.dim, 7),
        "norm_w": np.ones((cfg.dim,), np.float32),
        "norm_b": np.zeros((cfg.dim,), np.float32),
        "blocks": {
            "dwconv": init.conv1d(cfg.dim, cfg.dim, 7, groups=cfg.dim, depth=L),
            "norm_w": np.ones((L, cfg.dim), np.float32),
            "norm_b": np.zeros((L, cfg.dim), np.float32),
            "pw1": init.linear(cfg.dim, cfg.intermediate_dim, depth=L),
            "pw2": init.linear(cfg.intermediate_dim, cfg.dim, depth=L),
            "gamma": np.full((L, cfg.dim), 1.0 / L, np.float32),
        },
        "final_norm_w": np.ones((cfg.dim,), np.float32),
        "final_norm_b": np.zeros((cfg.dim,), np.float32),
        "head": init.linear(cfg.dim, cfg.head_out),
    }


def init_t5_numpy(cfg: T5Config = T5Config(), seed: int = 0) -> dict:
    """Random T5 encoder params tree (numpy fp32) with the JAX
    ``init_t5_encoder`` tree, shapes and init distributions."""
    init = _Init(seed)
    L = cfg.layers

    def nobias(d_in, d_out):
        return init.linear(d_in, d_out, bias=False, depth=L)

    def gain():
        return {"g": np.ones((L, cfg.d_model), np.float32)}

    return {
        "embed": init.rng.standard_normal((cfg.vocab, cfg.d_model), dtype=np.float32),
        "rel_bias": init.rng.standard_normal((cfg.rel_buckets, cfg.heads), dtype=np.float32) * np.float32(0.02),
        "blocks": {
            "ln1": gain(),
            "q": nobias(cfg.d_model, cfg.inner), "k": nobias(cfg.d_model, cfg.inner),
            "v": nobias(cfg.d_model, cfg.inner), "o": nobias(cfg.inner, cfg.d_model),
            "ln2": gain(),
            "wi_0": nobias(cfg.d_model, cfg.d_ff), "wi_1": nobias(cfg.d_model, cfg.d_ff),
            "wo": nobias(cfg.d_ff, cfg.d_model),
        },
        "final_ln": {"g": np.ones((cfg.d_model,), np.float32)},
    }


def init_parler_decoder_numpy(cfg: ParlerDecoderConfig = ParlerDecoderConfig(), seed: int = 1) -> dict:
    """Random Parler decoder params tree (numpy fp32) with the JAX
    ``init_parler_decoder`` tree, shapes and init distributions."""
    init = _Init(seed)
    L = cfg.layers

    def normal(shape):
        return init.rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def ln():
        return {"w": np.ones((L, cfg.hidden), np.float32), "b": np.zeros((L, cfg.hidden), np.float32)}

    def attn(kv_width):
        return {"q": init.linear(cfg.hidden, cfg.hidden, bias=False, depth=L),
                "k": init.linear(cfg.hidden, kv_width, bias=False, depth=L),
                "v": init.linear(cfg.hidden, kv_width, bias=False, depth=L),
                "o": init.linear(cfg.hidden, cfg.hidden, bias=False, depth=L)}

    params = {
        "embed_tokens": normal((cfg.codebooks, cfg.vocab + 1, cfg.hidden)),
        "embed_prompts": normal((cfg.prompt_vocab, cfg.hidden)),
        "blocks": {
            "ln_sa": ln(), "sa": attn(cfg.n_kv * cfg.head_dim),
            "ln_ca": ln(), "ca": attn(cfg.n_cross_kv * cfg.head_dim),
            "ln_ff": ln(),
            "fc1": init.linear(cfg.hidden, cfg.ffn, bias=False, depth=L),
            "fc2": init.linear(cfg.ffn, cfg.hidden, bias=False, depth=L),
        },
        "final_ln": {"w": np.ones((cfg.hidden,), np.float32), "b": np.zeros((cfg.hidden,), np.float32)},
        "lm_heads": normal((cfg.codebooks, cfg.hidden, cfg.vocab)),
    }
    if cfg.cross_dim != cfg.hidden:
        params["enc_proj"] = init.linear(cfg.cross_dim, cfg.hidden)
    return params


def init_dac_numpy(cfg: DacConfig = DacConfig(), seed: int = 2) -> dict:
    """Random DAC decoder params tree (numpy fp32) with the JAX
    ``init_dac_decoder`` tree and layouts (the transposed-conv kernels
    ``(k, in, out)`` as the JAX package stores them)."""
    init = _Init(seed)
    proj = [init.conv1d(cfg.codebook_dim, cfg.latent_dim, 1) for _ in range(cfg.num_codebooks)]
    quant = {
        "codebook": init.rng.standard_normal((cfg.num_codebooks, cfg.codebook_size, cfg.codebook_dim),
                                             dtype=np.float32),
        "proj_w": np.stack([p["w"][0] for p in proj]),  # (K, cdim, latent)
        "proj_b": np.stack([p["b"] for p in proj]),
    }
    blocks = []
    ch = cfg.decoder_dim
    for i, r in enumerate(cfg.rates):
        out = cfg.decoder_dim // (2 ** (i + 1))
        blocks.append({
            "alpha": np.ones((ch,), np.float32),
            "convt": init.conv1d(ch, out, 2 * r),
            "res": [{"alpha1": np.ones((out,), np.float32), "conv1": init.conv1d(out, out, 7),
                     "alpha2": np.ones((out,), np.float32), "conv2": init.conv1d(out, out, 1)}
                    for _ in range(3)],
        })
        ch = out
    return {
        "quant": quant,
        "conv1": init.conv1d(cfg.latent_dim, cfg.decoder_dim, 7),
        "blocks": blocks,
        "alpha_out": np.ones((ch,), np.float32),
        "conv2": init.conv1d(ch, 1, 7),
    }
