"""Parameter trees: ``.npz`` files, numpy -> torch, seeded random init
(counterpart of ``f5tts_tpu/models/convert.py:save_params_npz``/``load_params_npz``).

The JAX package's parameter tree is nested dicts of arrays with the blocks
stacked on a leading depth axis; ``f5tpu-convert`` writes it to one ``.npz``
with '/'-joined keys. The port reads the same files and keeps the same tree
and layouts (Linear ``w (in, out)``, conv ``(k, in/groups, out)``), as torch
tensors on a chosen device and dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from f5tts_tpu_torch.models.dit import DiTConfig
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


def params_from_numpy(tree, device: torch.device | str, dtype: torch.dtype | None = None):
    """numpy tree -> torch tree on ``device``; floating leaves cast to ``dtype``
    when given (the engine's bf16 serving copy), other leaves unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
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
