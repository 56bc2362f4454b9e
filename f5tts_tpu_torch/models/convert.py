"""Parameter trees: torch checkpoints, ``.npz`` files, numpy -> torch, seeded
random init, and params of a model the port trained (counterpart of
``f5tts_tpu/models/convert.py``, and of ``convert_bigvgan`` in
``f5tts_tpu/models/bigvgan.py``).

The JAX package's parameter tree is nested dicts of arrays with the blocks
stacked on a leading depth axis; ``f5tpu-convert`` (and the port's
``cli/convert.py``) writes it to one ``.npz`` with '/'-joined keys. The port
reads the same files and keeps the same tree and layouts (Linear ``w (in,
out)``, conv ``(k, in/groups, out)``), as torch tensors on a chosen device and
dtype.

A checkpoint directory of a trainer reads as that tree too
(``load_trained_checkpoint``): the port's ``torch.save`` steps, or the JAX
``Trainer``'s orbax steps through ``tensorstore`` (no JAX).

Torch checkpoints (F5-TTS / IndicF5 and E2-TTS ``.pt``/``.ckpt``/
``.safetensors``, the MMDiT layout, Vocos and BigVGAN generator state dicts)
convert to that numpy tree here, array for array what the JAX converters
give. Linear ``(out, in)`` -> ``(in, out)``; Conv1d ``(out, in/g, k)`` ->
``(k, in/g, out)``; GRN ``(1, 1, d)`` -> ``(d,)``; EMA weights stored as
``ema_model.*`` with ``initted``/``step`` keys; stale mel-filterbank buffers
dropped. The Parler branch's checkpoint converters live beside its model
(``models/parler.py:load_parler_checkpoint``, a ParlerTTS state dict -> the
three numpy trees); its trees cross through ``parler_params_from_numpy``, the
AR mel decoder's through ``ar_params_from_numpy``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from f5tts_tpu_torch.models.ar import ARConfig
from f5tts_tpu_torch.models.bigvgan import BigVGANConfig
from f5tts_tpu_torch.models.dit import DiTConfig
from f5tts_tpu_torch.models.mmdit import MMDiTConfig
from f5tts_tpu_torch.models.parler import DacConfig, ParlerDecoderConfig, T5Config
from f5tts_tpu_torch.models.unett import UNetTConfig
from f5tts_tpu_torch.models.vocos import VocosConfig

TORCH_SUFFIXES = (".pt", ".pth", ".bin", ".ckpt", ".safetensors")


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


def load_trained_checkpoint(directory: str, use_ema: bool = True, step: int | None = None) -> dict:
    """The EMA params (what is served; the raw params with ``use_ema=False``)
    of step ``step`` (the newest by default) of a checkpoint directory of
    either trainer, as a numpy tree that ``TTSEngine`` takes as it is (bf16
    leaves widened to fp32). A step directory holding ``default/`` is the JAX
    ``Trainer``'s orbax state (``_read_orbax``); otherwise it is the port's
    ``torch.save`` state. Both name their steps by number."""
    import os

    from f5tts_tpu_torch.train.checkpoint import latest_step, restore_state
    from f5tts_tpu_torch.train.tree import tree_map

    step = latest_step(directory) if step is None else step
    if step is None or not os.path.isdir(os.path.join(directory, str(step))):
        raise FileNotFoundError(f"no checkpoint step {'' if step is None else f'{step} '}under {directory!r}")
    which = "ema" if use_ema else "params"
    orbax_dir = os.path.join(directory, str(step), "default")
    if os.path.isdir(orbax_dir):
        return _read_orbax(orbax_dir, which)
    return tree_map(lambda t: t.float().numpy(), restore_state(directory, step)[which])


def _read_orbax(root: str, which: str) -> dict:
    """Subtree ``which`` of the orbax ``StandardSave`` state under ``root``
    (``<step>/default``), read with ``tensorstore`` alone (orbax imports
    JAX): leaf names from ``_METADATA``'s ``tree_metadata`` (the keys joined
    with '.'), each leaf a zarr array in the OCDBT store at ``root``. The
    one-process layout; a multi-host write (``ocdbt.process_N`` per process)
    is untested."""
    import json
    import os

    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError("reading a JAX Trainer's orbax checkpoint needs the tensorstore package") from e

    with open(os.path.join(root, "_METADATA"), encoding="utf-8") as f:
        entries = json.load(f)["tree_metadata"].values()
    tree: dict = {}
    for entry in entries:
        keys = [k["key"] for k in entry["key_metadata"]]
        if keys[0] != which:
            continue
        node = tree
        for k in keys[1:-1]:
            node = node.setdefault(k, {})
        if entry["value_metadata"]["value_type"] == "None":
            node[keys[-1]] = None
            continue
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/", "path": ".".join(keys) + "/"}}
        leaf = ts.open(spec).result().read().result()
        node[keys[-1]] = leaf.astype(np.float32) if leaf.dtype.name in ("bfloat16", "float16") else leaf
    if not tree:
        raise KeyError(f"no {which!r} subtree in the orbax checkpoint at {root!r}")
    return tree


def export_trained_params(directory: str, path: str) -> None:
    """A trained checkpoint's EMA params as the JAX package's ``.npz`` (what
    ``f5tpu-convert`` writes and both ``load_params_npz`` read)."""
    save_params_npz(path, load_trained_checkpoint(directory))


# ---------------------------------------------------------------------------
# torch checkpoints -> the numpy params tree
# ---------------------------------------------------------------------------


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A ``.pt``/``.ckpt`` (torch; a trainer's full state is unwrapped to its
    EMA, else its model, state dict) or ``.safetensors`` file as numpy fp32
    arrays (safetensors: as stored)."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "ema_model_state_dict" in ckpt:
        ckpt = ckpt["ema_model_state_dict"]
    elif isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return {k: v.float().numpy() for k, v in ckpt.items() if hasattr(v, "numpy")}


def strip_ema(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``ema_model.*`` -> bare keys; drop the EMA bookkeeping and stale mel buffers."""
    if any(k.startswith("ema_model.") for k in sd):
        sd = {k.replace("ema_model.", ""): v for k, v in sd.items() if k not in ("initted", "step")}
    for key in list(sd):
        if key.startswith("mel_spec.") or key in ("initted", "step"):
            sd.pop(key)
    return sd


def _lin(sd, prefix, bias=True):
    p = {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _conv(sd, prefix):
    return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].transpose(2, 1, 0)), "b": sd[f"{prefix}.bias"]}


def _stack(trees: list):
    """Per-layer trees -> one tree whose leaves stack on a leading depth axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _fp32(tree):
    """Every leaf as a numpy fp32 array (the JAX converters' ``jnp.float32``)."""
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fp32(v) for v in tree]
    return None if tree is None else np.asarray(tree, dtype=np.float32)


def _convnext_block_from(sd, prefix):
    return {
        "dwconv": _conv(sd, f"{prefix}.dwconv"),
        "norm_w": sd[f"{prefix}.norm.weight"],
        "norm_b": sd[f"{prefix}.norm.bias"],
        "pw1": _lin(sd, f"{prefix}.pwconv1"),
        "grn_gamma": sd[f"{prefix}.grn.gamma"].reshape(-1),
        "grn_beta": sd[f"{prefix}.grn.beta"].reshape(-1),
        "pw2": _lin(sd, f"{prefix}.pwconv2"),
    }


def _text_and_input_embed(sd, t: str, conv_layers: int) -> dict:
    """The text and input embeddings, laid out alike in the F5 and E2 checkpoints."""
    return {
        "time_embed": {"mlp1": _lin(sd, f"{t}.time_embed.time_mlp.0"), "mlp2": _lin(sd, f"{t}.time_embed.time_mlp.2")},
        "text_embed": {
            "embed": {"w": sd[f"{t}.text_embed.text_embed.weight"]},
            "blocks": _stack([_convnext_block_from(sd, f"{t}.text_embed.text_blocks.{i}") for i in range(conv_layers)])
            if conv_layers > 0 else None,
        },
        "input_embed": {
            "proj": _lin(sd, f"{t}.input_embed.proj"),
            "conv_pos": {"conv1": _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.0"),
                         "conv2": _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.2")},
        },
    }


def convert_f5_dit(sd: dict[str, np.ndarray], cfg: DiTConfig) -> dict:
    """F5-TTS CFM state dict (keys ``transformer.*``, bare or ``ema_model.*``)
    -> the DiT params tree."""
    sd = strip_ema(dict(sd))
    t = "transformer"

    def blk(i):
        b = f"{t}.transformer_blocks.{i}"
        return {
            "attn_norm": {"linear": _lin(sd, f"{b}.attn_norm.linear")},
            "attn": {"to_q": _lin(sd, f"{b}.attn.to_q"), "to_k": _lin(sd, f"{b}.attn.to_k"),
                     "to_v": _lin(sd, f"{b}.attn.to_v"), "to_out": _lin(sd, f"{b}.attn.to_out.0")},
            "ff": {"in": _lin(sd, f"{b}.ff.ff.0.0"), "out": _lin(sd, f"{b}.ff.ff.2")},
        }

    params = {
        **_text_and_input_embed(sd, t, cfg.conv_layers),
        "blocks": _stack([blk(i) for i in range(cfg.depth)]),
        "norm_out": {"linear": _lin(sd, f"{t}.norm_out.linear")},
        "proj_out": _lin(sd, f"{t}.proj_out"),
    }
    if cfg.long_skip_connection:
        params["long_skip"] = _lin(sd, f"{t}.long_skip_connection", bias=False)
    return _fp32(params)


def convert_e2_unett(sd: dict[str, np.ndarray], cfg: UNetTConfig) -> dict:
    """E2-TTS (UNetT) state dict -> the UNetT params tree. Blocks are
    ``transformer.layers.{i}.{0..4}`` = [skip_proj or absent, RMSNorm g,
    attention, RMSNorm g, feed-forward]; ``skip_proj`` only in the second
    half, and only for ``skip_connect_type == "concat"``."""
    sd = strip_ema(dict(sd))
    t = "transformer"
    half = cfg.depth // 2

    def half_block(i: int, with_skip: bool):
        lay = f"{t}.layers.{i}"
        p = {
            "attn_norm": {"g": sd[f"{lay}.1.g"]},
            "attn": {"to_q": _lin(sd, f"{lay}.2.to_q"), "to_k": _lin(sd, f"{lay}.2.to_k"),
                     "to_v": _lin(sd, f"{lay}.2.to_v"), "to_out": _lin(sd, f"{lay}.2.to_out.0")},
            "ff_norm": {"g": sd[f"{lay}.3.g"]},
            "ff": {"in": _lin(sd, f"{lay}.4.ff.0.0"), "out": _lin(sd, f"{lay}.4.ff.2")},
        }
        if with_skip:
            p["skip_proj"] = _lin(sd, f"{lay}.0", bias=False)
        return p

    needs_skip = cfg.skip_connect_type == "concat"
    return _fp32({
        **_text_and_input_embed(sd, t, cfg.conv_layers),
        "first_half": _stack([half_block(i, False) for i in range(half)]),
        "second_half": _stack([half_block(half + i, needs_skip) for i in range(half)]),
        "norm_out": {"g": sd[f"{t}.norm_out.g"]},
        "proj_out": _lin(sd, f"{t}.proj_out"),
    })


def convert_mmdit(sd: dict[str, np.ndarray], cfg: MMDiTConfig) -> dict:
    """MMDiT state dict -> the MMDiT params tree:
    ``transformer_blocks.{i}.{attn_norm_c,attn_norm_x}.linear``, joint attention
    ``attn.{to_q,to_k,to_v,to_q_c,to_k_c,to_v_c,to_out.0,to_out_c}``, the two
    feed-forwards ``ff_{c,x}.ff.{0.0,2}``; the last block is
    ``context_pre_only`` (no ``ff_c`` or ``to_out_c``)."""
    sd = strip_ema(dict(sd))
    t = "transformer"

    def blk(i: int, pre_only: bool):
        base = f"{t}.transformer_blocks.{i}"
        attn = {name: _lin(sd, f"{base}.attn.{name}") for name in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c")}
        attn["to_out"] = _lin(sd, f"{base}.attn.to_out.0")
        p = {
            "attn_norm_c": {"linear": _lin(sd, f"{base}.attn_norm_c.linear")},
            "attn_norm_x": {"linear": _lin(sd, f"{base}.attn_norm_x.linear")},
            "attn": attn,
            "ff_x": {"in": _lin(sd, f"{base}.ff_x.ff.0.0"), "out": _lin(sd, f"{base}.ff_x.ff.2")},
        }
        if not pre_only:
            attn["to_out_c"] = _lin(sd, f"{base}.attn.to_out_c")
            p["ff_c"] = {"in": _lin(sd, f"{base}.ff_c.ff.0.0"), "out": _lin(sd, f"{base}.ff_c.ff.2")}
        return p

    return _fp32({
        "time_embed": {"mlp1": _lin(sd, f"{t}.time_embed.time_mlp.0"), "mlp2": _lin(sd, f"{t}.time_embed.time_mlp.2")},
        "text_embed": {"w": sd[f"{t}.text_embed.text_embed.weight"]},
        "audio_embed": {
            "proj": _lin(sd, f"{t}.audio_embed.linear"),
            "conv_pos": {"conv1": _conv(sd, f"{t}.audio_embed.conv_pos_embed.conv1d.0"),
                         "conv2": _conv(sd, f"{t}.audio_embed.conv_pos_embed.conv1d.2")},
        },
        "blocks": _stack([blk(i, False) for i in range(cfg.depth - 1)]),
        "final_block": blk(cfg.depth - 1, True),
        "norm_out": {"linear": _lin(sd, f"{t}.norm_out.linear")},
        "proj_out": _lin(sd, f"{t}.proj_out"),
    })


def convert_vocos(sd: dict[str, np.ndarray], cfg: VocosConfig = VocosConfig()) -> dict:
    """``charactr/vocos-mel-24khz`` state dict -> the Vocos params tree."""
    return _fp32({
        "embed": _conv(sd, "backbone.embed"),
        "norm_w": sd["backbone.norm.weight"],
        "norm_b": sd["backbone.norm.bias"],
        "blocks": _stack([{
            "dwconv": _conv(sd, f"backbone.convnext.{i}.dwconv"),
            "norm_w": sd[f"backbone.convnext.{i}.norm.weight"],
            "norm_b": sd[f"backbone.convnext.{i}.norm.bias"],
            "pw1": _lin(sd, f"backbone.convnext.{i}.pwconv1"),
            "pw2": _lin(sd, f"backbone.convnext.{i}.pwconv2"),
            "gamma": sd[f"backbone.convnext.{i}.gamma"].reshape(-1),
        } for i in range(cfg.num_layers)]),
        "final_norm_w": sd["backbone.final_layer_norm.weight"],
        "final_norm_b": sd["backbone.final_layer_norm.bias"],
        "head": _lin(sd, "head.out"),
    })


def convert_bigvgan(sd: dict, cfg: BigVGANConfig = BigVGANConfig()) -> dict:
    """BigVGAN generator state dict (weight norm removed) -> the JAX package's
    BigVGAN params tree: ``conv_pre``, ``ups.{i}.0`` (ConvTranspose1d ``(in, out,
    k)`` -> ``(k, in, out)`` flipped along time, the JAX layout),
    ``resblocks.{i*3+j}.convs{1,2}.{d}`` with their ``activations.*.act.{alpha,
    beta}``, ``conv_post``, ``activation_post.act.{alpha,beta}``."""
    def conv(prefix):
        return {"w": np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight"]).transpose(2, 1, 0)),
                "b": sd[f"{prefix}.bias"]}

    def conv_t(prefix):
        w = np.asarray(sd[f"{prefix}.weight"]).transpose(2, 0, 1)[::-1]
        return {"w": np.ascontiguousarray(w), "b": sd[f"{prefix}.bias"]}

    def vec(key):
        return np.asarray(sd[key]).reshape(-1)

    nk = len(cfg.resblock_kernel_sizes)
    resblocks = []
    for i in range(len(cfg.upsample_rates)):
        stage = []
        for j in range(nk):
            r = f"resblocks.{i * nk + j}"
            nd = len(cfg.resblock_dilations[j])
            stage.append({
                "convs1": [conv(f"{r}.convs1.{d}") for d in range(nd)],
                "convs2": [conv(f"{r}.convs2.{d}") for d in range(nd)],
                "alpha1": [vec(f"{r}.activations.{2 * d}.act.alpha") for d in range(nd)],
                "beta1": [vec(f"{r}.activations.{2 * d}.act.beta") for d in range(nd)],
                "alpha2": [vec(f"{r}.activations.{2 * d + 1}.act.alpha") for d in range(nd)],
                "beta2": [vec(f"{r}.activations.{2 * d + 1}.act.beta") for d in range(nd)],
            })
        resblocks.append(stage)
    return _fp32({
        "conv_pre": conv("conv_pre"),
        "ups": [conv_t(f"ups.{i}.0") for i in range(len(cfg.upsample_rates))],
        "resblocks": resblocks,
        "conv_post": conv("conv_post"),
        "alpha_post": vec("activation_post.act.alpha"),
        "beta_post": vec("activation_post.act.beta"),
    })


def _leaf_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def export_f5_state_dict(params, cfg: DiTConfig) -> dict[str, np.ndarray]:
    """Inverse of ``convert_f5_dit``: a DiT params tree (numpy or tensors) in
    the reference's torch key and shape layout (Linear ``(out, in)``, Conv1d
    ``(out, in/g, k)``, GRN ``(1, 1, d)``)."""
    sd: dict[str, np.ndarray] = {}

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(_leaf_np(p["w"]).T)
        if "b" in p:
            sd[f"{prefix}.bias"] = _leaf_np(p["b"])

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(_leaf_np(p["w"]).transpose(2, 1, 0))
        sd[f"{prefix}.bias"] = _leaf_np(p["b"])

    from f5tts_tpu_torch.models.dit import block

    t = "transformer"
    lin(f"{t}.time_embed.time_mlp.0", params["time_embed"]["mlp1"])
    lin(f"{t}.time_embed.time_mlp.2", params["time_embed"]["mlp2"])
    sd[f"{t}.text_embed.text_embed.weight"] = _leaf_np(params["text_embed"]["embed"]["w"])
    for i in range(cfg.conv_layers):
        blk = block(params["text_embed"]["blocks"], i)
        cb = f"{t}.text_embed.text_blocks.{i}"
        conv(f"{cb}.dwconv", blk["dwconv"])
        sd[f"{cb}.norm.weight"] = _leaf_np(blk["norm_w"])
        sd[f"{cb}.norm.bias"] = _leaf_np(blk["norm_b"])
        lin(f"{cb}.pwconv1", blk["pw1"])
        sd[f"{cb}.grn.gamma"] = _leaf_np(blk["grn_gamma"]).reshape(1, 1, -1)
        sd[f"{cb}.grn.beta"] = _leaf_np(blk["grn_beta"]).reshape(1, 1, -1)
        lin(f"{cb}.pwconv2", blk["pw2"])
    lin(f"{t}.input_embed.proj", params["input_embed"]["proj"])
    conv(f"{t}.input_embed.conv_pos_embed.conv1d.0", params["input_embed"]["conv_pos"]["conv1"])
    conv(f"{t}.input_embed.conv_pos_embed.conv1d.2", params["input_embed"]["conv_pos"]["conv2"])
    for i in range(cfg.depth):
        blk = block(params["blocks"], i)
        b = f"{t}.transformer_blocks.{i}"
        lin(f"{b}.attn_norm.linear", blk["attn_norm"]["linear"])
        for nm in ("to_q", "to_k", "to_v"):
            lin(f"{b}.attn.{nm}", blk["attn"][nm])
        lin(f"{b}.attn.to_out.0", blk["attn"]["to_out"])
        lin(f"{b}.ff.ff.0.0", blk["ff"]["in"])
        lin(f"{b}.ff.ff.2", blk["ff"]["out"])
    lin(f"{t}.norm_out.linear", params["norm_out"]["linear"])
    lin(f"{t}.proj_out", params["proj_out"])
    if cfg.long_skip_connection and "long_skip" in params:
        lin(f"{t}.long_skip_connection", params["long_skip"])
    return sd


def export_vocos_state_dict(params, cfg: VocosConfig = VocosConfig()) -> dict[str, np.ndarray]:
    """Inverse of ``convert_vocos``: a Vocos params tree in the
    ``charactr/vocos-mel-24khz`` key and shape layout."""
    from f5tts_tpu_torch.models.dit import block

    sd: dict[str, np.ndarray] = {}

    def put(prefix, p, conv=False):
        w = _leaf_np(p["w"])
        sd[f"{prefix}.weight"] = np.ascontiguousarray(w.transpose(2, 1, 0) if conv else w.T)
        sd[f"{prefix}.bias"] = _leaf_np(p["b"])

    put("backbone.embed", params["embed"], conv=True)
    sd["backbone.norm.weight"], sd["backbone.norm.bias"] = _leaf_np(params["norm_w"]), _leaf_np(params["norm_b"])
    for i in range(cfg.num_layers):
        blk = block(params["blocks"], i)
        c = f"backbone.convnext.{i}"
        put(f"{c}.dwconv", blk["dwconv"], conv=True)
        sd[f"{c}.norm.weight"], sd[f"{c}.norm.bias"] = _leaf_np(blk["norm_w"]), _leaf_np(blk["norm_b"])
        put(f"{c}.pwconv1", blk["pw1"])
        put(f"{c}.pwconv2", blk["pw2"])
        sd[f"{c}.gamma"] = _leaf_np(blk["gamma"])
    sd["backbone.final_layer_norm.weight"] = _leaf_np(params["final_norm_w"])
    sd["backbone.final_layer_norm.bias"] = _leaf_np(params["final_norm_b"])
    put("head.out", params["head"])
    return sd


def save_f5_safetensors(path: str, params, cfg: DiTConfig) -> None:
    """An inference checkpoint the reference reads (it takes bare safetensors
    as EMA weights)."""
    from safetensors.numpy import save_file

    save_file({k: v.astype(np.float32) for k, v in export_f5_state_dict(params, cfg).items()}, path)


def load_f5_checkpoint(path: str, cfg: DiTConfig) -> dict:
    """The DiT params tree of a torch ``.pt``/``.safetensors`` file, an
    ``.npz`` params tree or a checkpoint directory of either trainer (its EMA)."""
    import os

    if os.path.isdir(path):
        return load_trained_checkpoint(path)
    if path.endswith(".npz"):
        return load_params_npz(path)
    return convert_f5_dit(load_torch_state_dict(path), cfg)


def load_e2_checkpoint(path: str, cfg: UNetTConfig) -> dict:
    """The UNetT params tree of a torch E2-TTS checkpoint, an ``.npz`` params
    tree or a checkpoint directory of either trainer."""
    import os

    if os.path.isdir(path):
        return load_trained_checkpoint(path)
    if path.endswith(".npz"):
        return load_params_npz(path)
    return convert_e2_unett(load_torch_state_dict(path), cfg)


def load_vocos_checkpoint(path: str, cfg: VocosConfig = VocosConfig()) -> dict:
    if path.endswith(".npz"):
        return load_params_npz(path)
    return convert_vocos(load_torch_state_dict(path), cfg)


def load_bigvgan_checkpoint(path: str, cfg: BigVGANConfig = BigVGANConfig()) -> dict:
    """The BigVGAN params tree (JAX layout) of a generator state dict or an ``.npz``."""
    if path.endswith(".npz"):
        return load_params_npz(path)
    return convert_bigvgan(load_torch_state_dict(path), cfg)


# ---------------------------------------------------------------------------
# numpy tree -> torch tensors
# ---------------------------------------------------------------------------


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


def unett_params_from_numpy(tree: dict, device, dtype: torch.dtype | None = None) -> dict:
    """The JAX UNetT params tree (numpy, stacked halves) as the port's tensors."""
    _require(tree, ("time_embed", "text_embed", "input_embed", "first_half", "second_half", "norm_out", "proj_out"),
             "UNetT")
    return params_from_numpy(tree, device, dtype)


def mmdit_params_from_numpy(tree: dict, device, dtype: torch.dtype | None = None) -> dict:
    """The JAX MMDiT params tree (numpy, stacked blocks) as the port's tensors."""
    _require(tree, ("time_embed", "text_embed", "audio_embed", "blocks", "final_block", "norm_out", "proj_out"),
             "MMDiT")
    return params_from_numpy(tree, device, dtype)


def backbone_params_from_numpy(tree: dict, device, dtype: torch.dtype | None = None) -> dict:
    """A DiT or UNetT params tree as tensors, told apart by their keys."""
    if "first_half" in tree:
        return unett_params_from_numpy(tree, device, dtype)
    return dit_params_from_numpy(tree, device, dtype)


def bigvgan_params_from_numpy(tree: dict, device, dtype: torch.dtype | None = None) -> dict:
    """The JAX BigVGAN params tree (``convert_bigvgan`` or ``init_bigvgan_numpy``)
    as the port's tensors, laid out for ``F.conv1d`` / ``F.conv_transpose1d``
    once: conv kernels ``(k, in, out)`` -> ``(out, in, k)``; the upsampling
    kernels, stored ``(k, in, out)`` and flipped along time for
    ``lax.conv_transpose``, unflipped to ``(in, out, k)``."""
    _require(tree, ("conv_pre", "ups", "resblocks", "conv_post", "alpha_post", "beta_post"), "BigVGAN")

    def conv(p):
        return {"w": np.ascontiguousarray(np.asarray(p["w"]).transpose(2, 1, 0)), "b": p["b"]}

    def conv_t(p):
        return {"w": np.ascontiguousarray(np.asarray(p["w"])[::-1].transpose(1, 2, 0)), "b": p["b"]}

    laid_out = {
        "conv_pre": conv(tree["conv_pre"]),
        "ups": [conv_t(p) for p in tree["ups"]],
        "resblocks": [[{**rb, "convs1": [conv(p) for p in rb["convs1"]], "convs2": [conv(p) for p in rb["convs2"]]}
                       for rb in stage] for stage in tree["resblocks"]],
        "conv_post": conv(tree["conv_post"]),
        "alpha_post": tree["alpha_post"],
        "beta_post": tree["beta_post"],
    }
    return params_from_numpy(laid_out, device, dtype)


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


def ar_params_from_numpy(tree: dict, device, dtype: torch.dtype | None = None) -> dict:
    """The JAX AR mel-decoder params tree (numpy, stacked blocks; ``init_ar``
    or ``init_ar_numpy``) as the port's tensors."""
    _require(tree, ("text_embed", "mel_in", "bos", "blocks", "norm_out", "mel_out", "stop_out"), "AR decoder")
    return params_from_numpy(tree, device, dtype)


# ---------------------------------------------------------------------------
# seeded random init (torch's default Linear/Conv1d init, in numpy)
# ---------------------------------------------------------------------------


class _NoDraws:
    """Stands in for the generator of ``_Init(None)``: read-only zero-stride
    zeros of the asked shape, so nothing is drawn or materialized."""

    @staticmethod
    def random(shape, dtype=np.float32) -> np.ndarray:
        return np.broadcast_to(np.zeros((), dtype), shape)

    standard_normal = random


class _Init:
    """The JAX initializers' distributions drawn from ``seed``; ``seed=None``
    draws nothing and gives zero-stride arrays of the same shapes (a tree
    whose parameters are counted, ``models/dit.py:param_count``)."""

    def __init__(self, seed: int | None):
        self.rng = np.random.default_rng(seed) if seed is not None else _NoDraws()

    def uniform(self, shape, bound: float) -> np.ndarray:
        if isinstance(self.rng, _NoDraws):
            return self.rng.random(shape)
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


def init_dit_numpy(cfg: DiTConfig, seed: int | None = 0) -> dict:
    """Random DiT params tree (numpy fp32) at any ``DiTConfig`` width, with the
    JAX ``init_dit`` tree, shapes and init distributions (``seed=None``: the
    shapes only, see ``_Init``)."""
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


def init_vocos_numpy(cfg: VocosConfig = VocosConfig(), seed: int | None = 1) -> dict:
    """Random Vocos params tree (numpy fp32) with the JAX ``init_vocos`` tree
    (``seed=None``: the shapes only, see ``_Init``)."""
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


def _init_ff(init: _Init, dim: int, mult: int, depth: int | None = None) -> dict:
    return {"in": init.linear(dim, dim * mult, depth=depth), "out": init.linear(dim * mult, dim, depth=depth)}


def init_ar_numpy(cfg: ARConfig = ARConfig(), seed: int = 0) -> dict:
    """Random AR mel-decoder params tree (numpy fp32) with the JAX ``init_ar``
    tree, shapes and init distributions (blocks stacked on a depth axis, RMS
    gains at 1, ``bos`` ~ N(0, 0.02^2))."""
    init = _Init(seed)
    d, inner = cfg.depth, cfg.inner
    return {
        "text_embed": {"w": init.rng.standard_normal((cfg.text_num_embeds + 1, cfg.dim), dtype=np.float32)},
        "mel_in": init.linear(cfg.mel_dim, cfg.dim),
        "bos": init.rng.standard_normal((cfg.dim,), dtype=np.float32) * np.float32(0.02),
        "blocks": {
            "attn_norm": {"g": np.ones((d, cfg.dim), np.float32)},
            "attn": {"to_q": init.linear(cfg.dim, inner, depth=d), "to_k": init.linear(cfg.dim, inner, depth=d),
                     "to_v": init.linear(cfg.dim, inner, depth=d), "to_out": init.linear(inner, cfg.dim, depth=d)},
            "ff_norm": {"g": np.ones((d, cfg.dim), np.float32)},
            "ff": _init_ff(init, cfg.dim, cfg.ff_mult, d),
        },
        "norm_out": {"g": np.ones((cfg.dim,), np.float32)},
        "mel_out": init.linear(cfg.dim, cfg.mel_dim),
        "stop_out": init.linear(cfg.dim, 1),
    }


def init_unett_numpy(cfg: UNetTConfig, seed: int | None = 0) -> dict:
    """Random UNetT params tree (numpy fp32) with the JAX ``init_unett`` tree
    and shapes (RMSNorm gains at 1; ``seed=None``: the shapes only, see
    ``_Init``)."""
    init = _Init(seed)
    inner = cfg.heads * cfg.dim_head
    half = cfg.depth // 2

    def half_blocks(with_skip: bool) -> dict:
        p = {
            "attn_norm": {"g": np.ones((half, cfg.dim), np.float32)},
            "attn": {"to_q": init.linear(cfg.dim, inner, depth=half), "to_k": init.linear(cfg.dim, inner, depth=half),
                     "to_v": init.linear(cfg.dim, inner, depth=half), "to_out": init.linear(inner, cfg.dim, depth=half)},
            "ff_norm": {"g": np.ones((half, cfg.dim), np.float32)},
            "ff": _init_ff(init, cfg.dim, cfg.ff_mult, half),
        }
        if with_skip:
            p["skip_proj"] = init.linear(cfg.dim * 2, cfg.dim, bias=False, depth=half)
        return p

    return {
        "time_embed": {"mlp1": init.linear(256, cfg.dim), "mlp2": init.linear(cfg.dim, cfg.dim)},
        "text_embed": {
            "embed": {"w": init.rng.standard_normal((cfg.text_num_embeds + 1, cfg.text_dim), dtype=np.float32)},
            "blocks": _convnext_v2(init, cfg.text_dim, cfg.text_dim * 2, cfg.conv_layers) if cfg.conv_layers > 0 else None,
        },
        "input_embed": {
            "proj": init.linear(cfg.mel_dim * 2 + cfg.text_dim, cfg.dim),
            "conv_pos": {"conv1": init.conv1d(cfg.dim, cfg.dim, 31, 16), "conv2": init.conv1d(cfg.dim, cfg.dim, 31, 16)},
        },
        "first_half": half_blocks(False),
        "second_half": half_blocks(cfg.skip_connect_type == "concat"),
        "norm_out": {"g": np.ones((cfg.dim,), np.float32)},
        "proj_out": init.linear(cfg.dim, cfg.mel_dim),
    }


def init_mmdit_numpy(cfg: MMDiTConfig, seed: int = 0) -> dict:
    """Random MMDiT params tree (numpy fp32) with the JAX ``init_mmdit`` tree and shapes."""
    init = _Init(seed)
    inner = cfg.heads * cfg.dim_head

    def blk(pre_only: bool, depth: int | None = None) -> dict:
        attn = {name: init.linear(cfg.dim, inner, depth=depth) for name in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c",
                                                                             "to_v_c")}
        attn["to_out"] = init.linear(inner, cfg.dim, depth=depth)
        p = {
            "attn_norm_c": {"linear": init.linear(cfg.dim, cfg.dim * (2 if pre_only else 6), depth=depth)},
            "attn_norm_x": {"linear": init.linear(cfg.dim, cfg.dim * 6, depth=depth)},
            "attn": attn,
            "ff_x": _init_ff(init, cfg.dim, cfg.ff_mult, depth),
        }
        if not pre_only:
            attn["to_out_c"] = init.linear(inner, cfg.dim, depth=depth)
            p["ff_c"] = _init_ff(init, cfg.dim, cfg.ff_mult, depth)
        return p

    return {
        "time_embed": {"mlp1": init.linear(256, cfg.dim), "mlp2": init.linear(cfg.dim, cfg.dim)},
        "text_embed": {"w": init.rng.standard_normal((cfg.text_num_embeds + 1, cfg.dim), dtype=np.float32)},
        "audio_embed": {
            "proj": init.linear(cfg.mel_dim * 2, cfg.dim),
            "conv_pos": {"conv1": init.conv1d(cfg.dim, cfg.dim, 31, 16), "conv2": init.conv1d(cfg.dim, cfg.dim, 31, 16)},
        },
        "blocks": blk(False, cfg.depth - 1),
        "final_block": blk(True),
        "norm_out": {"linear": init.linear(cfg.dim, cfg.dim * 2)},
        "proj_out": init.linear(cfg.dim, cfg.mel_dim),
    }


def init_bigvgan_numpy(cfg: BigVGANConfig = BigVGANConfig(), seed: int = 1) -> dict:
    """Random BigVGAN params tree (numpy fp32) with the JAX ``init_bigvgan``
    tree and layouts (upsampling kernels ``(k, in, out)``), snake alpha and beta
    at 0 (log scale)."""
    init = _Init(seed)
    ch = cfg.upsample_initial_channel
    ups, resblocks = [], []
    for r, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        ch_out = ch // 2
        ups.append(init.conv1d(ch, ch_out, k))
        resblocks.append([{
            "convs1": [init.conv1d(ch_out, ch_out, rk) for _ in dils],
            "convs2": [init.conv1d(ch_out, ch_out, rk) for _ in dils],
            **{name: [np.zeros((ch_out,), np.float32) for _ in dils] for name in ("alpha1", "beta1", "alpha2", "beta2")},
        } for rk, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)])
        ch = ch_out
    return {
        "conv_pre": init.conv1d(cfg.mel_dim, cfg.upsample_initial_channel, 7),
        "ups": ups,
        "resblocks": resblocks,
        "alpha_post": np.zeros((ch,), np.float32),
        "beta_post": np.zeros((ch,), np.float32),
        "conv_post": init.conv1d(ch, 1, 7),
    }
