"""Partition rules: backbone parameter trees -> per-leaf specs on ``('data',
'model')`` (counterpart of ``f5tts_tpu/parallel/sharding.py``).

Megatron tensor parallelism of the transformer blocks: q/k/v and the
feed-forward's ``in`` are column-parallel (the output axis sharded over
``model``, their biases with it), the attention's ``to_out`` and the
feed-forward's ``out`` row-parallel (the input axis sharded; their biases
replicated and added once, after the sum). Everything else is replicated.
Stacked block params carry a leading depth axis, so their specs start with
``None``. A spec is a tuple of ``None`` / ``"model"``, one per leading axis
it names, the same tuples as the JAX package's ``PartitionSpec``s (``()`` is
replicated). The rules key on the module names, as the JAX ones do: the
MMDiT's ``to_out_c`` falls under the column rule and its ``ff_x``/``ff_c``
stay replicated.
"""

from __future__ import annotations

import torch

from f5tts_tpu_torch.parallel.mesh import Mesh


def _spec_for(keys: list[str], ndim: int) -> tuple:
    stacked = any(k in keys for k in ("blocks", "first_half", "second_half")) and "text_embed" not in keys

    def with_depth(*s):
        return (None, *s) if stacked else s

    matrix = ndim - stacked == 2
    if "attn" in keys:
        if "to_out" in keys:  # row-parallel: w (inner, dim) sharded on inner, bias replicated
            return with_depth("model", None) if matrix else with_depth(None)
        return with_depth(None, "model") if matrix else with_depth("model")  # column-parallel
    if "ff" in keys:
        if "in" in keys:
            return with_depth(None, "model") if matrix else with_depth("model")
        return with_depth("model", None) if matrix else with_depth(None)
    return ()


def dit_param_specs(params, _keys: tuple[str, ...] = ()):
    """Spec tree matching a backbone's tree (the DiT's ``blocks``, the UNetT's
    ``first_half``/``second_half``, the MMDiT's); None leaves stay None."""
    if isinstance(params, dict):
        return {k: dit_param_specs(v, (*_keys, k)) for k, v in params.items()}
    if params is None:
        return None
    return _spec_for(list(_keys), params.ndim)


def vocos_param_specs(params):
    """Vocos (and BigVGAN) are small: everything replicated."""
    if isinstance(params, dict):
        return {k: vocos_param_specs(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [vocos_param_specs(v) for v in params]
    return None if params is None else ()


def sharded_axis(spec) -> int | None:
    """The axis a spec shards over ``model``, or None (replicated)."""
    return spec.index("model") if spec and "model" in spec else None


def map_with_specs(fn, tree, specs):
    """``fn(tensor, spec)`` over the tensor leaves; other leaves (None, a
    step count) pass through."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs) if isinstance(tree, torch.Tensor) else tree


def shard_tensor(t: torch.Tensor, spec, size: int, index: int) -> torch.Tensor:
    """This rank's block of ``t`` along its spec's sharded axis (a fresh
    contiguous tensor that keeps ``requires_grad``), or ``t`` itself."""
    axis = sharded_axis(spec)
    if axis is None or size == 1:
        return t
    if t.shape[axis] % size:
        raise ValueError(f"axis {axis} of a {tuple(t.shape)} leaf does not divide over {size} model ranks")
    step = t.shape[axis] // size
    return t.detach().narrow(axis, index * step, step).clone().requires_grad_(t.requires_grad)


def shard_params(params, mesh: Mesh, specs=None):
    """This rank's local slices of a params tree: every leaf a spec shards
    over ``model`` is cut to this rank's block, the rest are kept as they
    are (replicated)."""
    specs = specs if specs is not None else dit_param_specs(params)
    axis = mesh["model"]
    return map_with_specs(lambda t, s: shard_tensor(t, s, axis.size, axis.index), params, specs)


def unshard_params(params, mesh: Mesh, specs=None):
    """The whole tree on every rank, from the model group's local slices
    (collective: every rank of the group calls it). For checkpoints and
    tests."""
    specs = specs if specs is not None else dit_param_specs(params)
    axis = mesh["model"]

    def gather(t, s):
        dim = sharded_axis(s)
        return t if dim is None else axis.all_gather(t.detach(), dim)

    return map_with_specs(gather, params, specs)
