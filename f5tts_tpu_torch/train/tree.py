"""Parameter trees: nested dicts (and, for the DAC's stages, lists) of tensors
or arrays (None leaves allowed), the JAX package's params layout."""

from __future__ import annotations

import torch


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor leaf, in a fixed (insertion) order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += tree_leaves(v, f"{prefix}/{k}" if prefix else k)
        return out
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in tree_leaves(v, f"{prefix}/{i}" if prefix else str(i))]
    return [] if tree is None else [(prefix, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)
