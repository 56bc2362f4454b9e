"""Seeded random weights, made on the device in a few large draws.

A layout is a nested dict whose leaves are ``(shape, init)``: ``("u", b)``
uniform on ``[-b, b]`` (PyTorch's Linear and Conv1d default, ``b =
1/sqrt(fan_in)``), ``("n",)`` standard normal (an Embedding), ``("c", v)`` the
constant ``v`` (norm gains and biases, layer scales). All uniform leaves come
from one ``torch.rand`` and all normal ones from one ``torch.randn`` on the
card's generator, so the same seed gives the same tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def linear(d_in, d_out, bias=True, depth=None):
    lead = () if depth is None else (depth,)
    b = 1.0 / math.sqrt(d_in)
    p = {"w": ((*lead, d_in, d_out), ("u", b))}
    if bias:
        p["b"] = ((*lead, d_out), ("u", b))
    return p


def conv1d(d_in, d_out, width, groups=1, depth=None):
    lead = () if depth is None else (depth,)
    b = 1.0 / math.sqrt(d_in // groups * width)
    return {"w": ((*lead, width, d_in // groups, d_out), ("u", b)), "b": ((*lead, d_out), ("u", b))}


def const(shape, value):
    return (tuple(shape), ("c", float(value)))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def seed_of(seed: int, salt: str) -> int:
    """A 63-bit seed for one use of the run's seed (weights, noise, traffic)."""
    return int(np.random.default_rng([abs(int(seed)), int(int(seed) < 0), *salt.encode()]).integers(2**63))


def make(layout: dict, seed: int, device, round_to: torch.dtype | None = None) -> dict:
    """The layout's tensors, fp32 on ``device``; ``round_to`` rounds every
    leaf to that type first (the type the weights are served in)."""
    leaves = list(_leaves(layout))
    sizes = {kind: sum(math.prod(s) for _, (s, init) in leaves if init[0] == kind) for kind in ("u", "n")}
    gen = torch.Generator(device=device).manual_seed(seed)
    pools = {"u": torch.rand(sizes["u"], generator=gen, device=device).mul_(2).sub_(1),
             "n": torch.randn(sizes["n"], generator=gen, device=device)}
    offsets = {"u": 0, "n": 0}
    out: dict = {}
    for path, (shape, init) in leaves:
        size = math.prod(shape)
        if init[0] == "c":
            t = torch.full(shape, init[1], device=device)
        else:
            o = offsets[init[0]]
            t = pools[init[0]][o : o + size].view(shape)
            offsets[init[0]] = o + size
            if init[0] == "u":
                t = t * init[1]
        if round_to is not None:
            t = t.to(round_to).float()
        _put(out, path, t)
    return out


def to_numpy(tree: dict) -> dict:
    """One copy of the whole tree to the host, as numpy views of one buffer
    (what the program's loaders take)."""
    leaves = list(_leaves(tree))
    flat = torch.cat([t.reshape(-1) for _, t in leaves]).cpu().numpy()
    out: dict = {}
    o = 0
    for path, t in leaves:
        _put(out, path, flat[o : o + t.numel()].reshape(tuple(t.shape)))
        o += t.numel()
    return out
