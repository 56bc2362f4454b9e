"""Device mesh over ``torch.distributed`` (counterpart of
``f5tts_tpu/parallel/mesh.py``).

The JAX package builds one 2-D ``jax.sharding.Mesh`` with axes ``('data',
'model')`` and lets XLA insert the collectives from the shardings. The port
runs one process per device and calls the collectives by hand, so a
``Mesh`` is one rank's view of the grid: its device, and for each axis an
``Axis`` holding the process group of the ranks that differ from this one only
along that axis. ``model`` is the minor axis (ranks ``r`` and ``r + 1`` share
a model group), as in the JAX package's default device order. ``data_sharding``
and ``replicated`` have no tensor counterpart here: they are the mesh's
groups.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from f5tts_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: ``size`` ranks, this rank at
    ``index``, the global ``ranks`` of its group in axis order. ``group`` is
    the process group, or None for an axis of size 1 (its collectives are
    no-ops: None would mean the whole world to ``torch.distributed``)."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: object = None

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` over the axis in place, a sum unless ``op`` says
        otherwise (``dist.ReduceOp.MAX``: gloo and NCCL take it on fp32, and a
        sum on int32); returns ``t``. A failed collective raises."""
        if self.size > 1:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The axis's shards of ``t`` concatenated along ``dim`` in axis order
        (equal shards). Written as a sum of zero-padded shards: one
        ``all_reduce``, which every backend takes for CPU and CUDA tensors
        (gloo's gather does not take CUDA tensors); it is exact, since each
        element has one non-zero term."""
        if self.size == 1:
            return t
        shape = list(t.shape)
        step = shape[dim]
        shape[dim] = step * self.size
        full = torch.zeros(shape, dtype=t.dtype, device=t.device)
        full.narrow(dim, self.index * step, step).copy_(t)
        return self.all_reduce(full)

    def peer(self, offset: int) -> int:
        """The global rank ``offset`` steps along the axis (cyclic)."""
        return self.ranks[(self.index + offset) % self.size]


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a 2-D mesh: its ``device`` and one ``Axis`` per
    mesh axis (major first). ``mesh["data"]``, ``mesh["model"]``."""

    axes: tuple[Axis, ...]
    device: torch.device
    rank: int = 0
    world: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(a.size for a in self.axes)

    def __getitem__(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"mesh has no axis {name!r}; axes {[a.name for a in self.axes]}")


def local_rank() -> int:
    """The process's device index on its host (``LOCAL_RANK``, default 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def mesh_device(device=None) -> torch.device:
    """``cuda:{LOCAL_RANK}`` unless the caller asks for the CPU (raises when
    no GPU is visible, as every entry point does)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return dev


def _axis(name: str, groups: list[list[int]], rank: int, made: dict) -> Axis:
    mine = next(g for g in groups if rank in g)
    return Axis(name, len(mine), mine.index(rank), tuple(mine), made.get(tuple(mine)))


def build_mesh(model_parallel: int = 1, device=None, axis_names: tuple[str, str] = ("data", "model")) -> Mesh:
    """Mesh of shape ``(world // model_parallel, model_parallel)`` over the
    initialised process group (a one-rank mesh when none is initialised).
    Every rank must call it, in the same order as its other group
    creations: ``new_group`` is collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks not divisible by model_parallel={model_parallel}")
    data_parallel = world // model_parallel
    minor = [[d * model_parallel + m for m in range(model_parallel)] for d in range(data_parallel)]
    major = [[d * model_parallel + m for d in range(data_parallel)] for m in range(model_parallel)]
    made = {}
    for ranks in minor + major:  # the same order on every rank
        if len(ranks) > 1:
            made[tuple(ranks)] = dist.new_group(ranks)
    axes = (_axis(axis_names[0], major, rank, made), _axis(axis_names[1], minor, rank, made))
    return Mesh(axes, mesh_device(device), rank, world)
