"""Multi-process launch (counterpart of ``f5tts_tpu/parallel/launcher.py``).

The JAX package runs one process per host, each driving its local devices,
and wires ``jax.distributed`` from ``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID``. The port runs one process per device
(PyTorch's idiom) and reads the same variables, plus ``LOCAL_RANK`` for the
device on the host::

    COORDINATOR_ADDRESS=host0:29500 NUM_PROCESSES=8 PROCESS_ID=$i LOCAL_RANK=$((i % 8)) \\
        python -m f5tts_tpu_torch.cli.train --model-parallel 2 ...

The backend is NCCL on CUDA and gloo when the caller asks for the CPU.
Every rank reads the same global batches (a seed-synchronised order) and
keeps its rows (``local_batch_slice``), so no host coordinates the data.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from f5tts_tpu_torch.parallel.mesh import Mesh, build_mesh, mesh_device


def init_distributed(device=None) -> tuple[int, int]:
    """Initialise the default process group when ``NUM_PROCESSES > 1`` (and
    none is initialised yet) at ``tcp://$COORDINATOR_ADDRESS``; returns
    ``(process_id, n_processes)``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    n_proc = int(os.environ.get("NUM_PROCESSES", "1"))
    pid = int(os.environ.get("PROCESS_ID", "0"))
    if n_proc > 1:
        dev = mesh_device(device)
        coord = os.environ.get("COORDINATOR_ADDRESS")
        if not coord:
            raise RuntimeError("NUM_PROCESSES > 1 needs COORDINATOR_ADDRESS (host:port)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://{coord}",
                                world_size=n_proc, rank=pid)
    return pid, n_proc


def global_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """The ``('data', 'model')`` mesh over every rank of the process group."""
    return build_mesh(model_parallel=model_parallel, device=device)


def local_batch_slice(global_batch: int, mesh: Mesh | None = None) -> slice:
    """The rows of a global batch this rank feeds: its block along the mesh's
    ``data`` axis (the ranks of one model group share their rows). Without a
    mesh, the process's block of the world, as the JAX package's per-host
    slice. Raises when the rows do not divide."""
    if mesh is not None:
        parts, index = mesh["data"].size, mesh["data"].index
    else:
        parts = dist.get_world_size() if dist.is_initialized() else 1
        index = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % parts:
        raise ValueError(f"a batch of {global_batch} rows does not divide over {parts} data-parallel ranks")
    per = global_batch // parts
    return slice(index * per, (index + 1) * per)


def make_global_batch(local_arrays: dict, mesh: Mesh | None = None, device=None) -> dict:
    """This rank's rows of a batch as tensors on its device. The JAX package
    assembles global ``jax.Array``s here; under the port's SPMD each rank
    keeps its own rows, so one process and many take the same path."""
    dev = mesh.device if mesh is not None else mesh_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in local_arrays.items()}
