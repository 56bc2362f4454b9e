"""Multi-device layer over ``torch.distributed`` (counterpart of
``f5tts_tpu/parallel``): the ``(data, model)`` mesh, the Megatron sharding
rules, the launcher and context-parallel ring attention.

The port runs SPMD by hand, one process per device: each rank holds its own
shard and calls the collectives itself (NCCL on the card, gloo on the CPU).
"""

from f5tts_tpu_torch.parallel.mesh import Axis, Mesh, build_mesh  # noqa: F401
from f5tts_tpu_torch.parallel.sharding import dit_param_specs, shard_params, unshard_params  # noqa: F401
