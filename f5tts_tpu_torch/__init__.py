"""PyTorch / CUDA port of ``f5tts_tpu`` for NVIDIA Hopper (H100).

The JAX package ``f5tts_tpu`` stays the reference; this package mirrors its
module names (``ops/``, ``models/``, ``sampling/``, ``engine/``, ``cli/``) so
each counterpart is easy to find. It imports ``torch`` and never ``jax`` or
``f5tts_tpu``.

- Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
  (``utils.device.resolve_device``); with no GPU they raise instead of
  falling back to the CPU.
- Parameters keep the JAX layouts: Linear ``w`` is ``(in, out)``, conv
  kernels are ``(k, in/groups, out)``, activations are frame-major
  ``(b, n, c)``.
- The TPU's Pallas kernels on the synthesis path are hand-written CUDA C++
  for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and bound with
  ``ctypes`` (``ops/kernels/``). Each wrapper takes its plain PyTorch version
  only for CPU tensors.
"""

__version__ = "0.1.0"
