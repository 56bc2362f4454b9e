"""Row norms of the backbones: CUDA kernel for Hopper (``csrc/row_norm.cu``)
and its plain PyTorch version.

Replaces no TPU kernel: XLA fused these chains on the TPU, and eager
PyTorch runs each of their ops as a launch of its own. Each row of ``x (...,
c)`` is normalised in fp32 and rounded once to ``x.dtype``, in the mode the
caller picks by its arguments:

- ``scale``, ``shift`` ``(b, c)``: AdaLN's modulated layer norm of ``x (b, n,
  c)``, ``(x - mean) * rsqrt(var + eps) * (1 + scale[:, None]) + shift[:,
  None]``; the two may be strided views (chunks of the AdaLN projection);
- ``g`` ``(c,)``: the UNetT's RMSNorm, ``x * rsqrt(max(sum(x^2), eps)) *
  sqrt(c) * g``.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
The kernel takes a contiguous, 16-byte aligned bf16 or fp32 ``x`` with ``c %
8 == 0`` up to ``max_width(x.dtype)``; ``g`` in bf16 or fp32, ``scale`` and
``shift`` in ``x.dtype`` (the chain they replace gives the promoted type); each
vector's rows unit-strided and aligned to a 16-byte piece of ``x``, which the
AdaLN projection's chunks and a parameter are.
It has no backward: the model code takes it only where no gradient is
carried (``models/modules.py:modulated_layer_norm``, ``rms_norm``).
"""

from __future__ import annotations

import ctypes

import torch

from f5tts_tpu_torch.ops.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)
MAX_PIECES = 16  # 16-byte pieces a lane holds (csrc/row_norm.cu:MAX_NV)


def max_width(dtype: torch.dtype) -> int:
    """The widest row the kernel takes: 32 lanes of ``MAX_PIECES`` 16-byte pieces."""
    return 32 * MAX_PIECES * 16 // torch.empty((), dtype=dtype).element_size()


def _mode(scale, shift, g) -> str:
    if g is None and scale is not None and shift is not None:
        return "modulated"
    if g is not None and scale is None and shift is None:
        return "rms"
    raise ValueError("row_norm takes scale and shift (modulated layer norm) or g (RMS norm)")


def row_norm_plain(x, *, scale=None, shift=None, g=None, eps: float):
    """Plain version of the kernel: fp32 math, one rounding to ``x.dtype``."""
    x32 = x.float()
    if _mode(scale, shift, g) == "modulated":
        mean = x32.mean(-1, keepdim=True)
        var = torch.square(x32 - mean).mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + eps) * (1 + scale.float()[:, None]) + shift.float()[:, None]
    else:
        y = x32 * torch.rsqrt(torch.clamp_min((x32 * x32).sum(-1, keepdim=True), eps)) * (x.shape[-1] ** 0.5)
        y = y * g.float()
    return y.to(x.dtype)


def check_inputs(x, *, scale=None, shift=None, g=None) -> str:
    """What the kernel takes, checked before any launch; returns the mode."""
    mode = _mode(scale, shift, g)
    vectors = (scale, shift) if mode == "modulated" else (g,)
    for t in vectors:
        if t.device != x.device:
            raise ValueError(f"row_norm: every input must be on {x.device}, got {t.device}")
    if x.dtype not in _DTYPES or not x.is_contiguous() or x.ndim < 1:
        raise ValueError(f"row_norm takes a contiguous bf16/fp32 (..., c) tensor, got {x.dtype} {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    c = x.shape[-1]
    if c % 8 or not 8 <= c <= max_width(x.dtype):
        raise ValueError(f"row_norm takes a width c % 8 == 0 from 8 to {max_width(x.dtype)} in {x.dtype}, got {c}")
    if x.data_ptr() % 16:
        raise ValueError("row_norm: x must be 16-byte aligned")
    if mode == "modulated":
        if x.ndim != 3 or scale.shape != (x.shape[0], c) or shift.shape != (x.shape[0], c):
            raise ValueError(f"row_norm: scale and shift must be ({x.shape[0]}, {c}) for x (b, n, c) "
                             f"{tuple(x.shape)}, got {tuple(scale.shape)} and {tuple(shift.shape)}")
        if scale.dtype != x.dtype or shift.dtype != x.dtype:
            raise ValueError(f"row_norm: scale and shift must be {x.dtype}, got {scale.dtype} and {shift.dtype}")
    elif g.shape != (c,) or g.dtype not in _DTYPES:
        raise ValueError(f"row_norm: g must be a bf16/fp32 ({c},), got {g.dtype} {tuple(g.shape)}")
    piece = 16 // x.element_size()  # elements of a 16-byte piece of x, and of each vector's piece
    for v in vectors:  # read in place: unit column stride, the row stride and the base aligned to a piece
        row_stride = v.stride(0) if v.ndim == 2 else 0
        if v.stride(-1) != 1 or row_stride % piece or v.data_ptr() % (piece * v.element_size()):
            raise ValueError(f"row_norm: each vector's rows must be unit-strided and aligned to {piece} elements, "
                             f"got strides {v.stride()} at offset {v.storage_offset()}")
    return mode


def _lib():
    lib = _build.load("row_norm")
    if not getattr(lib, "_f5_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.f5_row_norm.argtypes = [p, p, p, p, ll, ll, i, i, ctypes.c_float, i, i, i, p]
        lib.f5_row_norm.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


def row_norm(x, *, scale=None, shift=None, g=None, eps: float):
    """Modulated layer norm (``scale``, ``shift``) or RMS norm (``g``) of each
    row of ``x``: the kernel on a CUDA tensor (one launch), the plain version
    on a CPU tensor. A CUDA input that requires grad (with grad enabled)
    raises: there is no backward."""
    if x.device.type == "cpu":
        return row_norm_plain(x, scale=scale, shift=shift, g=g, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"row_norm runs on cuda (kernel) or cpu (plain), got {x.device}")
    mode = check_inputs(x, scale=scale, shift=shift, g=g)
    vectors = (scale, shift) if mode == "modulated" else (g,)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *vectors)):
        raise RuntimeError("row_norm has no backward kernel; take the plain chain (or run under torch.no_grad())")
    c = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    va = vectors[0]
    vb = vectors[1] if mode == "modulated" else None
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.f5_row_norm(x.data_ptr(), y.data_ptr(), va.data_ptr(), vb.data_ptr() if vb is not None else None,
                              va.stride(0) if mode == "modulated" else 0, rows,
                              x.shape[1] if mode == "modulated" else 1, c, float(eps),
                              int(x.dtype == torch.bfloat16), int(va.dtype == torch.bfloat16),
                              int(mode == "modulated"), stream)
    if err != 0:
        raise RuntimeError(f"row_norm kernel launch failed: {lib.f5_error_string(err).decode()}")
    _build.count_launch(row_norm)
    return y


row_norm.launches = 0
