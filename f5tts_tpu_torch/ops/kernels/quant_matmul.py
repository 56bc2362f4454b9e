"""Fused W8A8 matmul: CUDA kernel for Hopper (``csrc/quant_matmul.cu``) and its
plain PyTorch version.

Replaces ``f5tts_tpu/ops/pallas/quant_matmul.py:quant_matmul``: per-row
dynamic int8 quantization of the activations, int8 x int8 -> int32, rescale by
the row and column scales, output in ``x.dtype``. ``x (M, K)`` bf16 or fp32,
``w_q (K, N)`` int8, ``s_w (N,)`` fp32.

Two floors guard the row scale ``sx = max(max(ax, amax_floor) / 127,
scale_floor)``, because the JAX package has two conventions: its Pallas kernel
floors the abs-max at 1e-6 (the defaults here), ``modules._linear_int8`` floors
the scale at 1e-8 (``amax_floor=0, scale_floor=1e-8``). They differ only for
rows whose abs-max is under 1.27e-6.

The kernel reads the weights K-contiguous, ``w_qt (N, K)``: ``kernel_layout``
makes that copy once, when the parameters are quantized; a CUDA call without
it raises instead of transposing per call. Kernel and plain version agree bit
for bit: every step is exact integer arithmetic or one correctly rounded fp32
operation in a fixed order. The kernel's source notes its bound and design;
``PERF.md`` has its times on the card.
"""

from __future__ import annotations

import ctypes

import torch

from f5tts_tpu_torch.ops.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)


def kernel_layout(w_q: torch.Tensor) -> torch.Tensor:
    """``w_q (..., K, N)`` int8 -> the kernel's K-contiguous copy ``(..., N, K)``."""
    return w_q.transpose(-1, -2).contiguous()


def quant_matmul_plain(x, w_q, s_w, *, amax_floor: float = 1e-6, scale_floor: float = 0.0):
    """What the kernel computes, in PyTorch. Divisions are by tensors (a
    division by a Python scalar becomes a multiply by its reciprocal on CUDA),
    and the integer product is taken in float64, which is exact (sums stay
    under 2^53; fp32 would lose bits above 2^24 at K = 2048)."""
    x32 = x.float()
    ax = x32.abs().amax(-1, keepdim=True)
    sx = torch.clamp_min(torch.clamp_min(ax, amax_floor) / torch.full_like(ax, 127.0), scale_floor)
    xq = torch.round(x32 / sx).to(torch.int8)
    acc = (xq.double() @ w_q.double()).float()
    return ((acc * sx) * s_w.float()).to(x.dtype)


def _lib():
    lib = _build.load("quant_matmul")
    if not getattr(lib, "_f5_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.f5_quant_matmul.argtypes = [p, p, p, p, i, i, i, f, f, i, p]
        lib.f5_quant_matmul.restype = i
        lib.f5_quant_matmul_max_k.argtypes = []
        lib.f5_quant_matmul_max_k.restype = i
        lib.f5_quant_matmul_mma_rate.argtypes = [i, i, p, p]
        lib.f5_quant_matmul_mma_rate.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


def _check(lib, x, w_q, s_w, w_qt, amax_floor, scale_floor):
    if x.ndim != 2 or w_q.ndim != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"x must be (M, K) and w_q (K, N), got {tuple(x.shape)} and {tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"quant_matmul takes bf16 or fp32 activations, got {x.dtype}")
    if w_q.dtype != torch.int8 or s_w.dtype != torch.float32 or s_w.shape != (n,):
        raise TypeError(f"w_q must be int8 and s_w a ({n},) fp32 tensor, got {w_q.dtype}, {s_w.dtype} "
                        f"{tuple(s_w.shape)}")
    if w_qt is None:
        raise ValueError("quant_matmul on a CUDA tensor needs w_qt = kernel_layout(w_q), made once when the "
                         "parameters are quantized (it is not rebuilt per call)")
    if w_qt.dtype != torch.int8 or w_qt.shape != (n, k):
        raise ValueError(f"w_qt must be the ({n}, {k}) int8 kernel layout of w_q, got {w_qt.dtype} {tuple(w_qt.shape)}")
    if m < 1 or k % 16 or n % 16:
        raise ValueError(f"quant_matmul takes M >= 1 and K, N multiples of 16, got M={m}, K={k}, N={n}")
    if k > lib.f5_quant_matmul_max_k():
        raise ValueError(f"K = {k} exceeds {lib.f5_quant_matmul_max_k()}: a block keeps the int8 copy of its rows "
                         "for the whole K in shared memory")
    if not (w_q.device == s_w.device == w_qt.device == x.device):
        raise ValueError(f"x, w_q, s_w and w_qt must be on one device, got {x.device}, {w_q.device}, {s_w.device}, "
                         f"{w_qt.device}")
    if not (amax_floor > 0.0 or scale_floor > 0.0) or amax_floor < 0.0 or scale_floor < 0.0:
        raise ValueError(f"one of amax_floor, scale_floor must be positive and none negative, got {amax_floor}, "
                         f"{scale_floor}")


def quant_matmul(x, w_q, s_w, *, w_qt=None, amax_floor: float = 1e-6, scale_floor: float = 0.0):
    """``x (M, K)`` bf16/fp32, ``w_q (K, N)`` int8, ``s_w (N,)`` fp32 ->
    ``(M, N)`` in ``x.dtype``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (which reads ``w_qt``) or raise. Serving-only: a CUDA
    input that requires grad (with grad enabled) raises."""
    dev = x.device
    if dev.type == "cpu":
        return quant_matmul_plain(x, w_q, s_w, amax_floor=amax_floor, scale_floor=scale_floor)
    if dev.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda (kernel) or cpu (plain), got {dev}")
    if torch.is_grad_enabled() and (x.requires_grad or s_w.requires_grad):
        raise RuntimeError("quant_matmul is a serving kernel and has no backward (run under torch.no_grad())")
    lib = _lib()
    _check(lib, x, w_q, s_w, w_qt, amax_floor, scale_floor)
    ptrs = (x.data_ptr(), w_qt.data_ptr(), s_w.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2]) & 15 or not (x.is_contiguous() and w_qt.is_contiguous() and s_w.is_contiguous()):
        raise ValueError("x, w_qt and s_w must be contiguous and 16-byte aligned")
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)

    def launch():
        return lib.f5_quant_matmul(*ptrs, out.data_ptr(), m, k, n, amax_floor, scale_floor,
                                   int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)

    if dev.index is None or dev.index == torch.cuda.current_device():
        err = launch()
    else:  # a tensor on another card than the current one
        with torch.cuda.device(dev):
            err = launch()
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: {lib.f5_error_string(err).decode()}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def mma_rate_probe(blocks: int, iters: int, device) -> None:
    """Measurement aid: launch the kernel source's ``mma.sync`` int8 rate
    loop (``blocks`` blocks of 8 warps, ``8 * iters`` m16n8k32 products per
    warp, no memory traffic). The caller times it; nothing is returned."""
    lib = _lib()
    sink = torch.zeros((1,), dtype=torch.int32, device=device)
    err = lib.f5_quant_matmul_mma_rate(blocks, iters, sink.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mma rate probe launch failed: {lib.f5_error_string(err).decode()}")
