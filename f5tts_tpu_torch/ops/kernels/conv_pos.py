"""Grouped conv-position pair: CUDA kernel for Hopper (``csrc/conv_pos.cu``)
and its plain PyTorch version.

Replaces ``f5tts_tpu/ops/pallas/conv_pos.py:conv_pos_pallas``: on ``x (b, n,
c)`` (already masked by the caller) two grouped Conv1d with "same" zero
padding, each + bias + Mish in fp32; the intermediate is zeroed on rows
``t >= lens[b]`` and stored in ``x.dtype``. On a CUDA tensor the dispatch is
by type and shape: bf16 with group width 64 and an odd kernel width up to 31
(the DiT's) is one launch of the fused pair (``conv_pair_kernel``, wgmma,
the intermediate never in device memory); fp32 or any other group width is
two launches of the CUDA-core layer (``conv_generic_kernel``), the
intermediate in device memory. The kernel source notes the design and its
bound.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.ops.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _grouped_conv_mish(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """fp32 ``mish(conv(x) + b)`` over ``x.dtype`` inputs, as shifted per-tap
    grouped contractions (the JAX package's grouped-conv form)."""
    bsz, n, c = x.shape
    k, cg, c_out = w.shape
    pad = k // 2
    xp = F.pad(x.float(), (0, 0, pad, pad))
    wg = w.to(x.dtype).float().reshape(k, cg, groups, c_out // groups)
    y = b.float().reshape(groups, c_out // groups).expand(bsz, n, groups, c_out // groups)
    for i in range(k):
        y = y + torch.einsum("bngi,igo->bngo", xp[:, i : i + n].reshape(bsz, n, groups, cg), wg[i])
    return mish(y.reshape(bsz, n, c_out))


def conv_pos_plain(x, w1, b1, w2, b2, lens=None, groups: int = 16):
    """Plain version of the kernel pair (fp32 math, ``x.dtype`` intermediate)."""
    y1 = _grouped_conv_mish(x, w1, b1, groups)
    if lens is not None:
        rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
        y1 = torch.where(rows < lens.to(x.device)[:, None, None], y1, 0.0)
    y1 = y1.to(x.dtype)
    return _grouped_conv_mish(y1, w2, b2, groups).to(x.dtype)


def _lib():
    lib = _build.load("conv_pos")
    if not getattr(lib, "_f5_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.f5_conv_pos_layer.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.f5_conv_pos_layer.restype = i
        lib.f5_conv_pos_pair.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.f5_conv_pos_pair.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


PAIR_MAX_K = 31  # widest kernel the fused pair's slab holds (csrc/conv_pos.cu:PKMAX)


def _check_layer(x, w, b, groups: int):
    c = x.shape[2]
    k, cg, c_out = w.shape
    if c_out != c or cg * groups != c or k % 2 == 0:
        raise ValueError(f"conv_pos takes an odd-width grouped kernel (k, c/groups, c) for c={c}, got {tuple(w.shape)}")
    if b.shape != (c,):
        raise ValueError(f"conv_pos bias must be ({c},), got {tuple(b.shape)}")


def _raise_on(lib, err: int):
    if err != 0:
        raise RuntimeError(f"conv_pos kernel launch failed: {lib.f5_error_string(err).decode()}")


def _layer(lib, x, w, b, lens, groups: int, mask_rows: bool) -> torch.Tensor:
    """One layer on the CUDA cores (fp32, other group widths)."""
    bsz, n, c = x.shape
    w = w.to(x.dtype).contiguous()
    b = b.float().contiguous()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(lib, lib.f5_conv_pos_layer(x.data_ptr(), w.data_ptr(), b.data_ptr(), lens.data_ptr(), y.data_ptr(),
                                         bsz, n, c, groups, w.shape[0], int(x.dtype == torch.bfloat16),
                                         int(mask_rows), stream))
    _build.count_launch(conv_pos)
    return y


def _pair(lib, x, w1, b1, w2, b2, lens) -> torch.Tensor:
    """The fused pair (bf16, group width 64): one launch."""
    bsz, n, c = x.shape
    w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    b1, b2 = b1.float().contiguous(), b2.float().contiguous()
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("conv_pos: x and the weights must be 16-byte aligned")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(lib, lib.f5_conv_pos_pair(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                        lens.data_ptr(), y.data_ptr(), bsz, n, c, w1.shape[0], stream))
    _build.count_launch(conv_pos)
    return y


def conv_pos(x, w1, b1, w2, b2, lens=None, groups: int = 16):
    """``mish(conv2(mask_lens(mish(conv1(x) + b1))) + b2)`` on ``x (b, n, c)``;
    ``lens (b,)`` int valid prefix per row (None = every row full). CPU
    tensors take the plain version; CUDA tensors launch the kernels or raise:
    bf16 with group width 64 one launch of the fused pair, fp32 or another
    group width two launches of the CUDA-core layer. A CUDA input that
    requires grad (with grad enabled) raises: ``conv_pos_train`` is the
    differentiable form."""
    if x.device.type == "cpu":
        return conv_pos_plain(x, w1, b1, w2, b2, lens, groups)
    if x.device.type != "cuda":
        raise ValueError(f"conv_pos runs on cuda (kernel) or cpu (plain), got {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError("conv_pos has no backward kernel; differentiate through conv_pos_train "
                           "(or run under torch.no_grad())")
    if x.ndim != 3 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"conv_pos takes a contiguous bf16/fp32 (b, n, c) tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] > 65535:
        raise ValueError("conv_pos batch exceeds the kernel's grid limit of 65535")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"conv_pos weights must be on {x.device}")
    if lens is None:
        lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    if lens.shape != (x.shape[0],) or lens.device != x.device:
        raise ValueError(f"lens must be ({x.shape[0]},) on {x.device}")
    lens = lens.to(torch.int32).contiguous()
    _check_layer(x, w1, b1, groups)
    _check_layer(x, w2, b2, groups)
    lib = _lib()
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16 and w1.shape[1] == 64 and w1.shape == w2.shape and w1.shape[0] <= PAIR_MAX_K:
            return _pair(lib, x, w1, b1, w2, b2, lens)
        y1 = _layer(lib, x, w1, b1, lens, groups, mask_rows=True)
        return _layer(lib, y1, w2, b2, lens, groups, mask_rows=False)


conv_pos.launches = 0


class ConvPosTrain(torch.autograd.Function):
    """Forward through the kernel (``conv_pos``), backward by
    differentiating the plain formulation (the counterpart of the JAX
    package's ``_conv_pos_fused`` custom VJP; there is no backward kernel).
    ``lens (b,)`` zeroes each row's intermediate past its valid prefix, in the
    kernel and in the plain backward alike (None = every row full length)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, lens, groups):
        ctx.groups = groups
        ctx.save_for_backward(x, w1, b1, w2, b2, lens)
        return conv_pos(x, w1, b1, w2, b2, lens, groups)

    @staticmethod
    def backward(ctx, g):
        *saved, lens = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True) for t in saved]
        with torch.enable_grad():
            y = conv_pos_plain(*inputs, lens, ctx.groups)
        return (*torch.autograd.grad(y, inputs, g), None, None)


def conv_pos_train(x, w1, b1, w2, b2, lens=None, groups: int = 16):
    """Differentiable ``conv_pos``: the kernel forward, the plain backward;
    ``lens (b,)`` int valid prefix per row (None = every row full)."""
    return ConvPosTrain.apply(x, w1, b1, w2, b2, lens, groups)
