"""Differentiable flash attention for training: CUDA kernels for Hopper
(``csrc/flash_attention_train.cu``), their plain PyTorch versions, and the
``autograd.Function`` that pairs them.

Replaces ``f5tts_tpu/ops/pallas/flash_attention.py:flash_attention_train``:
the forward kernel that also writes the per-row logsumexp
(``_flash_fwd_lse_kernel``), the backward kernel (``_flash_bwd_kernel``) and
the ``jax.custom_vjp`` around them (``_flash_train_core``). No RoPE here: the
training attention rotates q and k before the call. Unlike the JAX wrapper,
which falls back to XLA SDPA for ``n > 1024`` or ``n % 128 != 0`` (a VMEM
limit), the kernels take any ``n``. The backward runs as two kernels (dQ,
which also computes ``D = rowsum(dO * O)``, then dK/dV; the source notes
why); each counts as one launch. q, k, v, ``do`` and o are read through their
own strides (``readable`` layouts: head-split views of ``(b, n, h*d)``
projections need no copy); o, dq, dk and dv are ``(b, h, n, d)`` views of
``(b, n, h, d)`` buffers.
"""

from __future__ import annotations

import ctypes

import torch

from f5tts_tpu_torch.ops.attention import NEG_INF
from f5tts_tpu_torch.ops.kernels import _build
from f5tts_tpu_torch.ops.kernels.flash_attention import check_operands, strides


def _bias(key_mask, b: int, n: int, device) -> torch.Tensor:
    """``(b, 1, 1, n)`` fp32 key bias: 0 / -1e30 from ``key_mask``, zeros when None."""
    if key_mask is None:
        return torch.zeros((b, 1, 1, n), dtype=torch.float32, device=device)
    return torch.where(key_mask, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]


def _scores(q, k, key_mask):
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return s + _bias(key_mask, q.shape[0], q.shape[2], q.device)


def flash_attention_train_fwd_plain(q, k, v, key_mask=None):
    """``(o, lse)`` as the forward kernel computes them: fp32 scores, ``p``
    rounded to ``v``'s dtype before the PV product, ``o / max(l, 1e-30)`` in
    ``q``'s dtype, ``lse = m + log(max(l, 1e-30))`` ``(b, h, n)`` fp32."""
    s = _scores(q, k, key_mask)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / den).to(q.dtype), (m + torch.log(den))[..., 0]


def flash_attention_train_bwd_plain(q, k, v, o, lse, do, key_mask=None):
    """``(dq, dk, dv)`` spelled out as the backward kernel computes them."""
    scale = q.shape[-1] ** -0.5
    delta = _delta(do, o)  # D = rowsum(dO * O)
    p = torch.exp(_scores(q, k, key_mask) - lse[..., None])  # rows normalized by the saved lse
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(do, o) -> torch.Tensor:
    return (do.float() * o.float()).sum(-1)


def _lib():
    lib = _build.load("flash_attention_train")
    if not getattr(lib, "_f5_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        f = ctypes.c_float
        lib.f5_flash_train_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, p, p]
        lib.f5_flash_train_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p, p]
        lib.f5_flash_train_bwd_dkdv.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p, p]
        for fn in (lib.f5_flash_train_fwd, lib.f5_flash_train_bwd_dq, lib.f5_flash_train_bwd_dkdv):
            fn.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.f5_error_string(err).decode()}")


def readable(t) -> bool:
    """Whether the kernels read the ``(b, h, n, d)`` operand ``t`` in place: a
    contiguous last axis, the other strides positive multiples of 16 bytes (a
    size-1 axis reads as the whole extent, see ``strides``) and a 16-byte
    aligned start. Head-split views of ``(b, n, h*d)`` projections are."""
    st = strides(t)
    vec = 16 // t.element_size()  # elements of a 16-byte row step
    return st[3] == 1 and all(x > 0 and x % vec == 0 for x in st[:3]) and t.data_ptr() % 16 == 0


def kernel_strides(t, name: str = "tensor") -> tuple[int, int, int]:
    """The ``(batch, head, row)`` element strides through which the kernels
    read a ``(b, h, n, d)`` operand, each tensor its own. Raises
    ``ValueError`` on a layout that is not ``readable``."""
    if not readable(t):
        raise ValueError(f"{name} must have a contiguous last axis and its other strides positive multiples of 16 "
                         f"bytes, 16-byte aligned; got strides {tuple(t.stride())}")
    return strides(t)[:3]


def stride_args(**tensors) -> tuple[int, ...]:
    """The kernels' 15 strides: those of q, k, v, dout, o in this order, zeros
    for the operands a call does not read."""
    order = ("q", "k", "v", "dout", "o")
    return tuple(x for name in order for x in (kernel_strides(tensors[name], name) if name in tensors else (0, 0, 0)))


def _cuda_args(q, k, v, key_mask, **more):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_train runs on cuda (kernel) or cpu (plain), got {q.device}")
    check_operands(q, k, v, key_mask)
    b, h, n, d = q.shape
    if n == 0:
        raise ValueError("flash_attention_train needs n > 0")
    st = (ctypes.c_longlong * 15)(*stride_args(q=q, k=k, v=v, **more))
    mask = key_mask.contiguous() if key_mask is not None else None
    return (b, h, n, d, int(q.dtype == torch.bfloat16), float(d**-0.5), st,
            mask.data_ptr() if mask is not None else None, mask)


def flash_attention_train_fwd(q, k, v, key_mask=None):
    """``(o, lse)`` of ``(b, h, n, d)`` q/k/v, ``key_mask (b, n)`` bool or None;
    o is a ``(b, h, n, d)`` view of a ``(b, n, h, d)`` buffer. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise (layouts that
    are not ``readable`` included: it never copies)."""
    if q.device.type == "cpu":
        return flash_attention_train_fwd_plain(q, k, v, key_mask)
    b, h, n, d, is_bf16, scale, st, mask_ptr, _mask = _cuda_args(q, k, v, key_mask)
    lib = _lib()
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.f5_flash_train_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                     mask_ptr, b, h, n, d, is_bf16, scale, st, stream)
    _raise_on(lib, err, "flash_attention_train forward")
    _build.count_launch(flash_attention_train_fwd)
    return o.transpose(1, 2), lse


def flash_attention_train_bwd(q, k, v, o, lse, do, key_mask=None):
    """``(dq, dk, dv)`` for upstream ``do``, each a ``(b, h, n, d)`` view of a
    ``(b, n, h, d)`` buffer; the saved ``o`` and ``lse`` come from the forward.
    CPU tensors take the plain version; CUDA tensors launch the two backward
    kernels (two launches: dQ, which also computes ``D = rowsum(dO * O)``,
    then dK/dV) or raise. q, k, v, o and ``do`` are read through their own
    strides (``readable`` layouts)."""
    if q.device.type == "cpu":
        return flash_attention_train_bwd_plain(q, k, v, o, lse, do, key_mask)
    do = do.to(q.dtype)
    if (do.shape != q.shape or o.shape != q.shape or o.dtype != q.dtype or lse.shape != q.shape[:3]
            or lse.dtype != torch.float32 or any(t.device != q.device for t in (o, lse, do))):
        raise ValueError(f"do/o must be {tuple(q.shape)} {q.dtype} and lse {tuple(q.shape[:3])} fp32, on {q.device}")
    b, h, n, d, is_bf16, scale, st, mask_ptr, _mask = _cuda_args(q, k, v, key_mask, dout=do, o=o)
    lib = _lib()
    lse = lse.contiguous()
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.f5_flash_train_bwd_dq(*ptrs, dq.data_ptr(), mask_ptr, b, h, n, d, is_bf16, scale, st, stream)
        _raise_on(lib, err, "flash_attention_train dQ")
        _build.count_launch(flash_attention_train_bwd)
        err = lib.f5_flash_train_bwd_dkdv(*ptrs, dk.data_ptr(), dv.data_ptr(), mask_ptr, b, h, n, d, is_bf16, scale,
                                          st, stream)
        _raise_on(lib, err, "flash_attention_train dK/dV")
        _build.count_launch(flash_attention_train_bwd)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


flash_attention_train_fwd.launches = 0
flash_attention_train_bwd.launches = 0


class FlashAttentionTrain(torch.autograd.Function):
    """Forward kernel + backward kernels; saves ``q, k, v, o, lse`` (the
    counterpart of ``_flash_train_core``). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        o, lse = flash_attention_train_fwd(q, k, v, key_mask)
        ctx.save_for_backward(q, k, v, o, lse, key_mask)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, key_mask = ctx.saved_tensors
        if do.is_cuda and not readable(do):  # a gradient in a layout the kernels do not read (e.g. expanded)
            do = do.contiguous()
        dq, dk, dv = flash_attention_train_bwd(q, k, v, o, lse, do, key_mask)
        return dq, dk, dv, None


def flash_attention_train(q, k, v, key_mask=None):
    """Differentiable ``(b, h, n, d)`` attention; ``key_mask (b, n)`` bool
    (True = valid key) or None."""
    return FlashAttentionTrain.apply(q, k, v, key_mask)
