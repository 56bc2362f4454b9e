"""Differentiable flash attention for training: CUDA kernels for Hopper
(``csrc/flash_attention_train.cu``), their plain PyTorch versions, and the
``autograd.Function`` that pairs them.

Replaces ``f5tts_tpu/ops/pallas/flash_attention.py:flash_attention_train``:
the forward kernel that also writes the per-row logsumexp
(``_flash_fwd_lse_kernel``), the backward kernel (``_flash_bwd_kernel``) and
the ``jax.custom_vjp`` around them (``_flash_train_core``). No RoPE here: the
training attention rotates q and k before the call. Unlike the JAX wrapper,
which falls back to XLA SDPA for ``n > 1024`` or ``n % 128 != 0`` (a VMEM
limit), the kernels take any ``n``. The backward runs as two kernels (dK/dV,
then dQ; the source notes why); each counts as one launch.
"""

from __future__ import annotations

import ctypes

import torch

from f5tts_tpu_torch.ops.attention import NEG_INF
from f5tts_tpu_torch.ops.kernels import _build
from f5tts_tpu_torch.ops.kernels.flash_attention import _check


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
        lib.f5_flash_train_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.f5_flash_train_bwd_dkdv.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.f5_flash_train_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, f, p]
        for fn in (lib.f5_flash_train_fwd, lib.f5_flash_train_bwd_dkdv, lib.f5_flash_train_bwd_dq):
            fn.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.f5_error_string(err).decode()}")


def _cuda_args(q, key_mask):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_train runs on cuda (kernel) or cpu (plain), got {q.device}")
    b, h, n, d = q.shape
    if n == 0:
        raise ValueError("flash_attention_train needs n > 0")
    mask = key_mask.contiguous() if key_mask is not None else None
    return (b, h, n, d, int(q.dtype == torch.bfloat16), float(d**-0.5),
            mask.data_ptr() if mask is not None else None, mask)


def flash_attention_train_fwd(q, k, v, key_mask=None):
    """``(o, lse)`` of ``(b, h, n, d)`` q/k/v, ``key_mask (b, n)`` bool or None.
    CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_train_fwd_plain(q, k, v, key_mask)
    _check(q, k, v, key_mask, None)
    b, h, n, d, is_bf16, scale, mask_ptr, _mask = _cuda_args(q, key_mask)
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.f5_flash_train_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                     mask_ptr, b, h, n, d, is_bf16, scale, stream)
    _raise_on(lib, err, "flash_attention_train forward")
    flash_attention_train_fwd.launches += 1
    return o, lse


def flash_attention_train_bwd(q, k, v, o, lse, do, key_mask=None):
    """``(dq, dk, dv)`` for upstream ``do``; the saved ``o`` and ``lse`` come from
    the forward. CPU tensors take the plain version; CUDA tensors launch the two
    backward kernels (two launches) or raise."""
    if q.device.type == "cpu":
        return flash_attention_train_bwd_plain(q, k, v, o, lse, do, key_mask)
    _check(q, k, v, key_mask, None)
    do = do.to(q.dtype).contiguous()
    if do.shape != q.shape or o.shape != q.shape or lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"do/o must be {tuple(q.shape)} and lse {tuple(q.shape[:3])} fp32")
    b, h, n, d, is_bf16, scale, mask_ptr, _mask = _cuda_args(q, key_mask)
    lib = _lib()
    lse = lse.contiguous()
    delta = _delta(do, o).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.f5_flash_train_bwd_dkdv(*ptrs, dk.data_ptr(), dv.data_ptr(), mask_ptr, b, h, n, d, is_bf16,
                                          scale, stream)
        _raise_on(lib, err, "flash_attention_train dK/dV")
        flash_attention_train_bwd.launches += 1
        err = lib.f5_flash_train_bwd_dq(*ptrs, dq.data_ptr(), mask_ptr, b, h, n, d, is_bf16, scale, stream)
        _raise_on(lib, err, "flash_attention_train dQ")
        flash_attention_train_bwd.launches += 1
    return dq, dk, dv


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
        dq, dk, dv = flash_attention_train_bwd(q, k, v, o, lse, do, key_mask)
        return dq, dk, dv, None


def flash_attention_train(q, k, v, key_mask=None):
    """Differentiable ``(b, h, n, d)`` attention; ``key_mask (b, n)`` bool
    (True = valid key) or None."""
    return FlashAttentionTrain.apply(q, k, v, key_mask)
