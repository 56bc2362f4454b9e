"""Flash attention: CUDA kernel for Hopper (``csrc/flash_attention.cu``) and
its plain PyTorch version.

Replaces ``f5tts_tpu/ops/pallas/flash_attention.py:flash_attention``:
bidirectional key-padding-masked attention on ``(b, h, n, d)`` with the RoPE
fused in (head 0 only unless ``rope_all_heads``). The kernel's source notes
its bound and design; ``PERF.md`` has its times on the card.
"""

from __future__ import annotations

import ctypes

import torch

from f5tts_tpu_torch.ops.attention import sdpa
from f5tts_tpu_torch.ops.kernels import _build
from f5tts_tpu_torch.ops.rope import apply_rotary_per_head

_HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention_plain(q, k, v, key_mask=None, rope_freqs=None, rope_all_heads: bool = False):
    """RoPE (head 0, or every head) then ``sdpa`` — what the kernel computes."""
    if rope_freqs is not None:
        if rope_all_heads:
            q, k = apply_rotary_per_head(q, rope_freqs), apply_rotary_per_head(k, rope_freqs)
        else:
            q = torch.cat([apply_rotary_per_head(q[:, :1], rope_freqs), q[:, 1:]], 1)
            k = torch.cat([apply_rotary_per_head(k[:, :1], rope_freqs), k[:, 1:]], 1)
    return sdpa(q, k, v, key_mask)


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_f5_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.f5_flash_attention.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.f5_flash_attention.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


def _check(q, k, v, key_mask, rope_freqs):
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"q, k, v must share one (b, h, n, d) shape, got {q.shape}, {k.shape}, {v.shape}")
    b, h, n, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {_HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} exceeds the kernel's grid limit of 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {q.device}")
    if key_mask is not None:
        if key_mask.shape != (b, n) or key_mask.dtype != torch.bool or key_mask.device != q.device:
            raise ValueError(f"key_mask must be a ({b}, {n}) bool tensor on {q.device}")
    if rope_freqs is not None and (rope_freqs.shape != (n, d) or rope_freqs.device != q.device):
        raise ValueError(f"rope_freqs must be ({n}, {d}) on {q.device}, got {tuple(rope_freqs.shape)}")


def flash_attention(q, k, v, key_mask=None, rope_freqs=None, rope_all_heads: bool = False):
    """``(b, h, n, d)`` attention; ``key_mask (b, n)`` bool (True = valid key),
    ``rope_freqs (n, d)`` fp32 angles or None. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. The kernel has no
    backward: a CUDA input that requires grad (with grad enabled) raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, rope_freqs, rope_all_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu (plain), got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is the serving kernel and has no backward; differentiate through "
                           "ops.kernels.flash_attention_train.flash_attention_train (or run under torch.no_grad())")
    _check(q, k, v, key_mask, rope_freqs)
    b, h, n, d = q.shape
    lib = _lib()
    out = torch.empty_like(q)
    mask = key_mask.contiguous() if key_mask is not None else None
    cos = sin = None
    rope_mode = 0
    if rope_freqs is not None:
        f = rope_freqs.float()
        cos, sin = torch.cos(f).contiguous(), torch.sin(f).contiguous()
        rope_mode = 2 if rope_all_heads else 1
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.f5_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            cos.data_ptr() if cos is not None else None,
            sin.data_ptr() if sin is not None else None,
            b, h, n, d, int(q.dtype == torch.bfloat16), rope_mode, float(d**-0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {lib.f5_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
