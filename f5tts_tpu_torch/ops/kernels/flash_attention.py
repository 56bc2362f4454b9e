"""Flash attention: CUDA kernel for Hopper (``csrc/flash_attention.cu``) and
its plain PyTorch version.

Replaces ``f5tts_tpu/ops/pallas/flash_attention.py:flash_attention``:
bidirectional key-padding-masked attention on ``(b, h, n, d)`` with the RoPE
fused in (head 0 only unless ``rope_all_heads``). The kernel's source notes
its bound and design; ``PERF.md`` has its times on the card.

On a CUDA tensor the dispatch is by type and head dim: bf16 at d 64 / 128
launches the RoPE pre-pass (``rope_rows``, when there is RoPE) and the
``wgmma`` kernel; bf16 at d 32 and fp32 launch the ``mma.sync`` and CUDA-core
kernels. Each wrapper counts its own kernel's launches (``.launches``). q, k,
v may be strided ``(b, h, n, d)`` views (the head split of ``(b, n, h*d)``
projections): the kernels read them through their strides, and the result
is a ``(b, h, n, d)`` view of a ``(b, n, h, d)`` buffer. The kernels take the
fp32 ``cos``/``sin`` of the RoPE table: a caller that reuses one table
(the DiT, every layer of every forward) makes them once and passes them in.
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
        ll = ctypes.c_longlong
        lib.f5_flash_attention.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, ll, ll, ll, p]
        lib.f5_flash_attention.restype = i
        lib.f5_rope_rows.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, ll, p]
        lib.f5_rope_rows.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


def strides(t) -> tuple[int, ...]:
    """``t``'s element strides, a size-1 axis given the extent of the whole
    tensor (its index is always 0, so any stride reads the same elements)."""
    span = max(x * z for x, z in zip(t.stride(), t.shape))
    return tuple(x if z > 1 else span for x, z in zip(t.stride(), t.shape))


def check_operands(q, k, v, key_mask) -> None:
    """What every attention kernel takes: q, k, v of one ``(b, h, n, d)``
    shape and one dtype (bf16 or fp32) on one device, a built head dim,
    ``b*h`` within the grid, ``key_mask (b, n)`` bool or None."""
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"q, k, v must share one (b, h, n, d) shape, got {q.shape}, {k.shape}, {v.shape}")
    b, h, n, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {_HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} exceeds the kernel's grid limit of 65535")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"k and v must be on {q.device}")
    if key_mask is not None:
        if key_mask.shape != (b, n) or key_mask.dtype != torch.bool or key_mask.device != q.device:
            raise ValueError(f"key_mask must be a ({b}, {n}) bool tensor on {q.device}")


def _check(q, k, v, key_mask, rope_freqs):
    check_operands(q, k, v, key_mask)
    b, h, n, d = q.shape
    vec = 16 // q.element_size()  # elements of a 16-byte row step
    st = strides(q)
    if (strides(k) != st or strides(v) != st or st[3] != 1 or st[0] % vec or st[1] % vec or st[2] % vec
            or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16):
        raise ValueError(f"q, k, v must share strides with a contiguous last axis, the others multiples of 16 "
                         f"bytes, 16-byte aligned; got strides {q.stride()}, {k.stride()}, {v.stride()}")
    if rope_freqs is not None and (rope_freqs.shape != (n, d) or rope_freqs.device != q.device):
        raise ValueError(f"rope_freqs must be ({n}, {d}) on {q.device}, got {tuple(rope_freqs.shape)}")
    return st


def cos_sin_of(freqs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 ``cos``/``sin`` of a RoPE angle table, as the kernels take them."""
    f = freqs.float()
    return torch.cos(f).contiguous(), torch.sin(f).contiguous()


def _raise_on(lib, err: int):
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {lib.f5_error_string(err).decode()}")


def rope_rows(q, k, cos, sin, rope_all_heads: bool) -> torch.Tensor:
    """The bf16 d 64 / 128 kernel's RoPE pre-pass, one launch: q and k (CUDA,
    checked by ``flash_attention``) of head 0, or of every head, rotated into a
    ``(2, b, hr, n, d)`` tensor."""
    b, h, n, d = q.shape
    lib = _lib()
    out = torch.empty((2, b, h if rope_all_heads else 1, n, d), dtype=q.dtype, device=q.device)
    _raise_on(lib, lib.f5_rope_rows(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                                    b, h, n, d, 2 if rope_all_heads else 1, *strides(q)[:3],
                                    torch.cuda.current_stream(q.device).cuda_stream))
    rope_rows.launches += 1
    return out


rope_rows.launches = 0


def flash_attention(q, k, v, key_mask=None, rope_freqs=None, rope_all_heads: bool = False, *, rope_cos_sin=None):
    """``(b, h, n, d)`` attention; ``key_mask (b, n)`` bool (True = valid key),
    ``rope_freqs (n, d)`` fp32 angles or None; ``rope_cos_sin``: their
    ``cos_sin_of`` made once by the caller, else made here. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise (strides
    it does not take included: it never copies). The kernel has no
    backward: a CUDA input that requires grad (with grad enabled) raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, rope_freqs, rope_all_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu (plain), got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is the serving kernel and has no backward; differentiate through "
                           "ops.kernels.flash_attention_train.flash_attention_train (or run under torch.no_grad())")
    sb, sh, sn, _ = _check(q, k, v, key_mask, rope_freqs)
    b, h, n, d = q.shape
    lib = _lib()
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    mask = key_mask.contiguous() if key_mask is not None else None
    cos = sin = rotated = None
    rope_mode = 0
    with torch.cuda.device(q.device):
        if rope_freqs is not None:
            cos, sin = rope_cos_sin if rope_cos_sin is not None else cos_sin_of(rope_freqs)
            if any(t.shape != (n, d) or t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device
                   for t in (cos, sin)):
                raise ValueError(f"rope_cos_sin must be two contiguous ({n}, {d}) fp32 tensors on {q.device}")
            rope_mode = 2 if rope_all_heads else 1
            if q.dtype == torch.bfloat16 and d in (64, 128):
                rotated = rope_rows(q, k, cos, sin, rope_all_heads)
        _raise_on(lib, lib.f5_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            cos.data_ptr() if cos is not None else None,
            sin.data_ptr() if sin is not None else None,
            rotated.data_ptr() if rotated is not None else None,
            b, h, n, d, int(q.dtype == torch.bfloat16), rope_mode, float(d**-0.5), sb, sh, sn,
            torch.cuda.current_stream(q.device).cuda_stream))
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0
