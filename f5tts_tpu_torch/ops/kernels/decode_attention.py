"""Decode-step attention: CUDA kernel for Hopper (``csrc/decode_attention.cu``)
and its plain PyTorch version.

Replaces ``f5tts_tpu/ops/pallas/decode_attention.py:decode_attention``: one
query position per row of masked softmax attention against a KV cache, with
grouped-query heads. ``q (b, h, 1, d)`` arrives pre-scaled by
``head_dim**-0.5``; the caches are ``(b, n_kv, total, d)`` (K is NOT
transposed and ``total`` needs no padding: both were TPU lane rules);
``bias (b, total)`` is additive fp32 (0 = attend, -1e9 = banned). The kernel's
source notes its bound and design; ``PERF.md`` has its times on the card.

A row whose bias is -1e9 everywhere gets uniform weights over the ``total``
positions it was given, in the kernel and in the plain version alike.

The kernel splits the positions of each (batch row, KV head) across a
thread-block cluster of ``split`` blocks; ``decode_split`` picks it from the
shape, and the launch needs a card with clusters (``sm_90a``).
"""

from __future__ import annotations

import ctypes

import torch

from f5tts_tpu_torch.ops.kernels import _build

_HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)
MAX_CLUSTER = 8  # blocks per cluster, the portable most
MIN_SPAN = 48  # positions a block keeps at least: below, the cluster's exchange costs more than the split gains
BLOCKS_PER_SM = 2  # the grid the split aims for
H100_SMS = 132


def group_tile(group: int) -> int:
    """Group members one block serves (the kernel's GT): 1, 2, else tiles of 4."""
    return 1 if group == 1 else 2 if group == 2 else 4


def decode_split(b: int, n_kv: int, group: int, total: int, sms: int = H100_SMS) -> tuple[int, int]:
    """``(split, span)``: blocks per cluster and positions per block for one
    launch. The split doubles from 1 while the grid has fewer than
    ``BLOCKS_PER_SM`` blocks per SM, up to ``MAX_CLUSTER``, as long as every
    span keeps at least ``MIN_SPAN`` positions; then it shrinks to
    ``ceil(total / span)`` so that no block is left without a position. Block
    ``r`` owns positions ``[r * span, min(total, (r + 1) * span))``. On an
    H100 this gives Parler's self-attention (16 heads, 503 positions) a split
    of 2 at b 16, 1 at b 32 and 8 at b 1, and its 64-position
    cross-attention none."""
    units = b * n_kv * -(-group // group_tile(group))
    split = 1
    while split < MAX_CLUSTER and units * split < BLOCKS_PER_SM * sms and -(-total // (2 * split)) >= MIN_SPAN:
        split *= 2
    span = -(-total // split)
    return -(-total // span), span


def decode_attention_plain(q, k_cache, v_cache, bias):
    """What the kernel computes, in PyTorch: fp32 scores + bias, fp32 softmax
    with the sum floored at 1e-30, weights rounded to the cache dtype, fp32
    accumulation of the product with V, output in ``q.dtype``."""
    b, h, _, d = q.shape
    n_kv = k_cache.shape[1]
    qg = q.reshape(b, n_kv, h // n_kv, d).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float()) + bias.float()[:, None, None, :]
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgt,bktd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return o.to(q.dtype).reshape(b, h, 1, d)


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_f5_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.f5_decode_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.f5_decode_attention.restype = i
        lib.f5_decode_attention_smem.argtypes = [i, i, i, i, i, i, i]
        lib.f5_decode_attention_smem.restype = ctypes.c_longlong
        lib.f5_decode_attention_max_smem.argtypes = []
        lib.f5_decode_attention_max_smem.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


def _check(lib, q, k_cache, v_cache, bias):
    """Shapes, dtypes and devices (everything a call signature fixes);
    returns the launch's split."""
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be (b, h, 1, d), got {tuple(q.shape)}")
    b, h, _, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d or v_cache.shape != k_cache.shape:
        raise ValueError(f"k_cache and v_cache must share one ({b}, n_kv, total, {d}) shape, "
                         f"got {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    n_kv, total = k_cache.shape[1], k_cache.shape[2]
    if n_kv < 1 or h % n_kv or total < 1:
        raise ValueError(f"h = {h} must be a multiple of n_kv = {n_kv}, and total = {total} at least 1")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention takes bf16 or fp32 q/K/V of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode_attention takes head dims {_HEAD_DIMS}, got {d}")
    if b > 65535:
        raise ValueError(f"b = {b} exceeds the kernel's grid limit of 65535")
    if bias.shape != (b, total) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be a ({b}, {total}) fp32 tensor, got {bias.dtype} {tuple(bias.shape)}")
    if not (k_cache.device == v_cache.device == bias.device == q.device):
        raise ValueError(f"q, k_cache, v_cache and bias must be on one device, got {q.device}, {k_cache.device}, "
                         f"{v_cache.device}, {bias.device}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    split, span = decode_split(b, n_kv, h // n_kv, total, sms)
    is_bf16 = int(q.dtype == torch.bfloat16)
    need, most = lib.f5_decode_attention_smem(b, h, n_kv, total, d, is_bf16, split), lib.f5_decode_attention_max_smem()
    if need > most:
        raise ValueError(f"total = {total} needs {need} bytes of shared memory for the scores of its {span}-position "
                         f"spans, over the block's {most}")
    return split


_checked: dict = {}  # call signature -> split, for signatures that passed _check (the decode loop repeats a few)


def decode_attention(q, k_cache, v_cache, bias):
    """``q (b, h, 1, d)`` pre-scaled, ``k_cache``/``v_cache (b, n_kv, total,
    d)``, ``bias (b, total)`` fp32 additive -> ``(b, h, 1, d)`` in ``q.dtype``.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The kernel has no backward (the TPU kernel had none): a CUDA input
    that requires grad (with grad enabled) raises."""
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, bias)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda (kernel) or cpu (plain), got {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad or v_cache.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("decode_attention is a serving kernel and has no backward "
                           "(run under torch.no_grad())")
    lib = _lib()
    signature = (q.shape, k_cache.shape, v_cache.shape, bias.shape, q.dtype, k_cache.dtype, v_cache.dtype,
                 bias.dtype, dev, k_cache.device, v_cache.device, bias.device)
    split = _checked.get(signature)
    if split is None:
        split = _checked[signature] = _check(lib, q, k_cache, v_cache, bias)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), bias.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15 or not (
            q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous() and bias.is_contiguous()):
        raise ValueError("q, k_cache, v_cache and bias must be contiguous and 16-byte aligned")
    b, h, _, d = q.shape
    out = torch.empty_like(q)

    def launch():
        return lib.f5_decode_attention(*ptrs, out.data_ptr(), b, h, k_cache.shape[1], k_cache.shape[2], d,
                                       int(q.dtype == torch.bfloat16), split, torch.cuda.current_stream(dev).cuda_stream)

    if dev.index is None or dev.index == torch.cuda.current_device():
        err = launch()
    else:  # a tensor on another card than the current one
        with torch.cuda.device(dev):
            err = launch()
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: {lib.f5_error_string(err).decode()}")
    _build.count_launch(decode_attention)
    return out


decode_attention.launches = 0
