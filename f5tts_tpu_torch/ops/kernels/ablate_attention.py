"""The d = 64 attention core in five exact layouts: CUDA kernel for Hopper
(``csrc/ablate_attention.cu``) and its plain PyTorch versions.

Replaces ``scripts/ablate_attention.py:build(...).call``, the layout ablation
of the attention kernel: how two d = 64 heads map onto the matrix unit. Every
layout computes the same function of ``q, k, v (BH, N, 64)`` and ``bias (1, 1,
N)`` fp32 (added to every row's scores, scale ``64**-0.5``); they differ only in
the products they issue. Layouts after ``unpacked`` take heads in pairs
``(2i, 2i + 1)``. The kernel's source notes its bound and design; ``PERF.md``
has its times on the card. Nothing on a serving or training path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from f5tts_tpu_torch.ops.kernels import _build

LAYOUTS = ("unpacked", "packed_blockdiag", "packed_sep_o", "sumdiff_blockdiag", "sumdiff_dense_cross")
PAIR_LAYOUTS = LAYOUTS[1:]
BLOCK_QS = (64, 128)  # query rows per block: 4 or 8 warps of 16 rows
HEAD_DIM = 64
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
_KEY_TILE = 64
# mma.sync m16n8k16 a warp issues per 64-key tile (16 query rows, one head or a pair)
_MMA_PER_TILE = {"unpacked": 64, "packed_blockdiag": 256, "packed_sep_o": 192, "sumdiff_blockdiag": 256,
                 "sumdiff_dense_cross": 256}


def mma_per_call(layout: str, bh: int, n: int) -> int:
    """The ``mma.sync`` m16n8k16 instructions the kernel issues for one call:
    ``unpacked`` issues the true work, 4 BH N^2 64 flops / 4096 flops each."""
    warps = bh // (1 if layout == "unpacked" else 2) * (n // 16)
    return warps * (n // _KEY_TILE) * _MMA_PER_TILE[layout]


def _softmax_rows(s):
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return p, p.sum(-1, keepdim=True)


def _block_diag(a, b):
    """``[[a, 0], [0, b]]`` of two ``(P, N, D)`` stacks, zeros written out."""
    z = torch.zeros_like(a)
    return torch.cat([torch.cat([a, z], -1), torch.cat([z, b], -1)], -2)


def _unpacked(bias, q, k, v, scale, pdt):
    s = q @ k.mT * scale
    s = s + bias
    p, l = _softmax_rows(s)
    return (p.to(pdt).float() @ v) / l.clamp_min(1e-30)


def _packed(bias, qa, qb, ka, kb, va, vb, scale, pdt, sep_o):
    n, d = ka.shape[-2:]
    s = torch.cat([qa, qb], -1) @ _block_diag(ka, kb).mT * scale
    pa, la = _softmax_rows(s[..., :n] + bias)
    pb, lb = _softmax_rows(s[..., n:] + bias)
    if sep_o:
        oa, ob = pa.to(pdt).float() @ va, pb.to(pdt).float() @ vb
    else:
        o = torch.cat([pa, pb], -1).to(pdt).float() @ _block_diag(va, vb)
        oa, ob = o[..., :d], o[..., d:]
    return oa / la.clamp_min(1e-30), ob / lb.clamp_min(1e-30)


def _sumdiff(bias, qa, qb, ka, kb, va, vb, scale, pdt, dense_cross):
    nq, d = qa.shape[-2:]
    kc = torch.cat([ka, kb], -1)  # (P, N, 2D) dense
    ssum = torch.cat([qa, qb], -1) @ kc.mT
    sdif = torch.cat([qa, -qb], -1) @ kc.mT
    sa = 0.5 * (ssum + sdif) * scale + bias
    sb = 0.5 * (ssum - sdif) * scale + bias
    if dense_cross:
        # softmax over the stacked halves, ONE dense product [pa; pb] . [va|vb]; keep the diagonal blocks
        p2, l2 = _softmax_rows(torch.cat([sa, sb], -2))
        o2 = p2.to(pdt).float() @ torch.cat([va, vb], -1)
        return o2[..., :nq, :d] / l2[..., :nq, :].clamp_min(1e-30), o2[..., nq:, d:] / l2[..., nq:, :].clamp_min(1e-30)
    pa, la = _softmax_rows(sa)
    pb, lb = _softmax_rows(sb)
    o = torch.cat([pa, pb], -1).to(pdt).float() @ _block_diag(va, vb)
    return o[..., :d] / la.clamp_min(1e-30), o[..., d:] / lb.clamp_min(1e-30)


def ablate_attention_plain(layout: str, bias, q, k, v):
    """The JAX body of ``layout`` written out in PyTorch: the concatenations,
    zero blocks, sum/difference and stacked softmax as they stand, computed in
    fp32 from the inputs' dtype, p rounded to v's dtype before the PV product,
    the output in q's dtype."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    scale = q.shape[-1] ** -0.5
    b = bias.float()[0]  # (1, N): every row's scores
    qf, kf, vf = q.float(), k.float(), v.float()
    if layout == "unpacked":
        return _unpacked(b, qf, kf, vf, scale, v.dtype).to(q.dtype)
    halves = [t[0::2] for t in (qf, kf, vf)] + [t[1::2] for t in (qf, kf, vf)]
    qa, ka, va, qb, kb, vb = halves
    if layout.startswith("packed"):
        oa, ob = _packed(b, qa, qb, ka, kb, va, vb, scale, v.dtype, layout == "packed_sep_o")
    else:
        oa, ob = _sumdiff(b, qa, qb, ka, kb, va, vb, scale, v.dtype, layout == "sumdiff_dense_cross")
    return torch.stack([oa, ob], 1).reshape(q.shape).to(q.dtype)


def _lib():
    lib = _build.load("ablate_attention")
    if not getattr(lib, "_f5_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.f5_ablate_attention.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p, p]
        lib.f5_ablate_attention.restype = i
        lib.f5_ablate_attention_smem.argtypes = [i, i]
        lib.f5_ablate_attention_smem.restype = ctypes.c_longlong
        lib.f5_ablate_attention_blocks_per_sm.argtypes = [i, i, i]
        lib.f5_ablate_attention_blocks_per_sm.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


def _check_launch(layout, bq, min_smem):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if bq not in BLOCK_QS:
        raise ValueError(f"bq must be one of {BLOCK_QS}, got {bq}")
    if not 0 <= min_smem <= MAX_SMEM:
        raise ValueError(f"min_smem must be in 0 .. {MAX_SMEM} bytes, got {min_smem}")


def smem_bytes(layout: str, bq: int = 64) -> int:
    """Dynamic shared memory of one block of ``layout`` (the kernel's own
    figure; builds the kernel)."""
    _check_launch(layout, bq, 0)
    return int(_lib().f5_ablate_attention_smem(LAYOUTS.index(layout), bq))


def blocks_per_sm(layout: str, bq: int = 64, min_smem: int = 0) -> int:
    """Blocks of ``layout`` that share one SM of the current CUDA device, with
    at least ``min_smem`` bytes of shared memory each (CUDA's occupancy
    calculator; builds the kernel)."""
    _check_launch(layout, bq, min_smem)
    lib = _lib()
    blocks = lib.f5_ablate_attention_blocks_per_sm(LAYOUTS.index(layout), bq, min_smem)
    if blocks < 0:
        raise RuntimeError(f"ablate_attention occupancy query failed: {lib.f5_error_string(-blocks).decode()}")
    return blocks


def _check(layout, bias, q, k, v, bq, mma_count, min_smem):
    _check_launch(layout, bq, min_smem)
    if q.ndim != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v must share one (BH, N, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, n, d = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"ablate_attention takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d != HEAD_DIM:
        raise ValueError(f"ablate_attention takes head dim {HEAD_DIM} only, got {d}")
    if n == 0 or n % bq:
        raise ValueError(f"N = {n} must be a positive multiple of bq = {bq}")
    if layout in PAIR_LAYOUTS and bh % 2:
        raise ValueError(f"{layout} takes heads in pairs: BH = {bh} must be even")
    if not 0 < bh <= 65535:
        raise ValueError(f"BH = {bh} must be in 1 .. 65535 (the kernel's grid)")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {q.device}")
    if bias.shape != (1, 1, n):
        raise ValueError(f"bias must be (1, 1, {n}), got {tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be fp32, got {bias.dtype}")
    if mma_count is not None and (mma_count.shape != (1,) or mma_count.dtype != torch.int64
                                  or mma_count.device != q.device):
        raise ValueError(f"mma_count must be a (1,) int64 tensor on {q.device}")


def ablate_attention(layout: str, bias, q, k, v, bq: int = 64, mma_count=None, min_smem: int = 0):
    """The attention core of ``q, k, v (BH, N, 64)`` in ``layout``. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise (bf16 only,
    ``bq`` 64 or 128 query rows per block, N a multiple of ``bq``, BH even for
    the pair layouts). ``mma_count``, a ``(1,)`` int64 CUDA tensor, gets the
    ``mma.sync`` the launch issues added to it. ``min_smem`` reserves at least
    that many bytes of shared memory per block, so that fewer blocks share an
    SM (an occupancy control for measurements). No backward: a CUDA input that
    requires grad (with grad enabled) raises."""
    if q.device.type == "cpu":
        return ablate_attention_plain(layout, bias, q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"ablate_attention runs on cuda (kernel) or cpu (plain), got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("ablate_attention has no backward (run it under torch.no_grad())")
    _check(layout, bias, q, k, v, bq, mma_count, min_smem)
    bh, n, d = q.shape
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.f5_ablate_attention(bias.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      LAYOUTS.index(layout), bh, n, bq, float(d**-0.5), min_smem,
                                      mma_count.data_ptr() if mma_count is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"ablate_attention kernel launch failed: {lib.f5_error_string(err).decode()}")
    ablate_attention.launches += 1
    return out


ablate_attention.launches = 0
