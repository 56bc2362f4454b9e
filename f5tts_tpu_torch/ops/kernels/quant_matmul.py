"""Fused W8A8 matmul: CUDA kernel for Hopper (``csrc/quant_matmul.cu``) and its
plain PyTorch version.

Replaces ``f5tts_tpu/ops/pallas/quant_matmul.py:quant_matmul``: per-row
dynamic int8 quantization of the activations, int8 x int8 -> int32, rescale by
the row and column scales, output in ``x.dtype``. ``x (M, K)`` bf16 or fp32,
``w_q (K, N)`` int8, ``s_w (N,)`` fp32, and an optional bias ``b (N,)`` added
as ``modules._linear_int8`` adds it: after the rounding to ``x.dtype``, in
``x.dtype`` (one launch instead of a matmul and an add).

Two floors guard the row scale ``sx = max(max(ax, amax_floor) / 127,
scale_floor)``, because the JAX package has two conventions: its Pallas kernel
floors the abs-max at 1e-6 (the defaults here), ``modules._linear_int8`` floors
the scale at 1e-8 (``amax_floor=0, scale_floor=1e-8``). They differ only for
rows whose abs-max is under 1.27e-6.

The kernel reads the weights K-contiguous, ``w_qt (N, K)``: ``kernel_layout``
makes that copy once, when the parameters are quantized; a CUDA call without
it raises instead of transposing per call. Kernel and plain version agree bit
for bit: every step is exact integer arithmetic or one correctly rounded fp32
operation in a fixed order. ``plan`` picks the kernel's path and its split of
the N tiles over blocks from the shape (pure Python, tested on the CPU). The
kernel's source notes its bound and design; ``PERF.md`` has its times on the
card.

Tensor parallelism (a row-parallel linear, ``models/modules.py``): each rank
holds a K-shard, but the row's abs-max must span the whole row and the
product the whole K. ``row_amax`` gives the local abs-max (all-reduced with
MAX by the caller), ``quant_matmul(amax=..., raw=True)`` quantizes by that
given abs-max and returns the int32 accumulators (summed over the ranks by the
caller, exactly), and ``rescale_rows`` applies the row and column scales and
the bias as the one-device call would: the sharded linear is bit-equal to the
one-device one. Each is one kernel launch on a CUDA tensor, counted on its own
wrapper.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from f5tts_tpu_torch.ops.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)
H100_SMS = 132
MAX_SMEM = 232448  # dynamic shared memory a block may ask for on sm_90
MAX_K = 65536  # the kernel's int32 accumulators stay exact: K * 127 * 127 < 2^31
PANEL = 128  # k values (bytes) of one swizzled operand row
BM = 128  # rows of a block
BN = 128  # output columns of a tile
NCW = 4  # consumer warpgroups
STAGING = NCW * 4 * 8 * 128  # the epilogue's 8-row x 128-byte piece per consumer warp
COLUMNS = NCW * 2 * BN * 4  # per consumer warpgroup, its columns' s_w and bias as fp32
MAX_STAGES = 12  # the kernel's ring holds at most this many stages
MIN_STAGES = 3  # and a plan at least this many
BARRIERS = (2 * MAX_STAGES + 3 * (NCW + 1) * 4) * 8  # the ring's full / empty pairs, the quantize phase's row slots


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fixed_bytes(streamed: bool, k: int) -> int:
    return 1024 + (0 if streamed else BM * _cdiv(k, PANEL) * PANEL) + STAGING + BM * 4 + COLUMNS + BARRIERS


def _stage_bytes(streamed: bool) -> int:
    return (BM * PANEL if streamed else 0) + BN * PANEL


def ring_stages(streamed: bool, k: int) -> int:
    """Stages of the kernel's ring (``Cfg::stages``): as many as the block's
    shared memory holds beside the rest, at most ``MAX_STAGES``; 0 below
    ``MIN_STAGES`` (the path does not take this K)."""
    n = min((MAX_SMEM - _fixed_bytes(streamed, k)) // _stage_bytes(streamed), MAX_STAGES)
    return n if n >= MIN_STAGES else 0


def smem_bytes(streamed: bool, k: int) -> int:
    """Dynamic shared memory of the product kernel (``Cfg::smem`` in the
    source): 1024 bytes of alignment slack, the fused path's int8 rows for the
    whole K, the epilogue staging, the row scales, the tile columns' scales
    and bias, the barriers and the ring's stages (A and B panels streamed, or
    B only)."""
    return _fixed_bytes(streamed, k) + ring_stages(streamed, k) * _stage_bytes(streamed)


def fits(streamed: bool, k: int) -> bool:
    """Whether the path takes this K: a ring of at least ``MIN_STAGES``
    stages beside the rest (the fused path: K up to 1152)."""
    return ring_stages(streamed, k) > 0


@dataclass(frozen=True)
class Plan:
    """One launch: 128-row blocks, the ``n_tiles`` tiles of 128 columns in
    runs of ``per`` over ``split`` blocks per row block; ``streamed``: the
    pre-pass and A by TMA."""
    streamed: bool
    split: int
    row_blocks: int
    n_tiles: int
    per: int
    smem: int
    bm: int = BM
    bn: int = BN

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.split

    def n_range(self, y: int) -> range:
        """The N tiles block column ``y`` owns."""
        return range(y * self.per, min(self.n_tiles, (y + 1) * self.per))

    def row_range(self, x: int, m: int) -> range:
        """The rows block row ``x`` owns."""
        return range(x * BM, min(m, (x + 1) * BM))


def make_plan(m: int, k: int, n: int, streamed: bool, split: int) -> Plan:
    """A plan with its derived counts; ``split`` shrinks to the blocks that
    own at least one tile."""
    n_tiles = _cdiv(n, BN)
    per = _cdiv(n_tiles, split)
    return Plan(streamed, _cdiv(n_tiles, per), _cdiv(m, BM), n_tiles, per, smem_bytes(streamed, k))


def plan(m: int, k: int, n: int, sms: int = H100_SMS) -> Plan:
    """The launch for ``x (m, k) @ w (k, n)``. The fused path (rows quantized
    into shared memory once per block) where it takes K and the 128-row
    blocks alone occupy at least half the SMs; else the streamed path, with N
    split over as many blocks per row block as one wave holds (its rows were
    quantized once, by the pre-pass). On an H100 (``PERF.md``) the fused path
    led at M 16384, K 1024, and the streamed path at M 2048 (where the fused
    one splits N and quantizes each row four times) and at K 2048 (where the
    fused one's rows no longer fit at 128 a block)."""
    row_blocks = _cdiv(m, BM)
    if fits(False, k) and 2 * row_blocks >= sms:
        return make_plan(m, k, n, False, 1)
    return make_plan(m, k, n, True, max(1, sms // row_blocks))


def kernel_layout(w_q: torch.Tensor) -> torch.Tensor:
    """``w_q (..., K, N)`` int8 -> the kernel's K-contiguous copy ``(..., N, K)``."""
    return w_q.transpose(-1, -2).contiguous()


def _row_scale(ax, amax_floor: float, scale_floor: float):
    """``sx = max(max(ax, amax_floor) / 127, scale_floor)``: a division by a
    tensor (a division by a Python scalar becomes a multiply by its reciprocal
    on CUDA)."""
    return torch.clamp_min(torch.clamp_min(ax, amax_floor) / torch.full_like(ax, 127.0), scale_floor)


def row_amax_plain(x):
    """``(M, K) -> (M,)`` fp32: the abs-max of each row."""
    return x.float().abs().amax(-1)


def quant_matmul_plain(x, w_q, s_w, *, b=None, amax=None, raw: bool = False, amax_floor: float = 1e-6,
                       scale_floor: float = 0.0):
    """What the kernel computes, in PyTorch. The integer product is taken in
    float64, which is exact (sums stay under 2^53; fp32 would lose bits above
    2^24 at K = 2048). The bias is ``_linear_int8``'s add, after the rounding
    to ``x.dtype``. ``amax (M,)``: a given row abs-max in place of the rows'
    own; ``raw``: the int32 accumulators, unscaled (no bias)."""
    if raw and b is not None:
        raise ValueError("quant_matmul's raw output takes no bias: rescale_rows adds it")
    x32 = x.float()
    ax = x32.abs().amax(-1, keepdim=True) if amax is None else amax.float()[:, None]
    sx = _row_scale(ax, amax_floor, scale_floor)
    xq = torch.round(x32 / sx).to(torch.int8)
    acc = xq.double() @ w_q.double()
    if raw:
        return acc.to(torch.int32)
    y = ((acc.float() * sx) * s_w.float()).to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def rescale_rows_plain(acc, amax, s_w, *, b=None, dtype=torch.float32, amax_floor: float = 1e-6,
                       scale_floor: float = 0.0):
    """The int32 accumulators ``acc (M, N)`` of ``quant_matmul(raw=True)``
    (summed over the ranks) rescaled as its epilogue does: ``sx`` from the
    row abs-max ``amax (M,)`` with the floors, ``(acc * sx) * s_w`` in fp32,
    one rounding to ``dtype``, then the bias added in ``dtype``."""
    sx = _row_scale(amax.float()[:, None], amax_floor, scale_floor)
    y = ((acc.float() * sx) * s_w.float()).to(dtype)
    return y if b is None else y + b.to(dtype)


def _lib():
    lib = _build.load("quant_matmul")
    if not getattr(lib, "_f5_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.f5_quant_matmul.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, f, i, i, i, i, p]
        lib.f5_quant_matmul.restype = i
        lib.f5_quant_row_amax.argtypes = [p, p, i, i, i, p]
        lib.f5_quant_row_amax.restype = i
        lib.f5_quant_rescale_rows.argtypes = [p, p, p, p, p, i, i, f, f, i, p]
        lib.f5_quant_rescale_rows.restype = i
        lib.f5_quant_matmul_smem.argtypes = [i, i]
        lib.f5_quant_matmul_smem.restype = ctypes.c_longlong
        lib.f5_quant_matmul_max_k.argtypes = []
        lib.f5_quant_matmul_max_k.restype = i
        lib.f5_quant_matmul_mma_rate.argtypes = [i, i, p, p]
        lib.f5_quant_matmul_mma_rate.restype = i
        lib.f5_quant_matmul_wgmma_rate.argtypes = [i, i, p, p]
        lib.f5_quant_matmul_wgmma_rate.restype = i
        lib.f5_error_string.argtypes = [i]
        lib.f5_error_string.restype = ctypes.c_char_p
        lib._f5_typed = True
    return lib


def _check_floors(amax_floor: float, scale_floor: float) -> None:
    if not (amax_floor > 0.0 or scale_floor > 0.0) or amax_floor < 0.0 or scale_floor < 0.0:
        raise ValueError(f"one of amax_floor, scale_floor must be positive and none negative, got {amax_floor}, "
                         f"{scale_floor}")


def _check_amax(amax, m: int, device) -> None:
    if amax is not None and (amax.shape != (m,) or amax.dtype != torch.float32 or amax.device != device):
        raise ValueError(f"amax must be a ({m},) fp32 tensor on {device}, got {amax.dtype} {tuple(amax.shape)} on "
                         f"{amax.device}")


def _check(lib, x, w_q, s_w, w_qt, b, amax_floor, scale_floor) -> Plan:
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
    if b is not None and (b.shape != (n,) or not b.is_floating_point()):
        raise ValueError(f"b must be a ({n},) floating tensor, got {b.dtype} {tuple(b.shape)}")
    if m < 1 or k % 16 or n % 16:
        raise ValueError(f"quant_matmul takes M >= 1 and K, N multiples of 16, got M={m}, K={k}, N={n}")
    if k > lib.f5_quant_matmul_max_k():
        raise ValueError(f"K = {k} exceeds {lib.f5_quant_matmul_max_k()}: the int32 accumulators would no longer "
                         "be exact")
    devices = [x.device, w_q.device, s_w.device, w_qt.device] + ([] if b is None else [b.device])
    if any(d != x.device for d in devices):
        raise ValueError(f"x, w_q, s_w, w_qt and b must be on one device, got {devices}")
    _check_floors(amax_floor, scale_floor)
    return plan(m, k, n, torch.cuda.get_device_properties(x.device).multi_processor_count)


def kernel_smem_bytes(streamed: bool, k: int) -> int:
    """The product kernel's own count of its dynamic shared memory (card
    only; ``smem_bytes`` must agree where the path takes K, both 0 elsewhere)."""
    return int(_lib().f5_quant_matmul_smem(int(streamed), k))


_checked: dict = {}  # call signature -> its plan, for signatures that passed _check (a DiT forward repeats six)


def _aligned(*tensors) -> bool:
    """Every tensor (None skipped) contiguous and 16-byte aligned."""
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _on_device(dev, launch):
    if dev.index is None or dev.index == torch.cuda.current_device():
        return launch()
    with torch.cuda.device(dev):  # a tensor on another card than the current one
        return launch()


def launch_plan(x, w_qt, s_w, b, p: Plan, amax_floor: float, scale_floor: float, *, amax=None, raw: bool = False):
    """One launch of the kernel on CUDA tensors with plan ``p`` (checked
    shapes; ``quant_matmul`` picks the plan, measurements may pass another);
    ``amax``/``raw`` as ``quant_matmul`` takes them. Raises if the launch
    fails."""
    if not _aligned(x, w_qt, s_w, b, amax):
        raise ValueError("x, w_qt, s_w, b and amax must be contiguous and 16-byte aligned")
    if raw and b is not None:
        raise ValueError("quant_matmul's raw output takes no bias: rescale_rows adds it")
    m, k = x.shape
    n = w_qt.shape[0]
    dev = x.device
    out = torch.empty((m, n), dtype=torch.int32 if raw else x.dtype, device=dev)
    xq = torch.empty((m, k), dtype=torch.int8, device=dev) if p.streamed else None
    sx = torch.empty((m,), dtype=torch.float32, device=dev) if p.streamed else None
    lib = _lib()
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = _on_device(dev, lambda: lib.f5_quant_matmul(
        x.data_ptr(), w_qt.data_ptr(), s_w.data_ptr(), ptr(b), ptr(amax), out.data_ptr(), ptr(xq), ptr(sx), m, k, n,
        amax_floor, scale_floor, int(x.dtype == torch.bfloat16), int(p.streamed), p.split, int(raw),
        torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: {lib.f5_error_string(err).decode()}")
    return out


def quant_matmul(x, w_q, s_w, *, w_qt=None, b=None, amax=None, raw: bool = False, amax_floor: float = 1e-6,
                 scale_floor: float = 0.0):
    """``x (M, K)`` bf16/fp32, ``w_q (K, N)`` int8, ``s_w (N,)`` fp32, optional
    bias ``b (N,)`` -> ``(M, N)`` in ``x.dtype``. ``amax (M,)`` fp32: quantize
    each row by this abs-max instead of its own (a row-parallel linear's
    all-reduced one); ``raw``: return the int32 accumulators ``(M, N)``, not
    rescaled (no bias). CPU tensors take the plain version; CUDA tensors launch
    the kernel (which reads ``w_qt``) or raise. Serving-only: a CUDA input
    that requires grad (with grad enabled) raises."""
    dev = x.device
    if dev.type == "cpu":
        return quant_matmul_plain(x, w_q, s_w, b=b, amax=amax, raw=raw, amax_floor=amax_floor,
                                  scale_floor=scale_floor)
    if dev.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda (kernel) or cpu (plain), got {dev}")
    if torch.is_grad_enabled() and (x.requires_grad or s_w.requires_grad or (b is not None and b.requires_grad)):
        raise RuntimeError("quant_matmul is a serving kernel and has no backward (run under torch.no_grad())")
    signature = (x.shape, x.dtype, dev, w_q.shape, w_q.dtype, w_q.device, s_w.shape, s_w.dtype, s_w.device,
                 None if w_qt is None else (w_qt.shape, w_qt.dtype, w_qt.device),
                 None if b is None else (b.shape, b.dtype, b.device), amax_floor, scale_floor)
    p = _checked.get(signature)
    if p is None:
        p = _checked[signature] = _check(_lib(), x, w_q, s_w, w_qt, b, amax_floor, scale_floor)
    _check_amax(amax, x.shape[0], dev)
    out = launch_plan(x, w_qt, s_w, None if b is None else b.to(x.dtype), p, amax_floor, scale_floor, amax=amax,
                      raw=raw)
    _build.count_launch(quant_matmul)
    return out


def row_amax(x):
    """``x (M, K)`` bf16/fp32 -> ``(M,)`` fp32, the abs-max of each row. CPU
    tensors take the plain version; CUDA tensors launch ``row_amax_kernel``
    (contiguous x, K a multiple of 16) or raise."""
    dev = x.device
    if dev.type == "cpu":
        return row_amax_plain(x)
    if dev.type != "cuda" or x.ndim != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"row_amax takes a (M, K) bf16/fp32 tensor on cuda or cpu, got {x.dtype} "
                         f"{tuple(x.shape)} on {dev}")
    m, k = x.shape
    if m < 1 or k % 16 or not _aligned(x):
        raise ValueError(f"row_amax takes M >= 1, K a multiple of 16 and a contiguous, 16-byte aligned x; got "
                         f"({m}, {k})")
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    lib = _lib()
    err = _on_device(dev, lambda: lib.f5_quant_row_amax(x.data_ptr(), out.data_ptr(), m, k,
                                                        int(x.dtype == torch.bfloat16),
                                                        torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"row_amax kernel launch failed: {lib.f5_error_string(err).decode()}")
    _build.count_launch(row_amax)
    return out


def rescale_rows(acc, amax, s_w, *, b=None, dtype=torch.float32, amax_floor: float = 1e-6,
                 scale_floor: float = 0.0):
    """``acc (M, N)`` int32 (``quant_matmul(raw=True)``'s, summed over the
    ranks), ``amax (M,)`` fp32, ``s_w (N,)`` fp32, optional bias ``b (N,)`` ->
    ``(M, N)`` in ``dtype`` (bf16/fp32): what ``quant_matmul`` returns for
    the whole K. CPU tensors take the plain version; CUDA tensors launch
    ``rescale_rows_kernel`` or raise."""
    dev = acc.device
    if dev.type == "cpu":
        return rescale_rows_plain(acc, amax, s_w, b=b, dtype=dtype, amax_floor=amax_floor, scale_floor=scale_floor)
    if dev.type != "cuda":
        raise ValueError(f"rescale_rows runs on cuda (kernel) or cpu (plain), got {dev}")
    if acc.ndim != 2 or acc.dtype != torch.int32 or dtype not in _DTYPES:
        raise TypeError(f"rescale_rows takes (M, N) int32 accumulators into bf16 or fp32, got {acc.dtype} "
                        f"{tuple(acc.shape)} into {dtype}")
    m, n = acc.shape
    if m < 1 or n % 16:
        raise ValueError(f"rescale_rows takes M >= 1 and N a multiple of 16, got ({m}, {n})")
    if s_w.dtype != torch.float32 or s_w.shape != (n,) or s_w.device != dev:
        raise ValueError(f"s_w must be a ({n},) fp32 tensor on {dev}")
    if b is not None and (b.shape != (n,) or b.device != dev):
        raise ValueError(f"b must be a ({n},) tensor on {dev}")
    _check_amax(amax, m, dev)
    _check_floors(amax_floor, scale_floor)
    b = None if b is None else b.to(dtype)
    if not _aligned(acc, amax, s_w, b):
        raise ValueError("acc, amax, s_w and b must be contiguous and 16-byte aligned")
    out = torch.empty((m, n), dtype=dtype, device=dev)
    lib = _lib()
    err = _on_device(dev, lambda: lib.f5_quant_rescale_rows(
        acc.data_ptr(), amax.data_ptr(), s_w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), m, n,
        amax_floor, scale_floor, int(dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"rescale_rows kernel launch failed: {lib.f5_error_string(err).decode()}")
    _build.count_launch(rescale_rows)
    return out


quant_matmul.launches = 0
row_amax.launches = 0
rescale_rows.launches = 0


def _rate_probe(fn_name: str, blocks: int, iters: int, device) -> None:
    lib = _lib()
    sink = torch.zeros((1,), dtype=torch.int32, device=device)
    err = getattr(lib, fn_name)(blocks, iters, sink.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: {lib.f5_error_string(err).decode()}")


def mma_rate_probe(blocks: int, iters: int, device) -> None:
    """Measurement aid: launch the kernel source's ``mma.sync`` int8 rate
    loop (``blocks`` blocks of 8 warps, ``8 * iters`` m16n8k32 products per
    warp, no memory traffic). The caller times it; nothing is returned."""
    _rate_probe("f5_quant_matmul_mma_rate", blocks, iters, device)


def wgmma_rate_probe(blocks: int, iters: int, device) -> None:
    """Measurement aid: launch the kernel source's ``wgmma`` int8 rate loop
    (``blocks`` blocks of 3 warpgroups, ``8 * iters`` m64n128k32 products per
    warpgroup from one shared-memory tile pair). The caller times it."""
    _rate_probe("f5_quant_matmul_wgmma_rate", blocks, iters, device)
