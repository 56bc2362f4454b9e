"""Layout ablation of the d = 64 attention core (the port's counterpart of
``scripts/ablate_attention.py``).

    python -m f5tts_tpu_torch.scripts.ablate_attention             # one CUDA card
    AB_BH=4 AB_N=128 AB_CHAIN=2 AB_ITERS=1 python -m f5tts_tpu_torch.scripts.ablate_attention --device cpu

Times the five exact layouts of ``ops/kernels/ablate_attention.py`` on the
same random ``q, k, v (BH, N, 64)`` bf16 and zero bias, beside two reference
rows on the same inputs: the port's shipping kernel
(``ops/kernels/flash_attention.flash_attention``, whose layout is
``unpacked``) and one ``F.scaled_dot_product_attention`` call with the bias as
``attn_mask``. The pair layouts issue up to twice the tensor-core products of
``unpacked`` and leave the softmax as it is, so their times against
``unpacked`` split the kernel's time between its products and the rest.
Every output must lie within 0.05 of ``unpacked``'s, as in the JAX script.

Timing on the card: a CUDA graph of ``chain`` chained calls, each output fed
back as the next call's q (the JAX script's ``fori_loop``); per call = median
replay time over ``iters`` replays after a warm one (CUDA events) / ``chain``.
On the CPU (``device="cpu"``) the plain versions run and are timed on the host
clock, which measures nothing of the card.

``main`` reads the JAX script's environment names with its defaults (``AB_BH``
256: fused CFG at batch 8 is 16 rows x 16 heads; ``AB_N`` 1024; ``AB_CHAIN``
50; ``AB_ITERS`` 3) except ``AB_BQ``, whose default is 64, not 512: a block
holds 1 or 2 consumer warpgroups of 64 query rows (``AB_BQ`` 64 or 128) beside
its producer warpgroup, because a pair layout's consumer thread holds about
200 live values (scores, output accumulators, P fragments) of the 232-240
registers it can have.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from f5tts_tpu_torch.ops.kernels.ablate_attention import (HEAD_DIM, LAYOUTS, ablate_attention, blocks_per_sm,
                                                         mma_per_call, smem_bytes)
from f5tts_tpu_torch.ops.kernels.flash_attention import flash_attention
from f5tts_tpu_torch.utils.device import resolve_device

TOL_VS_UNPACKED = 0.05  # scripts/ablate_attention.py:211
LOW_OCCUPANCY = "unpacked_low_occupancy"
SHIPPING = "flash_attention"
SDPA = "sdpa"


def _time_card(fn, x0, chain: int, iters: int):
    """Median device ms per call of ``chain`` chained calls in a CUDA graph,
    and the chain's last output."""
    fn(x0)  # builds and loads the kernel outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x = x0
        for _ in range(chain):
            x = fn(x)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / chain, x


def _time_host(fn, x0, chain: int, iters: int):
    """Median host-clock ms per call of ``chain`` chained calls (CPU only)."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        x = x0
        for _ in range(chain):
            x = fn(x)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times) / chain, x


def _heads_last(t):
    """``t (BH, n, d)`` as a view of a ``(n, BH, d)`` buffer (a copy unless it is one already)."""
    return t if t.stride(0) == t.shape[2] else t.transpose(0, 1).contiguous().transpose(0, 1)


def run(bh: int, n: int, bq: int, chain: int, iters: int, device=None, seed: int = 0) -> list[dict]:
    """One row per layout (in ``LAYOUTS`` order), then ``unpacked`` launched
    with ``packed_blockdiag``'s shared memory (so that as few warps share an
    SM as in that layout), the shipping kernel and SDPA: ``name``, ``ms`` per
    call, ``max_abs_diff`` against ``unpacked``'s output, ``mma``, the
    tensor-core products (m16n8k16 equivalents) a kernel row issues per call
    (on the card, counted by the kernel's warpgroups and checked against
    ``mma_per_call``), and ``warps_per_sm`` of a kernel row on the card: the
    query-row warps (``bq / 16`` a block; the producer warpgroup is not
    counted) times CUDA's occupancy calculator's blocks per SM; None where
    they do not apply."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal((bh, n, HEAD_DIM)), dtype=torch.float32).to(dev, torch.bfloat16)
               for _ in range(3))
    bias = torch.zeros((1, 1, n), dtype=torch.float32, device=dev)
    k4, v4, mask = k[None], v[None], bias.to(q.dtype)[None]
    # kernel rows: name -> (layout, bytes of shared memory to reserve at least)
    kernels = {name: (name, 0) for name in LAYOUTS}
    kernels[LOW_OCCUPANCY] = ("unpacked", smem_bytes("packed_blockdiag", bq) if dev.type == "cuda" else 0)
    calls = {name: (lambda x, lay=lay, smem=smem: ablate_attention(lay, bias, x, k, v, bq, min_smem=smem))
             for name, (lay, smem) in kernels.items()}
    # the shipping kernel reads heads-last (BH, n, d) views (its serving layout, the head split of a projection)
    # and returns one: only the chain's first call converts q
    ks4, vs4 = _heads_last(k)[None], _heads_last(v)[None]
    calls[SHIPPING] = lambda x: flash_attention(_heads_last(x)[None], ks4, vs4)[0]
    calls[SDPA] = lambda x: F.scaled_dot_product_attention(x[None], k4, v4, attn_mask=mask)[0]
    timer = _time_card if dev.type == "cuda" else _time_host
    rows, ref = [], None
    with torch.no_grad():
        for name, call in calls.items():
            out = call(q).float()
            ref = out if ref is None else ref
            err = float((out - ref).abs().max())
            if not err < TOL_VS_UNPACKED:
                raise AssertionError(f"{name} diverges from unpacked: {err}")
            ms, last = timer(call, q, chain, iters)
            if not bool(torch.isfinite(last).all()):
                raise AssertionError(f"{name}: the chained output is not finite")
            mma = warps = None
            if name in kernels:
                layout, smem = kernels[name]
                mma = mma_per_call(layout, bh, n)
                if dev.type == "cuda":
                    counted = torch.zeros(1, dtype=torch.int64, device=dev)
                    ablate_attention(layout, bias, q, k, v, bq, mma_count=counted, min_smem=smem)
                    if int(counted) != mma:
                        raise AssertionError(f"{name}: the kernel issued {int(counted)} tensor-core products "
                                             f"(m16n8k16 equivalents), want {mma}")
                    warps = blocks_per_sm(layout, bq, smem) * bq // 16
            rows.append({"name": name, "ms": ms, "max_abs_diff": err, "mma": mma, "warps_per_sm": warps})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("f5tts_tpu_torch.scripts.ablate_attention", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu (plain versions, host clock)")
    args = ap.parse_args(argv)
    env = os.environ
    bh, n, bq = int(env.get("AB_BH", 256)), int(env.get("AB_N", 1024)), int(env.get("AB_BQ", 64))
    chain, iters = int(env.get("AB_CHAIN", 50)), int(env.get("AB_ITERS", 3))
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        clock = f"device time on {card}, CUDA graph of {chain} chained calls, median of {iters} replays"
    else:
        clock = f"host clock on the CPU (plain versions), {chain} chained calls, median of {iters} runs"
    print(f"BH {bh}, N {n}, D {HEAD_DIM}, bf16, BQ {bq}; {clock}", flush=True)
    rows = run(bh, n, bq, chain, iters, dev)
    for r in rows:
        mma = "" if r["mma"] is None else f", {r['mma']} tensor-core products (m16n8k16 equivalents) per call"
        mma += "" if r["warps_per_sm"] is None else f", {r['warps_per_sm']} warps per SM"
        print(f"{r['name']:>22}: {r['ms']:7.4f} ms/call  (max|Δ| vs unpacked {r['max_abs_diff']:.4f}){mma}")
    base = next(r["ms"] for r in rows if r["name"] == SHIPPING)
    for r in rows:
        print(f"{r['name']:>22}: {base / r['ms']:5.3f}x vs shipping flash_attention (layout unpacked)")


if __name__ == "__main__":
    main()
