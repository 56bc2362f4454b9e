"""What the probe and profiling tools (``f5tts_tpu_torch/scripts/``) share:
the card's peak rates, the line that names the card beside every time, and
timers that end every measurement in a host synchronisation and report the
median.

The peaks are an H100 SXM's from NVIDIA's data sheet (dense, no sparsity).
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core operations per second
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core operations per second
PEAK_BYTES = 3.35e12  # HBM3 bytes per second


def card_line(device: torch.device | str) -> str:
    """``nvidia-smi``'s name and power limit of the card (``name, limit``),
    or ``cpu`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)} (power limit not read)"


def sync(device: torch.device | str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def median_seconds(fn, device, iters: int = 3, warmup: int = 1) -> tuple[float, list[float]]:
    """``(median, all)`` host-clock seconds of ``fn()`` over ``iters`` calls
    after ``warmup`` calls; each call is timed from a synchronised device to
    the synchronisation after it."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def graph_seconds(fn, replays: int = 3) -> tuple[float, object]:
    """``(median seconds per replay, output)`` of ``fn`` captured once in a
    CUDA graph: warmed up on a side stream (as capture wants), captured, then
    replayed ``replays`` times, each replay timed by CUDA events and ended in
    a host synchronisation. Whatever ``fn`` allocates outside the capture
    (its buffers) must exist before; the output stays in the graph's pool
    and is overwritten by every replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    torch.cuda.synchronize()
    return statistics.median(times), (graph, out)


FAMILIES = (("flash_attention", ("flash_wgmma", "flash_fwd")), ("rope_rows", ("rope_rows",)),
            ("conv_pos", ("conv_pair", "conv_generic")), ("decode_attention", ("decode_attn",)),
            ("row_norm", ("row_norm",)),
            ("gemm", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitK")), ("reduction", ("reduce_kernel",)),
            ("elementwise", ("elementwise", "vectorized", "unrolled")))


def device_ms_by_family(run, families=FAMILIES) -> tuple[dict, dict, float]:
    """One call of ``run`` under ``torch.profiler`` (device activity only):
    ``(device ms by kernel family, launches by family, wall ms)``; a kernel
    whose name matches no family counts as ``other``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sums: dict[str, float] = {}
    counts: dict[str, int] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        fam = next((f for f, keys in families if any(k in e.key for k in keys)), "other")
        sums[fam] = sums.get(fam, 0.0) + e.self_device_time_total / 1e3
        counts[fam] = counts.get(fam, 0) + e.count
    return sums, counts, wall_ms
