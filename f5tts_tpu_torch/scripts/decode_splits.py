"""Device time of the decode-attention kernel at every cluster split, at the
shapes of a Parler decode position (16 heads of 64, bf16: self-attention over
503 positions at batch 16, 1 and 32, cross-attention over 64 encoder positions
at batch 16), beside one ``F.scaled_dot_product_attention`` call and the
split the wrapper picks (``ops/kernels/decode_attention.decode_split``).

    python -m f5tts_tpu_torch.scripts.decode_splits      # one CUDA card

Each time is the device time per call of a CUDA graph of 24 calls, each on
the next of several cache sets that together exceed the 50 MB L2 (a decode
step finds each layer's cache cold), median of 10 replays. The kernel is
launched through its C entry with the split given, which the wrapper never
takes from a caller. Needs a card: the kernel has no CPU mode.
"""

from __future__ import annotations

import statistics
import subprocess

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.ops.kernels import decode_attention as dk

SHAPES = (("self", 16, 503), ("self_b1", 1, 503), ("self_b32", 32, 503), ("cross", 16, 64))  # name, b, positions
HEADS, HEAD_DIM, CALLS = 16, 64, 24


def _graph_ms(calls, replays: int = 10) -> float:
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = [c() for c in calls]  # outputs stay alive in the graph's pool
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del keep, graph
    return statistics.median(times) / len(calls)


def _cache_sets(dev, b: int, total: int, seed: int = 0):
    set_bytes = 2 * b * HEADS * total * HEAD_DIM * 2
    g = torch.Generator().manual_seed(seed)
    sets = []
    for _ in range(min(64, max(2, -(-int(120e6) // set_bytes)))):
        q = (torch.randn((b, HEADS, 1, HEAD_DIM), generator=g) * HEAD_DIM**-0.5).to(dev, torch.bfloat16)
        k, v = (torch.randn((b, HEADS, total, HEAD_DIM), generator=g).to(dev, torch.bfloat16) for _ in range(2))
        bias = torch.where(torch.rand((b, total), generator=g) < 0.9, 0.0, -1e9).to(dev)
        sets.append((q, k, v, bias))
    return sets, set_bytes


def sweep(dev) -> dict:
    """``{shape: {"splits": {split: ms}, "chosen": split, "sdpa_ms": ms, "bound_ms": ms, "max_abs_err": e}}``;
    every split's output is held against the fp32 plain version (2e-2)."""
    lib = dk._lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for name, b, total in SHAPES:
        sets, set_bytes = _cache_sets(dev, b, total)
        ref = dk.decode_attention_plain(*(t.float() for t in sets[0]))
        outs = [torch.empty_like(s[0]) for s in sets]

        def launch(i, split):
            q, k, v, bias = sets[i % len(sets)]
            out = outs[i % len(sets)]
            err = lib.f5_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
                                          HEADS, HEADS, total, HEAD_DIM, 1, split,
                                          torch.cuda.current_stream(dev).cuda_stream)  # the capture's stream in a graph
            if err != 0:
                raise RuntimeError(f"decode kernel, split {split}: {lib.f5_error_string(err).decode()}")
            return out

        splits, worst = {}, 0.0
        for split in range(1, dk.MAX_CLUSTER + 1):
            span = -(-total // split)
            if split & (split - 1) or (split - 1) * span >= total:  # powers of two that leave no block empty
                continue
            launch(0, split)
            torch.cuda.synchronize()
            worst = max(worst, float((outs[0].float() - ref).abs().max()))
            splits[split] = _graph_ms([lambda i=i, s=split: launch(i, s) for i in range(CALLS)])
        if not worst < 2e-2:
            raise AssertionError(f"decode kernel at {name}: max abs err {worst} against the fp32 plain version")
        sdpa = _graph_ms([lambda i=i: F.scaled_dot_product_attention(
            *sets[i % len(sets)][:3], attn_mask=sets[i % len(sets)][3][:, None, None, :].to(torch.bfloat16), scale=1.0)
            for i in range(CALLS)])
        rows[name] = {"b": b, "total": total, "splits": splits, "chosen": dk.decode_split(b, HEADS, 1, total, sms)[0],
                      "sdpa_ms": sdpa, "bound_ms": set_bytes / 3.35e12 * 1e3, "max_abs_err": worst}
        del sets, outs
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_splits: needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"decode attention by cluster split on {card}; device time per call in a CUDA graph of {CALLS} calls over "
          f"cold cache sets, median of 10 replays", flush=True)
    for name, r in sweep(dev).items():
        splits = ", ".join(f"{s}: {ms:.5f}" for s, ms in r["splits"].items())
        print(f"{name:>9} (b {r['b']}, {r['total']} positions): split -> ms {{{splits}}}; the wrapper's split "
              f"{r['chosen']}; SDPA {r['sdpa_ms']:.5f} ms; bound {r['bound_ms']:.5f} ms; max abs err "
              f"{r['max_abs_err']:.2e}", flush=True)


if __name__ == "__main__":
    main()
