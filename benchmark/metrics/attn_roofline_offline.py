"""The serving attention's least time for the traced solves over the device
time of the kernels that did it, in %. The names below cover the port's
kernels (the RoPE pre-pass and the ``wgmma`` / ``mma.sync`` bodies) and
library attention (FlashAttention, memory-efficient, cuDNN SDPA)."""

from benchmark.metrics._work import attention_least_s

PATTERNS = ("flash_wgmma", "flash_fwd", "rope_rows", "fmha", "flash_attn", "attention", "sdpa")


def read(ctx):
    solves = ctx.traced_counters.get("solves")
    if ctx.traced is None or not solves:
        return None
    spent, launches = ctx.traced.device_s(PATTERNS)
    if not launches:
        return None
    return 100.0 * attention_least_s(ctx, solves) / spent
