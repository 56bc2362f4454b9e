"""Model FLOPs of the window's solves (``_work.solve_flops``) over the window's
seconds at the H100's dense bf16 peak, in %."""

from benchmark.core import PEAK_BF16_FLOPS
from benchmark.metrics._work import solve_flops


def read(ctx):
    solves = ctx.counters.get("solves")
    if not solves or not ctx.window_s:
        return None
    return 100.0 * solve_flops(ctx, solves) / ctx.window_s / PEAK_BF16_FLOPS
