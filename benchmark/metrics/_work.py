"""The yardstick's arithmetic over the solves a run counted: model FLOPs and
the serving attention's least time."""

from benchmark.core import PEAK_BF16_FLOPS, PEAK_BYTES

EVALS_PER_STEP = {"euler": 1, "midpoint": 2, "heun": 2, "ralston": 2, "rk4": 4}


def solve_flops(ctx, solves) -> float:
    """FLOPs of ``(batch bucket, duration bucket, steps)`` solves: the fused
    CFG forward runs ``2 * batch`` rows, ``evals * steps`` times; Vocos
    decodes ``batch`` rows of the bucket's frames."""
    fam, voc = ctx.family(), ctx.vocoder()
    m, v = ctx.cell.config["model"], ctx.cell.config["vocoder"]
    evals = EVALS_PER_STEP[ctx.cell.config["serving"]["sampler"]["method"]]
    return sum(2 * bb * evals * steps * fam.row_forward_flops(m, nb) + bb * nb * voc.frame_flops(v)
               for bb, nb, steps in solves)


def attention_least_s(ctx, solves) -> float:
    """Least device time of the serving attention over the solves: per call
    the larger of ``4 * rows * heads * n**2 * d`` FLOPs at the bf16 peak and
    q, k, v, o read or written once in bf16 at the HBM peak."""
    fam, m = ctx.family(), ctx.cell.config["model"]
    evals = EVALS_PER_STEP[ctx.cell.config["serving"]["sampler"]["method"]]
    total = 0.0
    for bb, nb, steps in solves:
        layers, heads, n, d = fam.attention(m, nb)
        rows = 2 * bb
        flops = 4 * rows * heads * n * n * d
        nbytes = 4 * rows * heads * n * d * 2
        total += evals * steps * layers * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
    return total
