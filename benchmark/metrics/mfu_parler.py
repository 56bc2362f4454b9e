"""Model FLOPs of the window's Parler work over its seconds at the H100's
dense bf16 peak, in %: the decode's row-positions, each row's prefill, the
description tokens through the T5 and the frames through the DAC
(``backbones/parler.py``), counted from the program's counters' difference
across the window. The self-attention's keys are counted at a flush's mean
(``prompt_pad + 1 + (steps + 1) / 2``), exact where every flush runs the same
steps, as the cell's do."""

from benchmark.core import PEAK_BF16_FLOPS


def read(ctx):
    c = ctx.counters.get("timer", {}).get("counters", {})
    flushes = c.get("parler.flushes", 0)
    if not flushes or not ctx.window_s:
        return None
    fam, m = ctx.family(), ctx.cell.config["model"]
    opts = fam.stated_engine(ctx.cell)
    p, cross = opts["prompt_pad"], opts["desc_pad"]
    steps = c["parler.positions"] / flushes
    flops = (c["parler.row_positions"] * fam.row_position_flops(m, p + 1 + (steps + 1) / 2, cross)
             + c["parler.rows"] * fam.prefill_flops(m, p + 1, cross)
             + c.get("parler.encode_rows", 0) * cross * fam.encoded_token_flops(m, cross)
             + c["parler.frames"] * fam.dac_frame_flops(m))
    return 100.0 * flops / ctx.window_s / PEAK_BF16_FLOPS
