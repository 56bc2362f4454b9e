"""Kernel 4 (``decode_attn``) against its roofline over the traced flush, in
%: the least time of the work (``backbones/parler.py:decode_attn_bytes``
summed over the flush's positions, at the HBM peak, which bounds it: a few
FLOPs a byte) over the device time of the traced ``decode_attn`` launches.
The flush's rows and steps come from the program's counters' difference
across it; position ``j`` reads ``prompt_pad + 1 + j`` cached keys and the
``desc_pad`` encoder states."""

from benchmark.core import PEAK_BF16_FLOPS, PEAK_BYTES


def read(ctx):
    c = ctx.traced_counters.get("timer", {}).get("counters", {})
    flushes = c.get("parler.flushes", 0)
    if ctx.traced is None or not flushes:
        return None
    spent, launches = ctx.traced.device_s(("decode_attn",))
    if not launches:
        return None
    fam, m = ctx.family(), ctx.cell.config["model"]
    opts = fam.stated_engine(ctx.cell)
    p, cross = opts["prompt_pad"], opts["desc_pad"]
    rows, steps = c["parler.rows"] / flushes, c["parler.positions"] / flushes
    keys = steps * (p + 1) + steps * (steps + 1) / 2  # summed over the positions
    nbytes = flushes * fam.decode_attn_bytes(m, rows, keys / steps, cross) * steps
    flops = flushes * rows * steps * m["decoder"]["layers"] * 4 * (keys / steps + cross) * m["decoder"]["hidden"]
    return 100.0 * max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS) / spent
