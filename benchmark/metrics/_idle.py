"""The share of a traced part with no kernel, copy or fill on the device."""


def idle_percent(ctx):
    if ctx.traced is None or ctx.traced.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.traced.busy_s / ctx.traced.window_s)
