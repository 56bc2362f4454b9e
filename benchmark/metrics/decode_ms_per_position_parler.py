"""Host ms the Parler engine's position loop takes a position: the program's
span ``parler.decode`` over its counter ``parler.positions``, both read as
their difference across the window."""


def read(ctx):
    timer = ctx.counters.get("timer", {})
    positions = timer.get("counters", {}).get("parler.positions", 0)
    span = timer.get("times", {}).get("parler.decode")
    if not positions or not span:
        return None
    return 1e3 * span["total_s"] / positions
